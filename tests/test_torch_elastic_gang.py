"""The gang drill on the CPU: the port's MLP driver `train --engine spmd
--schedule gpipe --dp 2` as two gloo processes under `python -m
shallowspeed_tpu_torch.elastic --procs 2`, process 1 killed at the top
of epoch 1 by a fault plan (`kill@1`, kept by that process only): the
whole gang is killed and restarted on a fresh coordinator port, both
processes resume from epoch 0's checkpoint, and the model hash the
restarted gang prints equals the one-process run's. Every process runs
on one intra-op thread (`OMP_NUM_THREADS=1`), the setting under which
the CPU's products are the same bits in every process layout."""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.telemetry.goodput import run_goodput

ROOT = Path(__file__).resolve().parents[1]
ENV = {**{k: v for k, v in os.environ.items()
          if not k.startswith(("SHALLOWSPEED_CHAOS", "JAX_COORD",
                               "JAX_NUM_PROC", "JAX_PROCESS_ID"))},
       "OMP_NUM_THREADS": "1"}
HASH = re.compile(r"^model hash: ([0-9a-f]{40})$", re.M)

# the command a gang member runs: the fault plan stays with process 1
MEMBER = textwrap.dedent(f"""
    import os, sys
    sys.path.insert(0, {str(ROOT)!r})
    if os.environ["JAX_PROCESS_ID"] != "1":
        for k in [k for k in os.environ if k.startswith("SHALLOWSPEED_")]:
            del os.environ[k]
    from shallowspeed_tpu_torch import train
    sys.exit(train.main(sys.argv[1:]))
""")


def test_gang_drill_ends_on_the_one_process_hash(tmp_path):
    data = tmp_path / "mnist"
    prepare_mnist(data, synthetic=True, n_samples=1024)
    flags = ["--device", "cpu", "--engine", "spmd", "--schedule", "gpipe",
             "--dp", "2", "--epochs", "2", "--max-batches", "4",
             "--batch-size", "64", "--lr", "0.1", "--data-dir", str(data)]
    one = subprocess.run(
        [sys.executable, "-m", "shallowspeed_tpu_torch.train", *flags],
        capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)
    assert one.returncode == 0, one.stdout[-2000:] + one.stderr[-2000:]
    member = tmp_path / "member.py"
    member.write_text(MEMBER)
    log = tmp_path / "gang.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "shallowspeed_tpu_torch.elastic", "--procs",
         "2", "--max-restarts", "2", "--backoff", "0.3", "--term-grace",
         "2", "--hang-timeout", "120", "--chaos", "kill@1",
         "--chaos-state", str(tmp_path / "cs"), "--", sys.executable,
         str(member), *flags, "--save-dir", str(tmp_path / "ck"),
         "--auto-resume", "--log-file", str(log)],
        capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "killing the gang" in out and "[elastic] attempt 2" in out
    assert "resumed from" in out and "ckpt_0 at epoch 1" in out
    assert HASH.findall(r.stdout)[-1:] == HASH.findall(one.stdout)
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["kind"] for x in recs if x["event"] == "fault"] == ["kill"]
    rep = run_goodput(log)
    assert rep["mttr"]["crash"]["count"] == 1


def test_spmd_products_run_one_replica_row_at_a_time(tmp_path,
                                                     monkeypatch):
    """The SPMD engine's batched products (forward, backward, `infer`)
    each cover one replica row's stages, never two rows: a process that
    holds one row of a dp 2 grid then runs the same products as one
    process running both (on the card, cuBLAS sums a batch of two rows
    otherwise than two batches of one)."""
    import numpy as np
    import torch

    from shallowspeed_tpu_torch import train

    data = tmp_path / "mnist"
    prepare_mnist(data, synthetic=True, n_samples=1024)
    args = train.parse_args(["--device", "cpu", "--engine", "spmd",
                             "--schedule", "gpipe", "--dp", "2", "--pp",
                             "2", "--batch-size", "64",
                             "--data-dir", str(data)])
    eng, train_ds, val_ds = train.build(args, torch.device("cpu"))
    sizes = []
    for name in ("bmm", "baddbmm"):
        real = getattr(torch, name)

        def counted(*a, _real=real):
            sizes.append(a[-2].shape[0])
            return _real(*a)

        monkeypatch.setattr(torch, name, counted)
    eng.train_batch(0, train_ds)
    assert sizes and set(sizes) == {2}            # pp stages of one row
    sizes.clear()
    eng.infer(np.zeros((64, 784), np.float32))
    assert sizes and set(sizes) == {1}            # one row, one stage
