"""Save atomicity under a kill (`shallowspeed_tpu_torch/chaos.py`'s
`kill_in_save`, the reference's `tests/test_chaos.py` torture test):
a child process SIGKILLs itself at a seeded point inside its second
save — after the params npz, after the optimizer npz, before the
rename, after it — through `checkpoint.save` and through `AsyncSaver`'s
writer thread. Whatever that leaves on disk, `latest()` returns only a
manifest-verified checkpoint (the first save, or the second when the
kill came after its rename), and a later save over the wreckage lands.
The seeds are those whose draws hit each point (as the reference's
draw: `test_torch_chaos.py` holds the points equal)."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from shallowspeed_tpu_torch import checkpoint as C

ROOT = Path(__file__).resolve().parents[1]

# seed -> the point its kill_in_save@2 fires at
SEEDS = {11: "file:params.npz", 21: "file:opt.npz", 1: "pre_rename",
         12: "renamed"}

CHILD = textwrap.dedent(f"""
    import sys
    sys.path.insert(0, {str(ROOT)!r})
    import numpy as np
    from shallowspeed_tpu_torch import chaos, checkpoint

    ckpt_dir, state_dir, seed, use_async, log = sys.argv[1:6]

    class Eng:  # the surface the save path reads
        opt_state = {{"m": np.arange(64, dtype=np.float32)}}

        def get_canonical_params(self):
            return [{{"W": np.full((64, 64), 0.5, np.float32),
                      "b": np.zeros(64, np.float32)}}]

    chaos.configure(chaos.FaultPlan.parse(
        "kill_in_save@2", seed=int(seed), state_dir=state_dir,
        log_file=log))
    eng = Eng()
    if use_async == "1":
        saver = checkpoint.AsyncSaver()
        for epoch in range(4):   # save 2 dies on the writer thread
            saver.save(ckpt_dir, eng, epoch)
        saver.close()
    else:
        for epoch in range(4):   # save 2 dies on the main thread
            checkpoint.save(ckpt_dir, eng, epoch)
""")


class _Eng:
    opt_state = {"m": np.arange(64, dtype=np.float32)}

    def get_canonical_params(self):
        return [{"W": np.full((64, 64), 0.5, np.float32),
                 "b": np.zeros(64, np.float32)}]


@pytest.mark.parametrize("use_async", ["0", "1"])
def test_kill_inside_a_save_leaves_no_half_checkpoint(tmp_path, use_async):
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    runs = {}
    for seed in SEEDS:            # the children run side by side
        d = tmp_path / f"s{seed}"
        runs[seed] = (d, subprocess.Popen(
            [sys.executable, str(child), str(d / "ck"), str(d / "cs"),
             str(seed), use_async, str(d / "m.jsonl")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for seed, (d, proc) in runs.items():
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == -9, (seed, out)        # it was killed
        fault = json.loads((d / "m.jsonl").read_text())
        assert (fault["kind"], fault["point"]) == ("kill_in_save",
                                                   SEEDS[seed])
        got = C.latest(d / "ck")
        C.verify(got)                    # never an unverified survivor
        want = "ckpt_1" if SEEDS[seed] == "renamed" else "ckpt_0"
        assert got.name == want, (seed, sorted(p.name for p in
                                              (d / "ck").iterdir()))
        # a restarted process saves cleanly over the wreckage
        C.save(d / "ck", _Eng(), 9)
        assert C.latest(d / "ck").name == "ckpt_9"
