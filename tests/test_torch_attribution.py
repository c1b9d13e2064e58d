"""The port's roofline waterfall (`shallowspeed_tpu_torch/telemetry/
attribution.py`): `step_waterfall`, `roofline_seconds` and
`window_step_spans` equal the reference's on the same inputs;
`roofline_of_step` on a 2-layer dense step counts exactly the executed
FLOPs written out here (every dense product forward and twice backward,
the head, and the attention kernels' own counts — K1 4 D, K2 6 D and K3
8 D a visible pair, K2 and K3 recomputing P), with the hand-written
kernels' self-reports checked through a stub counter; fp8 operands are
priced at `FP8_FLOPS_RATIO`; the CPU's self-scaling freezes after two
windows; the card's rates come from `flops.py`'s table."""

import contextlib

import numpy as np
import pytest
import torch

from shallowspeed_tpu_torch import flops as F
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import _work
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops import matmul as MM
from shallowspeed_tpu_torch.optim import Adam
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.telemetry import attribution as PA
from shallowspeed_tpu_torch.telemetry import trace as PT
from shallowspeed_tpu_torch.telemetry.report import RunTelemetry
from torch_parity import MODEL, ref_telemetry  # noqa: F401


def _inputs(seed):
    rng = np.random.default_rng(seed)
    roof = {k: int(rng.integers(1, 10**12)) for k in
            ("flops_shard", "flops_global", "dot_bytes_shard",
             "dot_bytes_global", "bytes_shard", "bytes_global")}
    roof["flops_fp8_shard"] = int(roof["flops_shard"] * rng.uniform(0, 1))
    roof["flops_fp8_global"] = int(rng.integers(0, 10**12))
    rates = {"flops": float(rng.uniform(1e11, 1e15)),
             "hbm": float(rng.uniform(1e10, 4e12)),
             "ici": float(rng.uniform(1e9, 5e11)),
             "source": ["table", "calibrated"][seed % 2]}
    kw = dict(t_step=float(rng.uniform(1e-3, 1.0)), roofline=roof,
              coll_bytes=int(rng.integers(0, 10**9)),
              exposed_frac=[None, 0.3][seed % 2],
              bubble_fraction=[None, 0.2, 0.0][seed % 3],
              host_gap=[None, float(rng.uniform(0, 1e-2))][seed % 2],
              n_devices=int(rng.integers(1, 5)), rates=rates,
              compute_scale=[None, float(rng.uniform(0.5, 2))][seed % 2])
    return roof, rates, kw


@pytest.mark.parametrize("seed", range(6))
def test_waterfall_and_roofline_seconds_equal_the_reference(
        seed, ref_telemetry):  # noqa: F811
    from shallowspeed_tpu.telemetry import attribution as RA

    roof, rates, kw = _inputs(seed)
    for nd in (1, 3):
        assert PA.roofline_seconds(roof, rates, nd) == \
            RA.roofline_seconds(roof, rates, nd)
    assert PA.step_waterfall(**kw) == RA.step_waterfall(**kw)
    assert PA.step_waterfall(kw["t_step"], rates=rates) == \
        RA.step_waterfall(kw["t_step"], rates=rates)
    events = [{"ph": "X", "name": n, "dur": d, "ts": 0.0}
              for n, d in (("step", 1e3), ("grads", 5e2), ("batch", 2e3),
                           ("step", 0.0))] + [{"ph": "i", "name": "step"}]
    assert PA.window_step_spans(events) == RA.window_step_spans(events)
    assert PA.FP8_FLOPS_RATIO == RA.FP8_FLOPS_RATIO == 2.0


def _executed_flops(cfg, b, t) -> tuple[int, dict]:
    """The dense step's executed FLOPs: every dense product forward and
    its two backward products (dX, dW), the head, and per layer the
    attention kernels' causal counts (K1 4 D, K2 6 D, K3 8 D a pair)."""
    d, hd, ff, n = cfg.d_model, cfg.head_dim, cfg.ffn_dim, b * t
    per_token = cfg.n_layers * (
        2 * d * (cfg.n_heads * hd + 2 * cfg.kv_heads * hd)   # q, k, v
        + 2 * d * d                                           # out proj
        + 3 * 2 * d * ff)                                     # swiglu
    per_token += 2 * d * cfg.vocab                            # head
    pairs = b * cfg.n_heads * t * (t + 1) // 2
    kernels = {"flash_fwd": 4 * hd * pairs, "flash_dq": 6 * hd * pairs,
               "flash_dkv": 8 * hd * pairs}
    return 3 * n * per_token + cfg.n_layers * sum(kernels.values()), kernels


def test_roofline_of_step_counts_the_executed_flops():
    cfg = T.TransformerConfig(**MODEL)
    b, t = 4, 32
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    counted = ContextParallelEngine(cfg, Adam(1e-3), seed=3, attn="flash",
                                    device="cpu")
    plain = ContextParallelEngine(cfg, Adam(1e-3), seed=3, attn="flash",
                                  device="cpu")
    loss, roof = PA.roofline_of_step(counted.train_batch, tok, tgt,
                                     cells=1)
    assert loss == plain.train_batch(tok, tgt)     # it observes, only
    want, kernels = _executed_flops(cfg, b, t)
    assert roof["flops_shard"] == want
    assert roof["flops_global"] == roof["flops_fp8_shard"] == 0
    assert set(roof["per_device"]) == {"cpu"}
    assert not roof["approximate"]
    for name, fl in kernels.items():
        assert roof["kernels"][name]["calls"] == cfg.n_layers
        assert roof["kernels"][name]["flops"] == cfg.n_layers * fl
    # the dense products' operand and result bytes are dot bytes; the
    # elementwise rest (norms, softmax-free loss, the update) is bytes
    assert roof["dot_bytes_shard"] > 0 and roof["bytes_shard"] > 0
    assert _work.active is None
    # a second step through the same engine counts the same
    _, again = PA.roofline_of_step(counted.train_batch, tok, tgt, cells=2)
    assert again["flops_shard"] == want and again["approximate"]


class _Stub:
    """A counter hook that records each self-report."""

    def __init__(self):
        self.calls = []

    def kernel(self, name, device, flops, nbytes, fp8_flops=0):
        self.calls.append((name, str(device), flops, nbytes, fp8_flops))
        return contextlib.nullcontext()


def _sizes(*ts):
    return sum(x.numel() * x.element_size() for x in ts)


def test_kernel_wrappers_report_their_work_through_the_hook(monkeypatch):
    stub = _Stub()
    monkeypatch.setattr(_work, "active", stub)
    g = torch.Generator().manual_seed(0)
    b, tq, h, kvh, d = 2, 24, 4, 2, 64
    q = torch.randn(b, tq, h, d, generator=g)
    k = torch.randn(b, 40, kvh, d, generator=g)
    v = torch.randn(b, 40, kvh, d, generator=g)
    o, lse = FA.flash_fwd(q, k, v, window=7, rel=16)
    do = torch.randn_like(o)
    delta = FA.attention_delta(do, o)
    FA.flash_dq(q, k, v, do, lse, delta, window=7, rel=16)
    FA.flash_dkv(q, k, v, do, lse, delta, window=7, rel=16)
    ok = FA._visible(tq, 40, True, 7, 16, "cpu")
    pairs = b * h * int(ok.sum())
    assert pairs == FA.visible_pairs(q, k, True, 7, 16)
    (n1, dev, f1, by1, _), (n2, _, f2, by2, _), (n3, _, f3, by3, _) = \
        stub.calls
    assert (n1, n2, n3, dev) == ("flash_fwd", "flash_dq", "flash_dkv", "cpu")
    assert (f1, f2, f3) == (4 * d * pairs, 6 * d * pairs, 8 * d * pairs)
    assert by1 == _sizes(q, k, v, o, lse)
    assert by2 == _sizes(q, k, v, do, lse, delta) + q.numel() * 4
    assert by3 == _sizes(q, k, v, do, lse, delta) + 2 * k.numel() * 4
    stub.calls.clear()
    x, y = torch.randn(16, 32, generator=g), torch.randn(32, 24, generator=g)
    MM.blocked_matmul(x, y, bm=16, bk=32, bn=24)
    wq = torch.randint(-100, 100, (32, 24), dtype=torch.int8, generator=g)
    ws = torch.rand(24, generator=g)
    MM.dequant_matmul(x.to(torch.bfloat16), wq, ws)
    sx = torch.tensor(0.1)
    MM.fp8_dense(x, y, sx)
    (nb, _, fb, bb, pb), (nd, _, fd, bd, pd), (nf, _, ff, bf, pf) = \
        stub.calls
    assert (nb, nd, nf) == ("blocked_matmul", "dequant_matmul",
                            "fp8_matmul")
    assert fb == fd == ff == pf == 2 * 16 * 32 * 24 and pb == pd == 0
    assert bb == _sizes(x, y) + 16 * 24 * 4
    assert bd == x.numel() * 2 + _sizes(wq, ws) + 16 * 24 * 2
    assert bf == 16 * 32 + 32 * 24 + 24 * 4 + 16 * 24 * 4


def test_decode_kernel_reports_its_live_work(monkeypatch):
    stub = _Stub()
    monkeypatch.setattr(_work, "active", stub)
    g = torch.Generator().manual_seed(1)
    s, h, kvh, hd, bs, nblk, w = 3, 4, 2, 64, 8, 12, 4
    q = torch.randn(s, h, hd, generator=g)
    pool = {"k": torch.randn(nblk, kvh, bs, hd, generator=g),
            "v": torch.randn(nblk, kvh, bs, hd, generator=g)}
    bt = torch.arange(s * w, dtype=torch.int32).reshape(s, w) % nblk
    pos = torch.tensor([0, 9, 30], dtype=torch.int32)
    FA.paged_flash_decode(q, pool, bt, pos)
    ((name, _, fl, nbytes, _),) = stub.calls
    per_block = 2 * kvh * bs * hd * 4
    assert name == "paged_flash_decode"
    assert fl == 4 * h * hd * (1 + 10 + 31)
    assert nbytes == (1 + 2 + 4) * per_block + 2 * q.numel() * 4 \
        + _sizes(bt, pos)


def test_no_counter_means_no_report(monkeypatch):
    calls = []
    monkeypatch.setattr(FA, "_fwd_work", lambda *a, **k: calls.append(1))
    q = torch.randn(1, 8, 2, 64)
    FA.flash_fwd(q, q, q)
    assert calls == [] and _work.active is None


def test_fp8_operands_are_priced_at_the_ratio():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(64, 128, generator=g), torch.randn(128, 32,
                                                          generator=g)
    _, roof = PA.roofline_of_step(MM.fp8_dense, x, w, torch.tensor(0.05))
    fl = 2 * 64 * 128 * 32
    assert roof["flops_fp8_shard"] == roof["flops_shard"] == fl
    rates = {"flops": 1e12, "hbm": 1e15, "ici": 1e9}
    secs = PA.roofline_seconds(roof, rates)
    assert secs["mxu_s"] == pytest.approx(fl / (rates["flops"] * 2.0))
    bf16 = dict(roof, flops_fp8_shard=0)
    assert PA.roofline_seconds(bf16, rates)["mxu_s"] == pytest.approx(
        2 * secs["mxu_s"])


def test_card_rates_come_from_the_table(monkeypatch):
    assert PA.device_rates("bf16", device="cpu")["source"] == "calibrated"
    name = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    dev = torch.device("cuda", 0)
    shared = PA.device_rates("bf16", device=dev)
    assert shared == {"flops": 989e12, "hbm": 3.35e12, "ici": 3.35e12 / 2,
                      "source": "table", "wire": "hbm_copy"}
    wired = PA.device_rates("f32", device=dev, shared=False)
    assert wired == {"flops": 67e12, "hbm": 3.35e12, "ici": 450e9,
                     "source": "table", "wire": "nvlink"}
    assert F.device_wire_bandwidth(dev) == 450e9


class _Engine:
    def __init__(self):
        self.device = torch.device("cpu")

    def telemetry_traffic(self):
        return {"total_bytes": 4096, "per_axis": {"dp": {"bytes": 4096}}}


def test_self_scaling_freezes_after_two_windows():
    tr = PT.Tracer(level="spans")
    telem = RunTelemetry(_Engine(), tr, dtype="f32")
    telem._roof = {"flops_shard": 10**9, "dot_bytes_shard": 10**7,
                   "bytes_shard": 10**8, "approximate": False}
    telem.set_bubble(bubble_static=0.25)
    scales, unexplained = [], []
    for durs in ((0.30, 0.10, 0.12), (0.11, 0.10, 0.12), (0.11, 0.10),
                 (0.40, 0.41)):
        t = tr.now()
        for dur in durs:
            tr.complete("step", t, t + dur)
            t += dur
        f = telem.step_fields(window_secs=sum(durs) * 1.05,
                              steps_in_window=len(durs))
        assert f["attrib_rates_source"] == "calibrated"
        assert f["attrib_bubble_frac"] == 0.25 and f["attrib_wire"] == \
            "memory"
        scales.append(f["attrib_compute_scale"])
        unexplained.append(f["attrib_unexplained_frac"])
    assert scales[1] == scales[2] == scales[3]
    assert scales[0] != scales[1]
    # a slower program under the frozen scale shows as unexplained time
    assert unexplained[2] == pytest.approx(0.0, abs=0.05)
    assert unexplained[3] > 0.5


def test_count_step_counts_once_at_spans():
    cfg = T.TransformerConfig(**MODEL)
    eng = ContextParallelEngine(cfg, Adam(1e-3), seed=3, attn="flash",
                                device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    for level in ("steps", "spans"):
        telem = RunTelemetry(eng, PT.Tracer(level=level))
        telem.count_step(eng.train_batch, tok, tok)
        assert (telem.roofline is not None) == (level == "spans")
    roof = telem.roofline
    telem.count_step(eng.train_batch, tok, tok)
    assert telem.roofline is roof
    assert telem.run_summary()["roofline"] is roof
