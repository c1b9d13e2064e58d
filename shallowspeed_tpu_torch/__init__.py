"""shallowspeed_tpu_torch — the PyTorch + CUDA port of `shallowspeed_tpu`.

The JAX package beside this one is the reference: every module here has
its counterpart there (same file layout where a reader benefits), and
the tests feed the same numpy inputs through both. This package imports
`torch` and numpy only — never `jax`, never `shallowspeed_tpu`; where it
needs a host-side helper of the JAX package it keeps its own copy.

What is ported so far:
- serving: `serve.py` -> `serving.engine.ServingEngine` -> prefill
  chunk / decode tick -> `models.transformer` + `models.kv_cache` +
  `serving.cache`, the tick's paged attention in a hand-written CUDA
  kernel (K4, `csrc/paged_decode.cu`, wrapped by `ops.flash_attention`);
- one-device LM training: `train_lm.py` ->
  `parallel.context.ContextParallelEngine` -> `models.transformer.loss`
  under autograd -> `ops.flash_attention.flash_attention`, whose forward
  and backward are hand-written CUDA kernels (K1, K2, K3,
  `csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`);
- quantized decode: int8 KV caches (K4's int8 branch in the serving
  tick) and int8/fp8 weight storage (`ops.matmul.dequant_matmul`, a
  hand-written GEMM that reads the weight at 1 byte an element,
  `csrc/blocked_matmul.cu`), in the serving engine and in the
  contiguous `models.generate.generate` loop (`train_lm --generate`),
  whose long-prompt prefill runs K1;
- speculative decoding and the prefix cache in the serving engine;
- the narrow-K matmul probe (`bench_matmul`) -> `ops.matmul.
  blocked_matmul`, a hand-written CUDA kernel (K5,
  `csrc/blocked_matmul.cu`). Every Pallas kernel of the JAX package
  now has its Hopper counterpart;
- text data and checkpoints: `data/` (tokenizer, token shards,
  prefetch), `build_token_shards`, `checkpoint.py` in the JAX
  package's format;
- the source paper's MNIST MLP: `train.py` -> `engine.FusedDPEngine`,
  `parallel.worker.PipelineExecutor` (naive / GPipe / PipeDream-Flush
  schedules) or `parallel.spmd_pipeline.SPMDPipelineEngine` over a
  (dp, pp) grid of devices (`parallel.mesh`) -> `models.mlp` ->
  `ops.functional` (torch ops with hand-written VJPs; the reference
  has no Pallas kernel on this path), on `data.mnist` / `data.dataset`;
- fp8 training and the health pack: `ops.matmul.fp8_dense` (e4m3
  operands, f32 sums on a hand-written e4m3 GEMM in
  `csrc/blocked_matmul.cu`, straight-through f32 gradients) under
  `TransformerConfig(fp8_dense=True)` and `fp8.Fp8TrainEngine` (`train
  --engine fp8`); `telemetry.health` / `anomaly` / `numerics` and
  `optim`'s `guarded_step` behind every engine's `health=` and the
  drivers' `--health`;
- data x sequence parallel LM training: `train_lm --dp D --sp S --attn
  ring|ring-flash|ulysses|ulysses-flash [--zero1|--zero2]` ->
  `parallel.context.ContextParallelEngine` over a (dp, sp) grid of
  devices (`parallel.mesh.make_context_mesh`), ZeRO-1/2 in
  `parallel.zero`, the sequence-parallel substrates in `ops.attention`
  and `ops.flash_attention.ring_flash_attention` (K1 with f32 chunk
  outputs, K2 and K3 on every hop of the ring);
- the GSPMD engine family: `train_lm --tp / --fsdp / --sp --tp / --ep`
  -> `parallel.gspmd.GSPMDEngine` under `parallel.tensor.
  TensorParallelEngine`, `parallel.fsdp.FSDPEngine`,
  `parallel.composite.Composite3DEngine` and `parallel.expert.
  ExpertParallelEngine`, over a named grid (`parallel.mesh.Grid`), on
  the plain attention (`ops.attention.allgather_attention` at sp > 1);
- the LM pipeline: `train_lm --pp` -> `parallel.pipeline_lm.
  PipelineLMEngine` (gpipe, 1f1b, zb, virtual stages, sp, tp and ep
  inside a stage);
- comm overlap: `train_lm / train --overlap on --bucket-mb` ->
  `parallel.overlap` (bucketed gradient reduction issued from the
  backward, on a side CUDA stream) in the context, FSDP, fused-DP and
  SPMD-pipeline engines;
- the multi-process launch: `distributed.py` on `torch.distributed`
  (the reference's three variables, one controller per process, the
  grids cut from every process's cells, moves between processes as
  send / recv pairs and rank-order sums shared by their owners); the
  context engine's dp, the LM pipeline's dp and pp, and the MLP's SPMD
  pipeline across processes, bit for bit their one-process runs; the
  collective checkpoint; `train_lm` / `train` launched once per
  process;
- the telemetry core: `telemetry/` (span tracer with CUDA fences, the
  schema, sketches, the bench gate, the request stitcher, the host
  profiler and `torch.profiler` captures, allocator memory and owners,
  counted collective bytes, `RunTelemetry`), the reference's spans in
  every engine, `train_lm` / `train --telemetry --trace-dir
  --profile-dir --profile`, `serve --profile`.
ROADMAP.md lists what comes next; each feature not ported yet raises
`NotPorted`.

Entry points run on the GPU unless the caller passes `device="cpu"`
(the CPU tests do). Nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


class NotPorted(NotImplementedError):
    """A feature of the JAX package that this port does not have yet.
    The message names the feature and the ROADMAP queue item that
    brings it."""

    def __init__(self, feature: str, later: str):
        super().__init__(
            f"{feature} is not ported to shallowspeed_tpu_torch yet "
            f"(ROADMAP.md: {later})")
        self.feature = feature
        self.later = later


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for something else. Raises when CUDA is asked for (explicitly or by
    default) and no card is present — the CPU is used only when the
    caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        if dev.index is None:   # name the card, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
