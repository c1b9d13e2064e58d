"""Smoke check of the PyTorch port (`shallowspeed_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port builds, is right, serves,
trains and runs its matmul probe on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build every CUDA kernel of the serving, training and probe paths
   from `csrc/` with nvcc (sm_90a), one nvcc per source, all started
   together; print each kernel's registers and spills, and the dynamic
   shared memory of the tensor-core builds (K1, K2, K3 in bf16, K1
   also with its f32 epilogue, the
   GEMM of K5 and `dequant_matmul`, and the e4m3 GEMM of `fp8_dense`),
   which must compile without a spill,
   and of K4's split kernel, whose 32 builds and 4 merge builds must
   compile without a spill too; print K4's split count at the serving
   shape.
2. Hold each kernel against its plain torch version on the card: K4
   (float pools, and its int8 branch with q in f32 and in bf16) at
   small shapes, at the serving path's own shapes and at the edges of
   its split (a row at pos 0 beside full tables, rows with fewer live
   columns than splits, a window starting inside a block, W = 1, G = 8,
   3 and 40, bs 8 and 32), each printed with its split count; K1, K2
   and K3 (flash forward, dq, dk/dv) at small MHA, GQA, window,
   rel != 0 and ragged-T shapes in f32 and bf16, and at the training
   shape (B 4, T 2048, 16 heads x 128, causal) in bf16, on contiguous
   q, k, v and again on strided views of one fused qkv tensor, as the
   model passes them, and at a pipeline stage's and a vpp chunk's (B 1,
   16 heads; 8 heads on a tp cell) and an sp tile's (B 1, T 1024, on
   and off the diagonal) on the fused views, and an ulysses-flash
   cell's gathered head group (B 1, 8 heads) on contiguous ones. Each
   element is held to `flash_attention.kernel_ratio`'s rule:
   KERNEL_TOL of |ref| + mean |ref|, plus one bf16 ulp where the kernel
   rounds its output to bf16, plus for the bf16 builds (wgmma) the
   `tc_rounding_terms` of their one rounding of P or dS to bf16; the
   plain version with P and dS rounded to float8_e4m3fn must fail that
   rule (o, dQ, dK); lse within 1e-5 on every row that sees a key.
   `dequant_matmul` with int8 and fp8 weights: bf16 x through the
   tensor-core GEMM with a 1-byte B at 8, 256 and 300 rows and the qkv
   and head shapes against the exact product, per element, where a bf16
   rounding before the scale must fail; f32 x through the f32-FMA
   kernel; one call at the head's shape must add under 16 MB of peak
   memory. K5 (`blocked_matmul`) and its plain version, each element
   against the f64 product of the same values within one rounding of
   the output dtype plus an f32 summation bound (`_k5_ratio`), at the
   JAX test's shapes (f32, bf16, bf16 in with f32 out), an unaligned
   bf16 shape (the FMA build) and the probe's six shapes in bf16 (the
   tensor-core build); a bf16 rounding of the accumulator between
   k-slices must fail that rule. Every call counts on the launcher its
   route picks.
2b. The narrow-K matmul probe (`bench_matmul.main`, --iters 5, M 16384):
   its 12 records, and K5's tensor-core build launched 6 shapes x 4
   chains x 5 times, its FMA build never.
3. Serve the repo's 1.21B LM (vocab 32768, d_model 2048, 16 heads, 16
   layers, RoPE + RMSNorm + SwiGLU, f32 master weights, bf16 compute)
   at full width and depth through `ServingEngine(attn_impl="flash")`,
   with seeded random weights: 12 greedy requests, prompts of 128-1024
   tokens, 32 new tokens each, 8 slots. The kernel launch counts are
   zeroed just before the run and must equal n_layers x ticks after it;
   the block allocator must be balanced at drain. The same requests are
   served again with int8 KV pools (`kv_quant="int8"`, K4's int8
   branch), and with int8 and fp8 weights (`weight_quant`, every dense
   through `dequant_matmul`'s tensor-core route) over bf16 pools, under
   the same checks. After each run, a decode tick of every slot over
   one synthetic state is timed and profiled, so the four modes compare
   tick for tick.
3b. The prefix cache: 12 greedy requests that share one 768-token
   prefix (ten with distinct tails, the last two exactly the prefix,
   the fully aligned copy-on-write path), submitted together; hits and
   skipped tokens must show, the allocator must balance with cold
   blocks (n_free + n_cold == n_usable), one hit's teacher-forced
   logits are held against the plain forward (bf16), and in f32 at 2
   layers the streams must equal the cache-off streams.
3c. Speculative decoding: 4 greedy requests over motif prompts on 8
   slots with spec_k 4; drafts must show and the streams must equal the
   spec_k 0 streams token for token (bf16, full depth).
4. Hold the engine's prefill-then-decode logits of two requests against
   the plain full forward over the same tokens (teacher-forced), in the
   bf16 compute path served above and again in f32 compute, and show
   that a bf16 rounding slipped into the f32 attention path fails the
   f32 bound. With int8 pools in f32 compute, the kernel's logits
   against the gather path's, and a bf16 slip of q and K's scale in the
   gather path must fail that bound. With int8 and with fp8 weights in
   the bf16 compute served above, and with int8 weights in f32 compute,
   the paged logits against the plain forward over the dequantized
   weights.
5. Time K4 (float and int8 pools) at the serving shapes, K5 at the
   probe's narrow-K shape (16384, 1024) @ (1024, 4096) in bf16, and
   `dequant_matmul` at each dense shape of a decode tick (8 rows, int8
   weights), beside their plain versions, one library call computing
   the same function, and their bounds; K4 and `dequant_matmul` also by
   the profiler's device time a call (theirs and the library's), and
   K4's split and merge kernels against the live length.
5b. The contiguous `generate()`: 8 prompts of 1024 tokens, 64 greedy new
   tokens, prefilled through K1 (`flash_prefill_at=1024`), with a bf16
   and with an int8 cache; K1's bf16 build launches once per layer per
   call.
6. Train the same 1.21B LM (same weights) at full width and depth
   through `ContextParallelEngine(attn="flash")` with AdamW on one
   repeated 4 x 2048 batch: one warm-up step, whose loss must match the
   plain attention's loss on the same weights (bf16 bound), then timed
   steps, with the launch counts zeroed just before them: the
   tensor-core builds of K1, K2 and K3 must each equal n_layers x steps
   after, their f32-FMA builds 0; and a finite, falling loss.
6b. Data and checkpoints at full width and CKPT_LAYERS (1) of the 16
   layers, through `train_lm.main` and `serve
   --ckpt`'s loader: a token-shard corpus (`build_shards`, vocab
   32768, 10 % held out, 16-token motifs from numpy seed 7); run A
   trains 6 steps from it (--val-every 3 --prefetch 2) in this process:
   the oracle. Then phase 20 (a) in the same directory: the same flags
   under the supervisor and a fault plan, its first child saving
   synchronously at step 2 and killed at step 4, its restart resuming
   that checkpoint with --async-save --keep-last 2 (the old runs B and
   C), every loss equal to run A's bit for bit; the plan corrupts the
   restart's last checkpoint after it lands. The launch counts are
   zeroed before each run and child: K1's tensor-core build n_layers x
   (steps + validations), K2's and K3's n_layers x steps, the f32-FMA
   builds 0. `--sample-only` must quarantine the corrupted checkpoint
   and restore the first, whose parameters then serve 4 of phase 3's
   requests (K4 n_layers x ticks), their paged logits against the plain
   forward (bf16 bound). Prints a `ckpt:` line (seconds and GB/s of the
   fetch, write, hash, verify, read and placement; the sync save is the
   first child's, the async one and the restore the restart's) and a
   `data:` line (prefetch depth, steps/s of run A and the restart). The
   checkpoints live in a temporary directory removed at the end.
7. Training parity in f32 at full width and 2 layers: the kernels'
   loss and every gradient leaf against the plain attention under torch
   autograd, and a bf16 rounding of q and K slipped into the plain
   scores must fail that bound.
8. Time K1, K2 and K3 at the training shape (their tensor-core builds)
   beside their plain versions, the library's attention forward (K1)
   and backward (K2 and K3 together), and their bounds.
9. The source paper's MLP (no kernel of its own: `ops/functional.py`'s
   torch ops) at the reference's full width ([784, 128, 127, 126, 125,
   124, 123, 10]), global batch 128, 4 microbatches, SGD lr 0.006, on
   synthetic MNIST (70,000 samples, written into a temporary
   directory): the serial fused run (dp 1) trains 8 batches, then
   fused dp 2, the VM at pp 1 naive, dp 4 gpipe, pp 4 naive / gpipe /
   pipedream, dp 2 x pp 2 gpipe and dp 2 x pp 4 pipedream, and the SPMD
   engine at pp 2 and dp 2 x pp 4 train the same 8 batches; each
   layout's params must lie within the JAX package's cross-engine bound
   of the serial run's (rtol 2e-4, atol 2e-6) and its replicas must be
   bit-identical. Then `train.train` on its default path (fused, staged
   epochs) for 2 epochs, and at --pp 4 --schedule pipedream (VM) and
   --pp 2 --schedule gpipe (SPMD) for 50 batches: accuracy finite and
   above epoch 0's. A 1-epoch run with --save-dir, resumed to epoch 2,
   must equal the straight 2-epoch run bit for bit. Prints a line per
   layout (batch ms, samples/s, device ops and busy share of one
   profiled batch) and an `mlp:` line beside the card's name and power
   limit.
10. The one-device training features at full width (bf16 compute).
   (a) The 1.21B LM's own recipe at full depth: Adafactor 3e-4, remat
   policy "dots", xent_chunk 1024, the flash kernels, phase 6's batch
   and weights: the warm-up step's loss within LOSS_TOL_BF16 of the
   plain attention's no-remat, unchunked no-grad loss; 6 timed steps
   with the launch counts zeroed before them, K1, K2 and K3 each
   n_layers a step on their tensor-core builds (the FMA builds 0),
   finite, falling losses; a profiled step; a `recipe:` line with step
   p50, tok/s, MFU and the peak memory (measured as phase 6's); then a
   `recipe ladder:` line, Adafactor alone, with "dots" alone and with
   xent_chunk 1024 alone, 3 timed steps each (step p50, tok/s, MFU,
   peak memory). (b) The feature matrix at 2 layers: each remat policy
   against no remat, K1 2 x n_layers under "full" and n_layers under
   "attn" and "dots"; xent_chunk 1024 and 1000 against unchunked; accum
   2 against accum 1 (K1-K3 2 x n_layers); dropout 0.1 under "full"
   remat against no remat at the same key; attention dropout 0.1
   through the plain attention (no K1) under "full" remat against no
   remat: loss within LOSS_TOL_BF16 and every gradient leaf within
   GRAD_TOL_BF16 of its max; each row's wall ms and peak memory. (c)
   MoE at 4 layers, 4 experts, top-2, capacity 2.0 through
   `ExpertParallelEngine` (the plain attention, no K1) with AdamW: 4
   steps, falling losses, the routing stats, and the engine's logits
   against `T.forward` on the same weights (LOGITS_TOL_BF16).
11. fp8 training and the health pack, each line with the card's name
   and power limit. (a) The e4m3 GEMM (`ops/matmul.fp8_matmul`, the
   product of `fp8_dense`) at each dense shape of the 1.21B step (M
   8192) and each layer of the MLP (M 128), on the build
   `fp8_matmul_route` picks (one launch each): the card's quantized
   bytes equal the CPU's, the kernel's and the plain version's outputs
   within the f32 order bound K 2^-24 sum|terms| of the exact (f64)
   product, the tensor-core build's error within FP8_TC_VS_FMA times
   the exact-f32 FMA build's on the same inputs (an accumulator of 14
   bits, the 8-bit wgmma's, simulated, must exceed it), a NaN input row
   a NaN output row; times of the tensor-core build at the LM shapes
   and the FMA build at the MLP's (128, 128, 127) beside the plain
   version, `torch._scaled_mm` and the bound. (b) The 1.21B LM
   with `fp8_dense=True` (AdamW 3e-4, phase 6's batch and weights,
   flash): the loss at init within PARITY_LOSS_BUDGET of phase 6's
   bf16 loss, finite gradients (the health pack), FP8_STEPS timed steps
   with the counts zeroed before them (the tensor-core e4m3 build 81 a
   step, K1-K3 16 a step), falling losses, step p50, MFU (989 TFLOP/s
   bf16), peak memory, a profiled step's device ms (the fp8 GEMM, the
   backward's f32 products, K1-K3, the rest). (c) `train --engine fp8
   --health guard --shadow-every 4 --log-every 4`, 14 batches on the
   card (both builds), against the same run on the CPU
   (FP8_DRIVER_TOL); a NaN batch into the fused MLP engine under
   health="guard" leaves its state bit for bit; phase 6's step with
   health "off", "monitor" and "guard" in turns, the pack's and the
   guard's added ms and peak memory.
12. Data x sequence parallelism, every cell of a (dp, sp) grid the
   card. (a) K1's bf16 build with the f32 epilogue (`_flash_fwd_tc_f32o`,
   ring attention's chunk output) at the ring's chunk shape (2 x 1024 x
   16 x 128) at rel 0, rel 1024, rel -1024 with window 512 (every row
   masked: o 0, lse -1e30) and with 4 kv heads, and at a pipeline
   stage's ring-flash hop (1 x 1024 x 16 x 128 on the fused qkv's
   views, phase 15c's calls) at rel 0 and rel 1024, against its plain
   version under the kernels' rule; its time at rel 1024 beside the
   plain version, SDPA's non-causal forward and the bound. (b)
   `ring_flash_attention` at sp 2 and 4 on 2 x 2048 x 16 x 128 against
   `flash_attention` over the gathered sequence: o and the gradients
   within RING_TOL_BF16, o also per element against the plain f32
   attention, K1-K3 launches sp (sp + 1) / 2 each. (c)
   `ContextParallelEngine` at full width and CP_LAYERS = 1 layer of 16
   (AdamW 3e-4, phase 6's batch and weights) in CP_LAYOUTS:
   dp 2 x sp 2 ring-flash, dp 1 x sp 4 ulysses-flash, dp 2 flash
   ZeRO-1, dp 2 x sp 2 ring-flash ZeRO-2 accum 2: the loss at init
   within PARITY_LOSS_BUDGET and every first-step gradient leaf within
   GRAD_TOL_BF16 of the one-device flash engine's, CP_STEPS timed steps
   with the counts zeroed before them (K1, K2, K3 each
   `cp_launches_per_step`), falling losses, step
   p50, tok/s, MFU, peak memory, the optimizer state the cells hold, and
   the dense dp 2 layout beside ZeRO-1 and ZeRO-2. (d) `train_lm --dp 2
   --sp 2 --attn ring-flash --zero2 --accum 2` at full width and 2
   layers, 4 steps and a save, then `--resume` at dp 1, sp 1 (flash):
   its losses within PARITY_LOSS_BUDGET of a straight run's.

13. The GSPMD engine family (no kernel: the plain attention, as the
   reference's GSPMD engines run XLA attention), the 1.21B LM's width
   at GSPMD_LAYERS = 1 layer of 16 (the plain attention's f32 score
   tensors, and the script's time): (a) the
   one-device plain-attention engine as the yardstick
   (`ExpertParallelEngine` at (1, 1) for MoE); (b)
   `TensorParallelEngine` at tp 4 and dp 2 x tp 2 ZeRO-1, `FSDPEngine`
   at dp 4, `Composite3DEngine` at dp 2 x sp 2 x tp 2 with fsdp, and
   `ExpertParallelEngine` (phase 10c's MoE) at ep 4 and dp 2 x sp 2 x
   ep 2: the loss at init within PARITY_LOSS_BUDGET of (a)'s, every
   first-step gradient leaf within GRAD_TOL_BF16 (MoE compared in f32
   compute: a bf16 ulp can flip a near-tied token's expert), K1-K3
   launched 0 times over GSPMD_STEPS timed steps (and (a)'s), falling
   losses, step p50, tok/s, MFU, peak memory and the bytes the fullest
   cell holds (`gspmd layout` / `gspmd profile` lines); (c) `train_lm
   --dp 2 --tp 2` with a save, resumed at `--fsdp --dp 4` (within
   PARITY_LOSS_BUDGET of a straight run), and `--ep 2 --experts 4`
   (`gspmd driver:`).

14. The LM pipeline (`PipelineLMEngine`), the 1.21B LM at full width,
   phase 6's batch and weights, AdamW 3e-4, 4 microbatches (2 at dp 2:
   4 rows split over 2 replicas x 2), every cell the card, in
   PP_LAYOUTS: (a) pp 4 gpipe flash, (b) pp 4 1f1b flash, (c) pp 4 zb
   flash, (d) dp 2 x pp 2 x tp 2 1f1b flash ZeRO-1, (e) dp 2 x pp 2
   FSDP gpipe flash, all at PP14_LAYERS = 4 layers of 16, and
   (f) pp 2 gpipe on the plain attention at 4 layers: the loss at init
   within PARITY_LOSS_BUDGET of the one-device engine's at that depth
   (the flash engine's; the plain engine's for (f)),
   every first-step gradient leaf within GRAD_TOL_BF16 of the one-device
   engine's (the flash engine's for (a)-(e)), and (b)'s and (c)'s also
   of (a)'s; a warm-up step, then PP_STEPS timed steps with the counts
   zeroed before them
   (K1, K2, K3 each `pp_launches_per_step`: n_layers x n_mu x dp x tp,
   K1 twice that under 1f1b; none in (f)), finite losses, step p50,
   tok/s, MFU, peak memory, the bytes of the fullest cell (`pp layout`
   lines) and one profiled step of (b) (`pp profile`). Then `train_lm`
   at 2 layers: `--pp 2 --pp-schedule zb --attn flash` with a save,
   resumed at `--dp 2 --pp 2 --tp 2 --pp-schedule 1f1b` within
   PARITY_LOSS_BUDGET of a straight run (`pp driver:`; phase 15's
   driver makes the pipelined decode).

15. The rest of the LM pipeline, as phase 14 in PP15_LAYOUTS: (a) pp 4
   x vpp 2 gpipe flash, (b) pp 4 x vpp 2 1f1b flash, (c) pp 2 x sp 2
   gpipe ring-flash, (d) pp 2 x sp 2 1f1b ulysses-flash, (a) and (b)
   at PP15_LAYERS = 8 layers of 16 (the least pp 4 x vpp 2 takes), (c)
   and (d) at PP15_SP_LAYERS = 4 (cut for the script's time), and (e)
   phase 10c's MoE (4 experts, top-2) at pp 2 x ep 2 1f1b flash at
   MOE_LAYERS = 2 layers, 2
   microbatches per ep replica: the loss at init within
   PARITY_LOSS_BUDGET of the one-device engine's at that depth,
   every first-step gradient leaf within GRAD_TOL_BF16 of the
   one-device flash engine's, (b)'s also of (a)'s; (e) in f32 compute
   as phase 13 compares MoE (the timed engine then bf16), the loss and
   every gradient leaf within GRAD_TOL_F32 (relative, as phase 7) of
   the one-device engine's over the same 4 microbatches; a warm-up
   step, PP_STEPS timed steps with the counts zeroed before them
   (`pp_launches_per_step`: ring-flash's 3 hops a layer on K1's
   f32-output build, ulysses-flash's 2 head groups, K1 twice under
   1f1b), finite losses, step p50, tok/s,
   MFU, peak memory, the fullest cell (`pp layout` lines) and one
   profiled step of (b). Then `train_lm` at 4 layers: `--pp 2
   --virtual-pp 2 --pp-schedule 1f1b --attn flash` with a save, resumed
   at `--pp 2 --sp 2 --attn ring-flash` within PARITY_LOSS_BUDGET of a
   straight run, and `--pp 2 --virtual-pp 2 --sample-only --generate 16
   --temperature 0` on that checkpoint, its greedy stream equal to
   `models.generate.generate`'s (`pp15 driver:`).

16. Comm overlap (`parallel/overlap.py`: each bucket of replica r >= 1's
   gradient added into the rank-order sum from its backward, on a side
   stream), every line with the card's name and power limit. (a)
   `ContextParallelEngine` dp 2 flash at full width and OV_LAYERS = 1
   of 16 layers (phase 6's batch and weights, cut for the script's
   time), AdamW 3e-4, overlap off, then on with 4 and 64
   MiB buckets: two overlap-off `loss_and_grads` calls against each
   other first, then each overlapped engine's first-step loss and every
   gradient leaf against off's, bit for bit (within the off-off spread
   if that is not zero); a warm-up and OV_STEPS timed steps with the
   counts zeroed before them (K1, K2, K3 on the tensor cores 2 x
   n_layers a step each), their losses equal to off's, buckets issued on
   the side stream; step p50, tok/s, MFU, peak memory; one profiled step
   each (`stream_overlap`: the side stream's busy ms, the ms of it that
   coincide with main-stream work, the host-idle share). (b) dp 2 x sp 2
   ring-flash ZeRO-2 accum 2 at OV_Z2_LAYERS layers (K1's f32-output
   build), (c) `FSDPEngine` dp 4 at OV_FSDP_LAYERS layers on the plain
   attention (and its refusal of Adafactor), each overlap off against
   on bit for bit with launches and step p50. (d) `FusedDPEngine` dp 2
   and `SPMDPipelineEngine` dp 2 x pp 2 in both hop modes at the MLP's
   width, bit for bit against off, the ticks of `schedule_info`. (e)
   `train_lm --dp 2 --attn flash --overlap on --bucket-mb 4` at
   OV_DRIVER_LAYERS layers with a save, resumed with overlap off within
   PARITY_LOSS_BUDGET of a straight run; `train --dp 2 --pp 2 --engine
   spmd --overlap on` against overlap off (model hashes equal).

17. The multi-process launch (`shallowspeed_tpu_torch.distributed`):
   the script starts two worker processes of itself on the one card
   (`--phase17-worker`; gloo, two processes sharing one card, CUDA
   tensors staged through pinned host buffers). (a) the 1.21B LM at
   full width and MP_LAYERS = 4 of 16 layers, `PipelineLMEngine` at dp
   1 x pp 2 with a stage on each process, flash, gpipe and then 1f1b,
   AdamW 3e-4 (clip 1.0), phase 6's batch in 4 microbatches, MP_STEPS
   steps; (b) `ContextParallelEngine` dp 2 across the processes, flash,
   MP_SMALL_LAYERS = 2 layers, each process its rows. Each process's
   losses and the sha1 of every parameter leaf at the end equal the
   other's and the same engine's in this process, bit for bit (if they
   differ, the one-process run is repeated: only a run that differs
   from itself sets a spread, printed); each process's K1-K3 launches
   are its stage's layers x microbatches a step (K1 twice under 1f1b);
   per process step p50, peak memory, the MB a step moves by hops and
   by sums, and the share of the step in transfers and in host-staged
   copies (`mp a-gpipe:`, `mp a-1f1b:`, `mp b:`). (c) a two-process
   pp 2 engine like (a)'s at MP_SMALL_LAYERS layers takes a step and
   saves (the collective fetch of the parameters and the AdamW state;
   process 0 writes, a barrier follows the rename), then takes one more
   step; an engine in this process restores the save with the same
   `eval_loss` and takes the same step to the same loss and leaf sha1s,
   bit for bit; an `AsyncSaver` failure injected on process 0 raises
   in `wait()` on both (`mp (c):`). (d) `train_lm
   --pp 2 --attn flash` at 2 layers, MP_STEPS steps, launched as two
   processes with the reference's three variables: process 0's JSONL
   losses and step lines equal the one-process run's, process 1 prints
   no step line (`mp (d):`).

18. The telemetry core (`shallowspeed_tpu_torch.telemetry`) on the
   port's own entry points, the 1.21B LM at full width and TELE_LAYERS
   = 4 of 16 layers (one seeded draw shared by the phase's runs,
   `_cached_draw`), 4 x 2048, `--attn flash`, AdamW under ZeRO-1 at dp
   1 (the reference's split step: "grads" and "update" inside "step").
   (a) `train_lm` TELE_STEPS steps at `--telemetry off`, `steps`,
   `spans` and `spans` with `--profile host` at TELE_HZ: the losses
   bit for bit equal, K1-K3 launches equal at every level (n_layers a
   step each); at `spans` every "step" span holds its "grads" and
   "update" spans and lies within the driver's window of that step,
   3 fences a step (none at the other levels), `hbm_alloc_peak_mib`
   equal to `torch.cuda.max_memory_allocated` over the run, the owner
   "train.params" the parameter tree's bytes exactly (telemetry.json),
   `spans.jsonl` valid under `python -m shallowspeed_tpu_torch.telemetry
   --validate`; the sampled run's samples by phase tag and its step p50
   against the unsampled `spans` run's (`tele (a):`). (b) `--profile-dir`
   over TELE_PROFILE_STEPS steps: the Chrome trace names
   flash_fwd_tc_kernel, flash_dq_tc_kernel and flash_dkv_tc_kernel as
   often as the launch counters counted, and no library attention kernel
   (`tele (b):` names, counts, summed device ms). (c) `serve --profile
   host` at TELE_SERVE_LAYERS layers, 8 slots, phase 3's 12 greedy
   requests: streams equal the run without `--profile`, K4 n_layers x
   ticks, the last "profile" snapshot holds samples inside the engine's
   tick (`tele (c):`). (d) counted traffic: `PipelineLMEngine` pp 2
   gpipe at TELE_PP_LAYERS layers, 4 microbatches of 1 x 2048, moves
   8 x (1 x 2048 x 2048) bf16 hops a step on the pp axis; the context
   engine at dp 2, TELE_DP_LAYERS layers, moves replica 1's f32
   gradient partial on the dp axis; each equal to the analytic bytes
   printed beside it (`tele (d):`).

19. Monitor and accounting (`shallowspeed_tpu_torch.telemetry`'s
   `monitor`, `goodput`, `bubble`, `attribution`) on the port's entry
   points, the 1.21B LM at full width and MON_LAYERS = 2 of 16 layers
   (one seeded draw, `_cached_draw`), 4 x 2048, `--attn flash`. Every
   monitor endpoint the drivers start is polled from a thread while the
   run is live (`_polled_monitors`: /status.json and /metrics). (a)
   `train_lm --pp 2 --n-mubatches 4 --telemetry spans`, gpipe and then
   1f1b, MON_STEPS steps, with and without `--monitor-port 0 --slo
   'step_p95_ms<1' --flight-recorder 64`: losses bit for bit equal and
   K1-K3 launches equal; the SLO fires, a flight dump is written, the
   poller was answered; the step quantiles of the monitor's last
   snapshot, `bubble_static` and the calibrated `bubble_measured`
   (gpipe's equal to the static 0.200 to rounding: its replay is
   F:B-invariant); `two_point_bubble` of a pp 2 gpipe engine against
   its `make_calibration_twin` (twice the microbatches on twice the
   rows, MON_TWIN_STEPS fenced steps each) (`mon (a):`). (b) phase 18
   (a)'s `spans` run (the one-device flash step under ZeRO-1, TELE_LAYERS
   layers): the roofline `roofline_of_step` counted on its first step
   (FLOPs, dot bytes, bytes) equal to the executed FLOPs written out
   here, K1-K3's self-reported FLOPs equal to their causal counts, and
   its last step line's `attrib_*` waterfall from the card's table
   (`mon (b):`). (c) `--goodput` of (a)'s monitored gpipe log: goodput,
   the named losses, the first window's `compile` loss beside the
   kernels built before it (phase 1), and the window-sum check: the step
   lines' window seconds plus the excluded ledger seconds equal the
   wall `StepRates` measured, within 1 ms (`mon (c):`). (d) `serve` at
   MON_SERVE_LAYERS layers, phase 3's 12 greedy requests, `--monitor-port
   0 --slo 'ttft_p95_ms<1' --flight-recorder 64`: streams equal phase
   18 (c)'s run without the monitor, K4 n_layers x ticks, the 1 ms SLO
   fires, a flight dump is written, the sketch's ttft/tpot p50/p95
   within its rel_err of the exact request percentiles (`mon (d):`).
   (e) `train --engine vm --pp 2 --schedule gpipe --telemetry spans`
   at the MLP's full width, MON_MLP_BATCHES batches: the bubble
   replayed from the VM's fenced Forward / Backward spans against the
   static 0.200 (`mon (e):`).

20. Supervised fault drills (`shallowspeed_tpu_torch.elastic`,
   `chaos`), each child a `python3 chip_smoke.py --phase20-child`
   process on the card. (a) runs inside phase 6b (see there): `train_lm`
   at CKPT_LAYERS under the supervisor (max 4 restarts, backoff 0.3 s,
   term grace 3 s) with the plan DRILL_PLAN (a 0.5 s data-loader stall
   at step 1, a kill at step 4, the second save corrupted after it
   lands): two children, the losses run A's bit for bit, the three
   faults stamped once, the restart resumed from the first save and
   never from a corrupted directory, `run_goodput`'s crash MTTR and
   >= 95 % of the wall accounted, each child's K1-K3 launches counted
   as in phase 6b (`drill (a):` line: wall, children, MTTR, restart
   downtime, child start, save and restore seconds, goodput). (b)
   `train --engine spmd --schedule gpipe --dp 2` at the MLP's full
   width as two processes on the card (gloo) under the gang supervisor,
   process 1 killed at the top of epoch 1: the whole gang restarts from
   epoch 0's checkpoint and ends on the one-process run's model hash
   (`drill (b):` line). (b) runs beside (a), its supervisor on a
   thread of this process (both drills are mostly process start-up),
   so both lie inside phase 6b's clock.

21. The serving fleet (`serving/router.py`, `telemetry/fleet.py`, the
   `router` driver), right after phase 5b on phase 3's weights. (b)'s
   router starts first, so that its children start while (a) and (b)'s
   oracle run. (a) `Router` over two `InProcessReplica`s of
   `ServingEngine(attn_impl="flash")` on one params tree, phase 3's 12
   greedy requests and FLEET_SAMPLED sampled ones (temperature
   0.7-1.0, distinct seeds), r0 killed once a request is mid-stream on
   it and the router run until r0 is back: in f32 at FLEET_F32_LAYERS
   layers every stream must equal one solo engine's over the same
   requests, token for token; in bf16 at full depth every request must
   complete, and the greedy streams equal to phase 3's are counted
   (printed, not gated: a bf16 re-prefill may flip a near-tied argmax).
   Both: at least one failover, the breaker open / half_open / closed,
   r0's restart_downtime of class crash, a router log that validates,
   every live allocator balanced, K4 launched n_layers x the ticks of
   every engine the drill built (`fleet (a) f32:` / `fleet (a) bf16:`).
   (b) `python -m shallowspeed_tpu_torch.router --replicas 2` over
   `serve --serve --device cuda` children at full width and
   FLEET_CLI_LAYERS layer (f32), FLEET_CLI_REQUESTS requests (greedy
   and sampled) under FLEET_CHAOS (r0 killed at its 6th tick, r1
   stalled 0.5 s at its 4th), `--await-replicas` and `--settle`: every
   stream equal to a plain `serve` run's with the same flags and
   requests (in this process), a failover, r0 respawned, `--goodput`
   over the router log giving r0's MTTR and the fleet's availability;
   `--fleet --once` over the replicas the router's endpoint lists once
   every request has its result; the replicas' start times and the
   fleet-edge ttft p50 / p95 (`fleet (b):`). The router's session is
   stopped on the way out (SIGTERM, then SIGKILL).

The last lines are the card's name and power limit, one JSON line with
the kernels' numbers (with `device_ms` / `library_device_ms` where the
profiler timed them, K1-K3's `recipe_launches` from phase 10a,
`cp_launches` from phase 12c, `pp_launches` from phase 14,
`pp15_launches` from phase 15, `ov_launches` from phase 16's
overlapped runs, (a) and (b), `mp_launches` [process 0, process 1]
from phase 17's (a) and (b), `tele_launches` from phase 18 (a)'s
`spans` run, `mon_launches` from phase 19's (a) monitored runs and
(d), `drill_launches` [first child, restart] from phase 20 (a), and
K4's `fleet_launches` [f32, bf16] from phase 21 (a)), and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks, dense (see PERF.md)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

SLICE = dict(slots=8, heads=16, kv_heads=16, head_dim=128, block_size=16)
N_REQUESTS = 12
MAX_NEW = 32
PREFILL_CHUNK = 256
N_BLOCKS = 1024
# Paged serving logits vs the plain full forward over the same tokens,
# as max |diff| / max |ref| over every compared position (PERF.md,
# "chip_smoke tolerances", has the measurements behind both bounds).
# bf16 compute: bf16 rounding through 16 layers differs between one
# token at a time and the whole sequence at once, so the two sit ~1.5e-2
# apart; the bound catches a wrong block, position or mask (errors of
# order 1), not a one-rounding slip, which hides in that noise.
LOGITS_TOL_BF16 = 3e-2
# f32 compute (the same weights, the kernel's f32 build): the paths
# differ only in summation order (~4e-6 on an H100), while a bf16 rounding
# of q and K before the scores lands near 3e-3; phase 4 checks that it
# does exceed this bound.
LOGITS_TOL_F32 = 1e-4

# The contiguous generate() phase: GEN_BATCH prompts of GEN_PROMPT
# tokens, GEN_NEW greedy new tokens, prefilled through K1.
GEN_BATCH = 8
GEN_PROMPT = 1024
GEN_NEW = 64

# The prefix-cache run: PREFIX_LEN shared tokens (3 prefill chunks, 48
# blocks, numpy seed 5), ten tails of 64-256 tokens, two exact copies.
PREFIX_LEN = 768
# The speculative run: SPEC_REQUESTS prompts of 256-1024 tokens that
# repeat one 32-token motif (numpy seed 6), SPEC_NEW new tokens each.
SPEC_K = 4
SPEC_REQUESTS = 4
SPEC_NEW = 64

# K5: the probe phase's chain length, and the shape K5 is timed at (the
# narrow-K shape the probe exists for) with the probe's blocks.
PROBE_ITERS = 5
K5_SHAPE = (16384, 1024, 4096)
K5_BLOCKS = dict(bm=512, bk=1024, bn=1024)

# Training: 1 warm-up step, then TRAIN_STEPS timed steps on one repeated
# (TRAIN_BATCH, max_seq) batch.
TRAIN_BATCH = 4
TRAIN_STEPS = 6
# Kernels (flash_attention) vs plain attention under autograd, as
# max |diff| / max |ref| of the loss and of each gradient leaf (PERF.md,
# "chip_smoke tolerances", has the measurements behind both bounds).
# f32 compute, full width, 2 layers: the two differ in summation order
# only (worst leaf ~4e-6 on an H100), while a bf16 rounding of q and K
# before the plain scores moves a gradient leaf by ~5e-3; phase 7 checks
# that it does exceed this bound.
GRAD_TOL_F32 = 1e-4
# bf16 compute, full depth, the loss at the initial weights: the kernels
# keep P in f32 through PV where the plain attention rounds it to bf16;
# measured ~2e-5 apart. The bound catches a wrong mask or scale (order-1
# errors), not a single rounding.
LOSS_TOL_BF16 = 1e-3
# Phase 10: a bf16 gradient leaf against its counterpart's, as max
# |diff| / max |ref| (the bf16 bound of tests/test_torch_train.py: the
# two round activations and cotangents to bf16 at different points).
GRAD_TOL_BF16 = 5e-2
# Phase 10's depths (width is never cut): the recipe at full depth, the
# feature matrix at FEATURE_LAYERS, MoE at MOE_LAYERS with MOE_EXPERTS
# experts, top-2, capacity 2.0, MOE_STEPS steps.
FEATURE_LAYERS = 2
MOE_LAYERS = 2
MOE_EXPERTS = 4
MOE_STEPS = 4


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# Itanium-mangled template arguments of the kernels: dtype codes, and
# the blocked_matmul_kernel types (class types are substitution
# candidates after the namespace and the template's own name)
_GEMM_B = {"1": "bf16", "2": "int8", "3": "e4m3"}
_MANGLED_TYPES = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16",
                  "13__nv_fp8_e4m3": "e4m3"}


def _type_args(mangled: str) -> list[str]:
    known, out = ["", ""], []
    for tok in re.findall(r"13__nv_bfloat16|13__nv_fp8_e4m3|S\d*_|[fa]",
                          mangled.split("EE")[0]):
        if tok.startswith("S"):
            out.append(known[int(tok[1:-1] or -1) + 1])
        else:
            out.append(_MANGLED_TYPES[tok])
            if tok.startswith("13"):
                known.append(out[-1])
    return out


def _ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel: its template instance, registers
    and spills, from `nvcc -Xptxas -v` output."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"((?:paged_decode_combine|paged_decode|flash_fwd_tc|"
                      r"flash_fwd|flash_dq_tc|flash_dq|flash_dkv_tc|"
                      r"flash_dkv|gemm_tc|split_sum|"
                      r"blocked_matmul)_kernel)"
                      r"(?:I(\w+)|\w*)'", line)
        if m and m.group(1).startswith("paged_decode") and m.group(2):
            # <q dtype[, pool dtype], hd[, rows a warp]>
            ints = re.findall(r"Li(\d+)E", m.group(2))
            tag = ",".join(_type_args(m.group(2)) + ints[:1]
                           + [f"g{g}" for g in ints[1:2]])
            name = f"{m.group(1)}<{tag}>"
        elif m and m.group(1) == "gemm_tc_kernel":   # <WG, B, A dtype>
            wg, bt, at = re.findall(r"Li(\d+)E", m.group(2))[:3]
            name = (f"gemm_tc_kernel<wg{wg},{_GEMM_B[bt]}>" if at == "1"
                    else f"gemm_tc_kernel<wg{wg},e4m3 x e4m3>")
        elif m and m.group(1).endswith("_tc_kernel"):   # <int D[, f32 o]>
            d = re.match(r"Li(\d+)E", m.group(2)).group(1)
            f32o = ",f32o" if "Lb1E" in m.group(2) else ""
            name = f"{m.group(1)}<bf16,{d}{f32o}>"
        elif m and m.group(1) == "blocked_matmul_kernel":   # <x, y, out>
            name = m.group(1) + "<" + ",".join(_type_args(m.group(2))) + ">"
        elif m and m.group(2):
            inst = re.findall(r"(__nv_bfloat16|f)(?:Li(\d+)E)", m.group(2))
            name = m.group(1) + "".join(
                f"<{'bf16' if t == '__nv_bfloat16' else 'f32'},{d}>"
                for t, d in inst[:1])
        elif m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


# the tensor-core kernels: (library, kernel, builds, dynamic shared
# memory of each build in bytes, by a C entry of the library)
def _tc_builds():
    from shallowspeed_tpu_torch.ops import flash_attention as FA
    from shallowspeed_tpu_torch.ops import matmul as MM

    fwd, bwd = FA._train_kernels()
    mm = MM._kernel()
    per_d = [(f"<bf16,{d}>", d) for d in (64, 128)]
    return [
        ("flash_fwd", "flash_fwd_tc_kernel",
         [(f"<bf16,{d}{o}>", fwd.flash_fwd_tc_smem(d))
          for o in ("", ",f32o") for d in (64, 128)]),
        ("flash_bwd", "flash_dq_tc_kernel",
         [(t, bwd.flash_dq_tc_smem(d)) for t, d in per_d]),
        ("flash_bwd", "flash_dkv_tc_kernel",
         [(t, bwd.flash_dkv_tc_smem(d)) for t, d in per_d]),
        ("blocked_matmul", "gemm_tc_kernel",
         [(f"<wg{wg},{b}>", mm.gemm_tc_smem(wg, 1, code))
          for wg in (1, 2) for code, b in ((1, "bf16"), (2, "int8"),
                                           (3, "e4m3"))]
         + [(f"<wg{wg},e4m3 x e4m3>", mm.gemm_tc_smem(wg, 3, 3))
            for wg in (1, 2)]),
    ]


def check_tc_builds(logs: dict) -> None:
    """Phase 1: the tensor-core kernels' registers, spills and dynamic
    shared memory; each build must compile without a spill."""
    for lib, src, builds in _tc_builds():
        lines = [ln for ln in _ptxas_lines(logs[lib]) if ln.startswith(src)]
        if len(lines) != len(builds) or not all(
                " 0 bytes spill stores, 0 bytes spill loads" in ln
                for ln in lines):
            raise AssertionError(f"{src}: want {len(builds)} builds without "
                                 f"spills, ptxas says {lines}")
        for tag, smem in builds:
            print(f"  {src}{tag}: {smem} bytes of dynamic shared memory",
                  flush=True)


def check_decode_builds(logs: dict, dev) -> None:
    """Phase 1: every build of K4's split and merge kernels compiles
    without a spill; the split kernel's dynamic shared memory at the
    serving shape (G = 1, hd 128) and at G = 8, per pool dtype."""
    from shallowspeed_tpu_torch.ops import flash_attention as FA

    lines = [ln for ln in _ptxas_lines(logs["paged_decode"])
             if ln.startswith("paged_decode")]
    # 2 q dtypes x 2 hd x 2 pool kinds x 4 row counts, and 4 merges
    if len(lines) != 36 or not all(
            " 0 bytes spill stores, 0 bytes spill loads" in ln
            for ln in lines):
        raise AssertionError(f"paged_decode: want 36 builds without "
                             f"spills, ptxas says {lines}")
    lib = FA._kernel()
    for pools, label in ((0, "f32"), (1, "bf16"), (2, "int8")):
        print(f"  paged_decode_kernel {label} pools, hd 128: "
              f"{lib.paged_decode_smem(1, 128, pools)} bytes of dynamic "
              f"shared memory at G = 1, "
              f"{lib.paged_decode_smem(8, 128, pools)} at G = 8",
              flush=True)
    s, hkv = SLICE["slots"], SLICE["kv_heads"]
    print(f"  decode_splits at the serving shape ({s} slots x {hkv} kv "
          f"heads, W 128, {FA._sm_count(dev)} SMs): "
          f"{FA.decode_splits(s, hkv, 128, FA._sm_count(dev))}", flush=True)


def _time_ms(fn, inputs, repeats=7):
    """Median ms per call of fn(*inputs[i]) cycling through `inputs`
    (enough distinct inputs that they do not stay in the 50 MB L2)."""
    import torch

    for args in inputs[:3]:
        fn(*args)
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for args in inputs:
            fn(*args)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / len(inputs))
    return float(np.median(per))


def _decode_inputs(rng, dev, dtype, slots, heads, kv_heads, head_dim,
                   block_size, width, window=0, pos=None, kv_quant=""):
    """Random q and pools, tables of distinct non-scratch blocks, and
    positions; the last row is a scratch row (pos 0, table all block 0)
    like an empty decode slot. With kv_quant="int8" the pools are the
    same random values quantized by `kv_cache.quantize_kv` (int8 values
    and f32 scale planes); q stays in `dtype`."""
    import torch

    from shallowspeed_tpu_torch.models.kv_cache import quantize_kv

    n = slots * width + 1
    perm = rng.permutation(np.arange(1, n)).reshape(slots, width)
    bt = perm.astype(np.int32)
    if pos is None:
        pos = rng.integers(0, width * block_size, slots)
    pos = np.asarray(pos, np.int32).copy()
    bt[-1], pos[-1] = 0, 0
    shape = (n, kv_heads, block_size, head_dim)
    if kv_quant:
        pool = {}
        for name in ("k", "v"):
            pool[name], pool[name + "_s"] = quantize_kv(
                torch.randn(shape, device=dev))
    else:
        pool = {"k": torch.randn(shape, device=dev).to(dtype),
                "v": torch.randn(shape, device=dev).to(dtype)}
    q = torch.randn(slots, heads, head_dim, device=dev).to(dtype)
    return (q, pool, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), window)


def _decode_err(got, q, pool, bt, pos, window) -> tuple[float, float]:
    """(max |diff|, worst |diff| / allowance) of the int8 decode kernel's
    output `got` against its plain version, per element: KERNEL_TOL of
    |ref| + mean |ref| in f32; with bf16 q also one bf16 rounding of the
    output (BF16_ULP |ref|) and the plain version's one rounding of
    P * v_s to bf16 before PV, which moves an output element by at most
    2^-8 of sum_t p_t |v_t| / l — the plain version's own attention over
    |V|, computed in f32."""
    import torch

    from shallowspeed_tpu_torch.ops.flash_attention import (
        BF16_ULP, KERNEL_TOL, paged_flash_decode_reference)

    ref = paged_flash_decode_reference(q, pool, bt, pos, window=window)
    got, ref = got.float(), ref.float()
    mag = ref.abs()
    scale = float(mag.mean())
    if not scale > 0:
        raise AssertionError("the plain version's output is all zero")
    allow = KERNEL_TOL * (mag + scale)
    if q.dtype == torch.bfloat16:
        absv = dict(pool, v=pool["v"].abs())
        pv = paged_flash_decode_reference(q.float(), absv, bt, pos,
                                          window=window)
        allow = allow + BF16_ULP * mag + 2.0 ** -8 * pv
    diff = (got - ref).abs()
    return float(diff.max()), float((diff / allow).max())


def _edge_pos(name, shape, splits, rng):
    """Positions of an edge case (the last row is then made a scratch
    row by `_decode_inputs`), or None for random ones."""
    s, bs, w = shape["slots"], shape["block_size"], shape["width"]
    if name == "edge-pos0-full":        # pos 0 beside full tables
        return [0] + [w * bs - 1] * (s - 1)
    if name == "edge-short":            # fewer live columns than splits
        return rng.integers(0, max(1, splits - 1) * bs, s)
    if name == "edge-w1":
        return rng.integers(0, bs, s)
    return None


def check_kernels(dev) -> dict:
    """Phase 2: the paged decode kernel against its plain version, over
    float pools (max |diff| / max |ref|: 1e-4 in f32, 1e-2 in bf16) and
    over int8 pools (per element, `_decode_err`), at small and serving
    shapes and at the edges of the split: a row at pos 0 beside full
    tables, rows with fewer live columns than splits, a window that
    starts inside a block of a long table, W = 1, G = 8, G = 3 (rows
    split unevenly over the warps), G = 40 (two row chunks), bs 8 and
    32."""
    import torch

    from shallowspeed_tpu_torch.ops.flash_attention import (
        _paged_flash_decode_int8, _sm_count, decode_splits,
        paged_flash_decode, paged_flash_decode_reference)

    rng = np.random.default_rng(0)
    small = dict(slots=4, head_dim=64, block_size=8, width=3)
    big = dict(SLICE, width=64)
    cases = [
        ("small-mha", dict(small, heads=4, kv_heads=4), 0),
        ("small-gqa", dict(small, heads=8, kv_heads=2), 0),
        ("small-window", dict(small, heads=4, kv_heads=4), 6),
        ("slice-mha", big, 0),
        ("slice-gqa", dict(big, kv_heads=4), 0),
        ("slice-window", big, 100),
        ("edge-pos0-full", big, 0),
        ("edge-short", big, 0),
        ("edge-window-mid", big, 77),
        ("edge-w1", dict(big, width=1), 0),
        ("edge-g8", dict(big, kv_heads=2), 0),
        ("edge-g3", dict(big, heads=12, kv_heads=4), 0),
        ("edge-g40", dict(big, heads=40, kv_heads=1), 0),
        ("edge-bs8", dict(big, block_size=8), 0),
        ("edge-bs32", dict(big, block_size=32, width=32), 0),
    ]
    # f32: only the summation order differs. bf16: the output is rounded
    # to bf16 once, and the reference rounds P to bf16 before PV.
    tols = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    worst = {"paged_flash_decode": 0.0, "paged_flash_decode_int8": 0.0}
    for name, shape, window in cases:
        splits = decode_splits(shape["slots"], shape["kv_heads"],
                               shape["width"], _sm_count(dev))
        pos = _edge_pos(name, shape, splits, rng)
        for dtype, tol in tols.items():
            tag = f"{name} {str(dtype)[6:]} ({splits} splits)"
            q, pool, bt, p, w = _decode_inputs(rng, dev, dtype,
                                               window=window, pos=pos,
                                               **shape)
            before = paged_flash_decode.launches
            got = paged_flash_decode(q, pool, bt, p, window=w)
            torch.cuda.synchronize()
            if paged_flash_decode.launches != before + 1:
                raise AssertionError("float pools did not launch the "
                                     "float kernel once")
            ref = paged_flash_decode_reference(q, pool, bt, p, window=w)
            err = float((got.float() - ref.float()).abs().max())
            rel = err / max(1e-6, float(ref.float().abs().max()))
            if not (rel <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"paged_flash_decode {tag}: "
                                     f"rel err {rel:.3e} > {tol:g}")
            print(f"check paged_flash_decode {tag}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g})",
                  flush=True)
            if name == "slice-mha" and dtype == torch.bfloat16:
                worst["paged_flash_decode"] = err

            q, pool, bt, p, w = _decode_inputs(rng, dev, dtype,
                                               window=window, pos=pos,
                                               kv_quant="int8", **shape)
            before = _paged_flash_decode_int8.launches
            got = paged_flash_decode(q, pool, bt, p, window=w)
            torch.cuda.synchronize()
            if _paged_flash_decode_int8.launches != before + 1:
                raise AssertionError("int8 pools did not launch the int8 "
                                     "kernel once")
            err, ratio = _decode_err(got, q, pool, bt, p, w)
            finite = bool(torch.isfinite(got).all())
            print(f"check paged_flash_decode_int8 {tag}: "
                  f"max_abs_err {err:.3e}, worst element at {ratio:.3e} of "
                  f"its allowance", flush=True)
            if not (ratio <= 1.0 and finite):
                raise AssertionError(f"paged_flash_decode_int8 {tag}: an "
                                     f"element off by {ratio:.3e} x its "
                                     f"allowance (finite: {finite})")
            if name == "slice-mha" and dtype == torch.bfloat16:
                worst["paged_flash_decode_int8"] = err
    return worst


def _first_layers(np_params, n: int) -> dict:
    """The 1.21B LM's draw (`init_numpy(cfg, seed=0)`) cut to its first
    `n` blocks: the weights of the phases that hold two paths against
    each other at a cut depth (the draw at full width takes seconds a
    layer, so it is made once)."""
    return {**np_params, "blocks": np_params["blocks"][:n]}


def slice_config():
    import torch

    from shallowspeed_tpu_torch.models import transformer as T

    return T.TransformerConfig(
        vocab=32768, d_model=2048, n_heads=16, n_layers=16, max_seq=2048,
        dtype=np.float32, compute_dtype=torch.bfloat16, rope=True,
        norm="rmsnorm", ffn="swiglu")


def _random_prompts(vocab) -> dict:
    """Phase 3's requests: N_REQUESTS prompts of 128-1024 random ids,
    numpy seed 1."""
    rng = np.random.default_rng(1)
    lens = rng.integers(128, 1025, N_REQUESTS)
    return {f"r{i}": rng.integers(0, vocab, n).astype(np.int32)
            for i, n in enumerate(lens)}


def serve(dev, cfg, params, kv_quant="", weight_quant="", prompts=None,
          max_new=MAX_NEW, profile=True, label="", **engine_kw) -> dict:
    """Phase 3: the 1.21B LM served through the port's engine from the
    f32 master weights `params` (the numpy draw `init_numpy(cfg,
    seed=0)` on the card), with `kv_quant` pools and `weight_quant`
    weights; by default the 12 random requests of phase 3, else
    `prompts` ({rid: ids}) with `max_new` new tokens each, and
    `engine_kw` (spec_k, prefix_cache) passed to the engine. The decode
    kernel the pools call for must launch n_layers x ticks times, the
    other none; at drain no block is live and every block is free or
    cold (indexed by the prefix cache). With `profile`, a synthetic tick
    is timed and profiled after the run."""
    import torch

    from shallowspeed_tpu_torch.ops import matmul as MM
    from shallowspeed_tpu_torch.ops.flash_attention import (
        _paged_flash_decode_int8, paged_flash_decode)
    from shallowspeed_tpu_torch.telemetry.report import request_summary
    from shallowspeed_tpu_torch.serving.engine import ServingEngine

    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(params, cfg, n_blocks=N_BLOCKS,
                        block_size=SLICE["block_size"],
                        max_slots=SLICE["slots"],
                        prefill_chunk=PREFILL_CHUNK, attn_impl="flash",
                        kv_quant=kv_quant, weight_quant=weight_quant,
                        device=dev, **engine_kw)
    # one warmup request first: library handles and first-call setup for
    # each prefill shape are process start-up, not serving time
    eng.submit(np.arange(300, dtype=np.int32) % cfg.vocab, 4, rid="warmup")
    eng.run()
    del eng.results["warmup"], eng.request_records[:]
    base = dict(eng.counters)
    if prompts is None:
        prompts = _random_prompts(cfg.vocab)
    for rid, p in prompts.items():
        eng.submit(p, max_new, rid=rid)

    kernels = {"paged_flash_decode": paged_flash_decode,
               "paged_flash_decode_int8": _paged_flash_decode_int8}
    used = "paged_flash_decode_int8" if kv_quant else "paged_flash_decode"
    dense = (MM._dequant_matmul_tc, MM._dequant_matmul_fma)
    for k in (*kernels.values(), *dense):
        k.launches = 0
    tick_s = []
    t0 = time.time()
    while eng.pending():
        chunks = eng.counters["prefill_chunks"]
        ticks = eng.counters["ticks"]
        s0 = time.perf_counter()
        if not eng.step():
            raise AssertionError("engine made no progress")
        if (eng.counters["prefill_chunks"] == chunks
                and eng.counters["ticks"] == ticks + 1):
            tick_s.append(time.perf_counter() - s0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    dense_launches = [k.launches for k in dense]
    # quantized weights: every dense of every prefill chunk and tick
    # through the tensor-core route (bf16 compute), the FMA route never
    if (dense_launches[1] or bool(dense_launches[0]) != bool(weight_quant)
            or (weight_quant and cfg.act_dtype != torch.bfloat16)):
        raise AssertionError(f"dequant_matmul launched tc, fma "
                             f"{dense_launches} times with weight_quant="
                             f"{weight_quant!r}")

    ticks = eng.counters["ticks"] - base["ticks"]
    want = {name: cfg.n_layers * ticks if name == used else 0
            for name in kernels}
    if launches != want or ticks == 0:
        raise AssertionError(f"decode kernels launched {launches} times "
                             f"over {ticks} ticks of {cfg.n_layers} layers "
                             f"(kv_quant={kv_quant!r}), want {want}")
    a = eng.alloc
    if a.n_live or a.n_free + a.n_cold != a.n_usable:
        raise AssertionError(f"allocator unbalanced at drain: "
                             f"{a.n_free} free + {a.n_cold} cold of "
                             f"{a.n_usable}, {a.n_live} live")
    for rid in prompts:
        toks = eng.results[rid]
        if toks.shape != (max_new,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"bad result for {rid}: {toks}")
    summ = request_summary(eng.request_records)
    out = {"run": label or "random", "kv_quant": kv_quant,
           "weight_quant": weight_quant, "compute": str(cfg.act_dtype)[6:],
           "n_layers": cfg.n_layers, **engine_kw,
           "ticks": ticks, "launches": launches[used],
           "dequant_matmul_tc_launches": dense_launches[0], "wall_s": wall,
           "decode_only_ticks": len(tick_s),
           "tick_ms_p50": 1e3 * float(np.median(tick_s)) if tick_s else None,
           "tok_per_s": summ["tokens_out"] / wall,
           "ttft_ms_p50": summ["ttft_ms_p50"],
           "ttft_ms_p95": summ["ttft_ms_p95"],
           "tpot_ms_p50": summ["tpot_ms_p50"],
           "prefill_chunks": (eng.counters["prefill_chunks"]
                              - base["prefill_chunks"]),
           "preempted": eng.counters["preempted"] - base["preempted"],
           "max_table_blocks": int(max(len(p) for p in prompts.values())
                                   + max_new - 1) // SLICE["block_size"] + 1,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "blocks_free_at_drain": f"{a.n_free}/{a.n_usable}",
           "cold_blocks": a.n_cold}
    out.update({k: eng.counters[k] - base[k] for k in (
        "spec_drafted", "spec_accepted", "prefix_lookups", "prefix_hits",
        "prefix_skipped_tokens")})
    if profile:
        prof = profile_tick(eng, cfg)
        print("serve tick profile: " + json.dumps(prof), flush=True)
        out.update(tick_ms_synthetic=prof["tick_ms"],
                   tick_device_busy_ms=prof["device_busy_ms"],
                   tick_idle_share=prof["idle_share"])
    print("serve: " + json.dumps(out), flush=True)
    return {"eng": eng, "prompts": prompts, "stats": out}


def _paged_logits(dev, cfg, params, prompt, gen, attn="flash",
                  kv_quant="") -> "torch.Tensor":
    """The paged path's f32 logits over prompt + gen[:-1]: chunked
    prefill, then one decode step per generated token (teacher-forced)
    through the engine's own functions, with the decode kernel when
    attn="flash"; rows (len(gen), vocab)."""
    import torch

    from shallowspeed_tpu_torch.serving.cache import (blocks_for,
                                                      init_block_pool)
    from shallowspeed_tpu_torch.serving.engine import (decode_logits,
                                                       prefill_chunk,
                                                       table_width)

    bs = SLICE["block_size"]
    nb = blocks_for(len(prompt) + len(gen) - 1, bs)
    pools = init_block_pool(cfg, nb + 1, bs, kv_quant, device=dev)
    bt = np.zeros((1, table_width(nb, 4)), np.int32)
    bt[0, :nb] = np.arange(1, nb + 1)
    bt = torch.from_numpy(bt).to(dev)
    for s in range(0, len(prompt), PREFILL_CHUNK):
        chunk = torch.from_numpy(prompt[s:s + PREFILL_CHUNK]).to(dev)
        last = prefill_chunk(params, pools, chunk, s, bt, cfg=cfg)
    rows = [last]
    for i in range(len(gen) - 1):
        rows.append(decode_logits(
            params, pools,
            torch.tensor([int(gen[i])], dtype=torch.int32, device=dev),
            torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev),
            bt, cfg=cfg, attn=attn)[0])
    return torch.stack(rows)


def _longest(prompts, n):
    return sorted(prompts, key=lambda r: len(prompts[r]))[-n:]


def _compare(label, got, ref, tol, above=False) -> float:
    """max |diff| / max |ref| of two logit stacks, printed; raises when
    it exceeds `tol` (or, with `above`, when it does not)."""
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"logits {label}: max_abs_err {err:.4e} rel {rel:.4e} "
          f"({'must exceed' if above else 'tol'} {tol}), argmax agreement "
          f"{agree:.3f}", flush=True)
    if tol is not None and (rel <= tol if above else not rel <= tol):
        raise AssertionError(f"logits {label}: rel {rel:.3e} "
                             f"{'<=' if above else '>'} {tol:g}")
    return rel


def check_logits(dev, cfg, params, prompts, results, tol, attn="flash",
                 n_requests=2, ref_params=None, tag="", rids=None) -> float:
    """Phase 4: for the longest requests (or `rids`), the paged path's
    logits (`_paged_logits`) against the plain full forward over the
    same tokens (over `ref_params`, default `params`), in cfg's compute
    dtype. Returns the worst max |diff| / max |ref|; raises when it
    exceeds `tol` (None: no bound). `tag` starts each printed label."""
    from shallowspeed_tpu_torch.models import transformer as T

    params = T.cast_params(params, cfg.compute_dtype)
    ref_params = params if ref_params is None else ref_params
    worst = 0.0
    for rid in rids or _longest(prompts, n_requests):
        prompt, gen = prompts[rid], results[rid]
        seq = np.concatenate([prompt, gen[:-1]]).astype(np.int32)
        got = _paged_logits(dev, cfg, params, prompt, gen, attn)
        ref = T.eval_forward(ref_params, _ids(seq, dev), cfg)[
            0, len(prompt) - 1:].float()
        label = (f"{tag}{str(cfg.act_dtype)[6:]} {attn} {rid} "
                 f"({len(prompt)} prompt + {len(gen) - 1} decoded)")
        worst = max(worst, _compare(label, got, ref, tol))
    return worst


def _ids(seq, dev):
    import torch

    return torch.from_numpy(seq).to(dev).long()[None]


def _bf(t):
    import torch

    return t.to(torch.bfloat16).to(t.dtype)


def check_f32_bound_catches_a_slip(dev, cfg32, params, prompts,
                                   results) -> None:
    """The f32 logits bound must catch a bf16 slip in the attention
    path: the gather path with q and the cached K rounded to bf16 before
    the scores (what a kernel that let bf16 into its f32 score path
    would compute) has to land above LOGITS_TOL_F32."""
    from shallowspeed_tpu_torch.serving import engine as E

    exact = E.masked_attention

    def slipped(q, cache_blk, valid):
        return exact(_bf(q), {"k": _bf(cache_blk["k"]), "v": cache_blk["v"]},
                     valid)

    E.masked_attention = slipped
    try:
        rel = check_logits(dev, cfg32, params, prompts, results, None,
                           attn="gather", n_requests=1)
    finally:
        E.masked_attention = exact
    if not rel > LOGITS_TOL_F32:
        raise AssertionError(f"a bf16 score slip moved the f32 logits by "
                             f"only {rel:.3e}: LOGITS_TOL_F32 cannot see it")


def check_int8_logits(dev, cfg32, params, prompts, results) -> dict:
    """Phase 4, int8 pools in f32 compute: the paged logits of the
    longest request with the int8 decode kernel against the gather path
    (`masked_attention` over the gathered int8 table) within
    LOGITS_TOL_F32; then the gather path with q and K's scale rounded to
    bf16 before the scores (a bf16 slip in an int8 score path) must land
    above it."""
    from shallowspeed_tpu_torch.serving import engine as E

    rid = _longest(prompts, 1)[0]
    prompt, gen = prompts[rid], results[rid]
    kern = _paged_logits(dev, cfg32, params, prompt, gen, "flash", "int8")
    plain = _paged_logits(dev, cfg32, params, prompt, gen, "gather", "int8")
    label = f"f32 int8 pools {rid}"
    rel = _compare(f"{label}, kernel vs gather", kern, plain, LOGITS_TOL_F32)
    exact = E.masked_attention

    def slipped(q, cache_blk, valid):
        return exact(_bf(q), dict(cache_blk, k_s=_bf(cache_blk["k_s"])),
                     valid)

    E.masked_attention = slipped
    try:
        slip = _paged_logits(dev, cfg32, params, prompt, gen, "gather",
                             "int8")
    finally:
        E.masked_attention = exact
    slip_rel = _compare(f"{label}, bf16 q/K-scale slip in the gather path "
                        f"vs kernel", slip, kern, LOGITS_TOL_F32, above=True)
    return {"rel": rel, "slip_rel": slip_rel}


def _dequantized(tree):
    """A `quantize_weights` tree with each dense back in f32 as
    {"W": Wq * Ws, "b"}."""
    if isinstance(tree, dict):
        if "Wq" in tree:
            rest = {k: v for k, v in tree.items() if k not in ("Wq", "Ws")}
            return {"W": tree["Wq"].float() * tree["Ws"], **rest}
        return {k: _dequantized(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dequantized(v) for v in tree]
    return tree


def check_quant_weight_logits(dev, cfg, params, prompts, results, mode,
                              tol) -> float:
    """Phase 4, `mode` ("int8" or "fp8") weights in cfg's compute dtype:
    the paged logits of the longest request against the plain forward
    over the dequantized weights (Wq * Ws in f32, which the plain
    forward casts to the compute dtype as it casts any weight), within
    `tol`."""
    from shallowspeed_tpu_torch.models import transformer as T

    qparams = T.quantize_weights(params, mode)
    return check_logits(dev, cfg, qparams, prompts, results, tol,
                        n_requests=1, ref_params=_dequantized(qparams),
                        tag=f"{mode} weights ")


def _prefix_prompts(vocab) -> dict:
    """Phase 3b's requests: one PREFIX_LEN-token prefix (numpy seed 5),
    ten requests that continue it with distinct tails of 64-256 tokens,
    and last in submission order two that are exactly the prefix."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, PREFIX_LEN).astype(np.int32)
    tails = rng.integers(64, 257, N_REQUESTS - 2)
    prompts = {f"p{i}": np.concatenate(
        [prefix, rng.integers(0, vocab, t).astype(np.int32)])
        for i, t in enumerate(tails)}
    for i in range(N_REQUESTS - 2, N_REQUESTS):
        prompts[f"p{i}"] = prefix.copy()
    return prompts


def _p50(xs):
    return float(np.median(xs)) if xs else None


def run_prefix(dev, cfg, cfg32, params) -> dict:
    """Phase 3b: the prefix cache at full width and depth in bf16 (hits,
    skipped tokens, K4 launches, the allocator with cold blocks, TTFT of
    hits against misses, one hit's logits against the plain forward),
    then in f32 at 2 layers with the cache on and off: the streams must
    be equal token for token."""
    prompts = _prefix_prompts(cfg.vocab)
    run = serve(dev, cfg, params, prompts=prompts, prefix_cache=True,
                profile=False, label="prefix")
    stats, eng = run["stats"], run["eng"]
    if not (stats["prefix_hits"] >= 1 and stats["prefix_skipped_tokens"] > 0):
        raise AssertionError(f"no prefix hits: {stats}")
    recs = {r["id"]: r for r in eng.request_records}
    hits = [rid for rid in prompts if recs[rid]["prefix_hit_blocks"] > 0]
    misses = [rid for rid in prompts if rid not in hits]
    full = [rid for rid in hits if len(prompts[rid]) == PREFIX_LEN]
    out = {"ticks": stats["ticks"], "launches": stats["launches"],
           "prefix_hits": stats["prefix_hits"],
           "prefix_skipped_tokens": stats["prefix_skipped_tokens"],
           "hits": hits, "full_aligned_hits": full,
           "ttft_ms_p50_hits": _p50([recs[r]["ttft_ms"] for r in hits]),
           "ttft_ms_p50_misses": _p50([recs[r]["ttft_ms"] for r in misses]),
           # hits queued for a slot; TTFT less the queue wait is prefill
           "admit_to_first_ms_p50_hits": _p50(
               [recs[r]["ttft_ms"] - recs[r]["wait_ms"] for r in hits]),
           "admit_to_first_ms_p50_misses": _p50(
               [recs[r]["ttft_ms"] - recs[r]["wait_ms"] for r in misses]),
           "prefill_chunks": stats["prefill_chunks"],
           "cold_blocks": stats["cold_blocks"],
           "blocks_free_at_drain": stats["blocks_free_at_drain"],
           "wall_s": stats["wall_s"], "tok_per_s": stats["tok_per_s"]}
    rid = (full or hits)[-1]
    out["logits_rel_bf16"] = check_logits(
        dev, cfg, params, prompts, eng.results, LOGITS_TOL_BF16,
        rids=[rid], tag="prefix hit ")
    del run, eng

    cfg2 = dataclasses.replace(cfg32, n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    streams = {}
    for on in (True, False):
        r = serve(dev, cfg2, params2, prompts=prompts, prefix_cache=on,
                  profile=False, label=f"prefix-f32-{'on' if on else 'off'}")
        streams[on] = r["eng"].results
        if on:
            out["f32_prefix_hits"] = r["stats"]["prefix_hits"]
        del r
    same = [rid for rid in prompts
            if np.array_equal(streams[True][rid], streams[False][rid])]
    out["f32_streams_equal"] = f"{len(same)}/{len(prompts)}"
    print("prefix: " + json.dumps(out), flush=True)
    if len(same) != len(prompts) or not out["f32_prefix_hits"]:
        raise AssertionError(f"f32 prefix-on streams differ from cache-off "
                             f"({out['f32_streams_equal']} equal, "
                             f"{out['f32_prefix_hits']} hits)")
    return out


def run_spec(dev, cfg, params) -> dict:
    """Phase 3c: SPEC_REQUESTS greedy motif requests on 8 slots, with
    spec_k 0 and SPEC_K; drafts must show and the streams must be equal
    token for token."""
    rng = np.random.default_rng(6)
    motif = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    lens = rng.integers(256, 1025, SPEC_REQUESTS)
    prompts = {f"s{i}": np.tile(motif, -(-n // 32))[:n]
               for i, n in enumerate(lens)}
    runs = {}
    for k in (0, SPEC_K):
        r = serve(dev, cfg, params, prompts=prompts, max_new=SPEC_NEW,
                  profile=False, label=f"spec-k{k}", spec_k=k)
        runs[k] = (r["stats"], r["eng"].results)
        del r
    (off, off_res), (on, on_res) = runs[0], runs[SPEC_K]
    same = [rid for rid in prompts
            if np.array_equal(on_res[rid], off_res[rid])]
    out = {"spec_k": SPEC_K, "spec_drafted": on["spec_drafted"],
           "spec_accepted": on["spec_accepted"],
           "accept_rate": (on["spec_accepted"] / on["spec_drafted"]
                           if on["spec_drafted"] else None),
           "ticks_spec": on["ticks"], "ticks_off": off["ticks"],
           "launches_spec": on["launches"], "streams_equal":
               f"{len(same)}/{len(prompts)}",
           "tok_per_s_spec": on["tok_per_s"], "tok_per_s_off":
               off["tok_per_s"], "prompt_lens": [int(n) for n in lens]}
    print("spec: " + json.dumps(out), flush=True)
    if not on["spec_drafted"] > 0 or len(same) != len(prompts):
        raise AssertionError(f"speculative decoding: {out}")
    return out


def _dequant_err(got, ref) -> float:
    """Worst |diff| / allowance of a bf16 `dequant_matmul` result
    against the exact product: one bf16 rounding of the result (2^-8
    |ref|) plus f32 summation-order noise (1e-5 of max |ref|)."""
    allow = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
    return float(((got.double() - ref).abs() / allow).max())


# dequant_matmul's checks: rows (the tick's 8, a prefill chunk, a ragged
# count) x (K, N) of the qkv dense and of the head
DEQUANT_ROWS = (8, 256, 300)
DEQUANT_SHAPES = {"qkv": (2048, 6144), "head": (2048, 32768)}
# the most one call at (8, 2048) @ (2048, 32768) may add to the peak of
# device memory (the old route's bf16 weight copy was 134 MB)
DEQUANT_PEAK_MB = 16


def _quant_weight(dev, k, n, mode, g):
    """A random (K, N) dense quantized by `transformer.quantize_weights`:
    (wq, ws)."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T

    w = torch.randn(k, n, device=dev, generator=g) / k ** 0.5
    q = T.quantize_weights({"W": w, "b": torch.zeros(n, device=dev)}, mode)
    return q["Wq"], q["Ws"]


def check_dequant_matmul(dev) -> float:
    """Phase 2: `dequant_matmul` on the card with int8 and fp8 weights.
    bf16 x takes the tensor-core GEMM with a 1-byte B
    (`_dequant_matmul_tc`, counted) at DEQUANT_ROWS x DEQUANT_SHAPES,
    against the exact (f64) product of the same leaves (`_dequant_err`);
    a bf16 rounding of the sum before the scale, the fault the f32
    accumulator exists to avoid, must exceed that allowance. f32 x takes
    the f32-FMA kernel (`_dequant_matmul_fma`, counted), against the
    exact product within the f32 summation bound K 2^-24 (|x| @ |wq|)
    ws plus one f32 rounding. The peak memory one call at (8, 2048) @
    (2048, 32768) adds stays under DEQUANT_PEAK_MB. Returns max |kernel
    - plain| at the head shape with 8 rows and int8 weights."""
    import torch

    from shallowspeed_tpu_torch.ops import matmul as MM

    g = torch.Generator(device=dev).manual_seed(6)
    counters = (MM._dequant_matmul_tc, MM._dequant_matmul_fma)
    before = [c.launches for c in counters]
    worst = None
    for mode in ("int8", "fp8"):
        for shape, (k, n) in DEQUANT_SHAPES.items():
            wq, ws = _quant_weight(dev, k, n, mode, g)
            exact_w = wq.double()
            for m in DEQUANT_ROWS:
                x = torch.randn(1, m, k, device=dev, generator=g).bfloat16()
                n_tc = MM._dequant_matmul_tc.launches
                got = MM.dequant_matmul(x, wq, ws)
                torch.cuda.synchronize()
                if MM._dequant_matmul_tc.launches != n_tc + 1:
                    raise AssertionError("bf16 dequant_matmul did not launch "
                                         "the tensor-core GEMM")
                ref = (x[0].double() @ exact_w) * ws.double()
                slip = ((x[0].float() @ wq.float()).bfloat16().float()
                        * ws).bfloat16()
                ratio = _dequant_err(got[0], ref)
                slip_ratio = _dequant_err(slip, ref)
                print(f"check dequant_matmul {mode} bf16 {shape} "
                      f"({m},{k})@({k},{n}): worst element at {ratio:.3e} "
                      f"of its allowance; a bf16 rounding before the scale "
                      f"at {slip_ratio:.3e} (must exceed 1)", flush=True)
                if not (got.dtype == torch.bfloat16 and got.shape == (1, m, n)
                        and ratio <= 1.0):
                    raise AssertionError(f"dequant_matmul {mode} {shape} "
                                         f"M={m}: {got.dtype}, an element "
                                         f"off by {ratio:.3e} x its "
                                         f"allowance")
                if not slip_ratio > 1.0:
                    raise AssertionError(f"dequant_matmul {mode}: a bf16 "
                                         f"rounding before the scale stays "
                                         f"within the allowance "
                                         f"({slip_ratio:.3e})")
                if mode == "int8" and shape == "head" and m == 8:
                    plain = MM.dequant_matmul_reference(x, wq, ws)
                    worst = float((got.float() - plain.float()).abs().max())
            # the f32 route (the f32 logits checks)
            x = torch.randn(DEQUANT_ROWS[0], k, device=dev, generator=g)
            n_fma = MM._dequant_matmul_fma.launches
            got = MM.dequant_matmul(x, wq, ws)
            torch.cuda.synchronize()
            if MM._dequant_matmul_fma.launches != n_fma + 1:
                raise AssertionError("f32 dequant_matmul did not launch the "
                                     "f32-FMA kernel")
            xd = x.double()
            ref = (xd @ exact_w) * ws.double()
            allow = (k * 2.0 ** -24 * (xd.abs() @ exact_w.abs())
                     * ws.double() + 2.0 ** -24 * ref.abs())
            ratio = float(((got.double() - ref).abs() / allow).max())
            print(f"check dequant_matmul {mode} f32 {shape}: worst element "
                  f"at {ratio:.3e} of its allowance", flush=True)
            if not (got.dtype == torch.float32 and ratio <= 1.0):
                raise AssertionError(f"f32 dequant_matmul {mode} {shape}: "
                                     f"{ratio:.3e} x the allowance")
            del wq, ws, exact_w, x, got, ref
    # peak memory one call adds at the head's shape, 8 rows
    wq, ws = _quant_weight(dev, 2048, 32768, "int8", g)
    x = torch.randn(8, 2048, device=dev, generator=g).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = MM.dequant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    added = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    print(f"check dequant_matmul peak: one call at (8,2048)@(2048,32768) "
          f"int8 adds {added:.3f} MiB to the peak (must stay under "
          f"{DEQUANT_PEAK_MB}; output {out.numel() * 2 / 2 ** 20:.3f} MiB)",
          flush=True)
    if not added < DEQUANT_PEAK_MB:
        raise AssertionError(f"dequant_matmul added {added:.1f} MiB")
    for c, n in zip(counters, before):
        c.launches = n                      # check launches do not count
    torch.cuda.empty_cache()
    return worst


def _k5_ratio(got, x, y) -> tuple[float, float]:
    """(max |got - exact|, worst |got - exact| / allowance) per element,
    the exact product in f64 on the card (a check only): one rounding
    of got's dtype (2^-8 |ref| for bf16, 0 for f32) plus an f32
    summation bound K 2^-24 (|x| @ |y|)."""
    import torch

    xd, yd = x.double(), y.double()
    ref = xd @ yd
    allow = x.shape[1] * 2.0 ** -24 * (xd.abs() @ yd.abs())
    if got.dtype == torch.bfloat16:
        allow += 2.0 ** -8 * ref.abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("blocked_matmul gave non-finite values")
    diff = (got.double() - ref).abs()
    return float(diff.max()), float((diff / allow).max())


def check_blocked_matmul(dev) -> float:
    """Phase 2: K5 and its plain version against the f64 product
    (`_k5_ratio`, each at most 1): at the JAX test's shapes and blocks
    in f32, bf16, and bf16 in with f32 out, at an unaligned bf16 shape
    (K 100), and at the probe's six shapes (M 16384, bf16, its blocks).
    Each call must count on the build `blocked_matmul_route` picks: bf16
    at aligned shapes the tensor-core `_blocked_matmul_tc`, the rest the
    f32-FMA `blocked_matmul`. Then the plain arithmetic with the
    accumulator rounded to bf16 between k-slices must exceed the rule.
    Returns max |kernel - plain| at K5_SHAPE."""
    import torch

    from shallowspeed_tpu_torch.bench_matmul import SHAPES
    from shallowspeed_tpu_torch.ops.matmul import (_blocked_matmul_tc,
                                                   blocked_matmul,
                                                   blocked_matmul_reference,
                                                   blocked_matmul_route)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((256, 128, 384), dict(bm=64, bk=32, bn=128), dt, od)
             for dt, od in ((f32, None), (bf16, None), (bf16, f32))]
    cases += [((256, 128, 384), dict(bm=128, bk=128, bn=384), dt, od)
              for dt, od in ((f32, None), (bf16, None), (bf16, f32))]
    cases += [((256, 100, 384), dict(bm=64, bk=100, bn=128), bf16, None)]
    cases += [((K5_SHAPE[0], k, n), dict(bm=512, bk=min(1024, k), bn=1024),
               bf16, None) for k, n in SHAPES]
    g = torch.Generator(device=dev).manual_seed(9)
    worst = None
    counters = {"tc": _blocked_matmul_tc, "fma": blocked_matmul}
    before = {r: c.launches for r, c in counters.items()}
    for (m, k, n), blocks, dt, od in cases:
        x = torch.randn(m, k, device=dev, generator=g).to(dt)
        y = torch.randn(k, n, device=dev, generator=g).to(dt)
        route = blocked_matmul_route(dt, dt, k, n)
        n0 = counters[route].launches
        got = blocked_matmul(x, y, out_dtype=od, **blocks)
        torch.cuda.synchronize()
        if counters[route].launches != n0 + 1:
            raise AssertionError(f"blocked_matmul ({m},{k})@({k},{n}) "
                                 f"{dt} did not launch its {route} build")
        plain = blocked_matmul_reference(x, y, out_dtype=od, **blocks)
        err, ratio = _k5_ratio(got, x, y)
        p_err, p_ratio = _k5_ratio(plain, x, y)
        label = (f"({m},{k})@({k},{n}) {str(dt)[6:]}->{str(got.dtype)[6:]} "
                 f"blocks {tuple(blocks.values())} [{route}]")
        print(f"check blocked_matmul {label}: max_abs_err {err:.3e}, worst "
              f"element at {ratio:.3e} of its allowance (plain "
              f"{p_ratio:.3e})", flush=True)
        if got.dtype != (od or dt) or not (ratio <= 1.0 and p_ratio <= 1.0):
            raise AssertionError(f"blocked_matmul {label}: kernel {ratio:.3e}"
                                 f", plain {p_ratio:.3e} x the allowance")
        if (m, k, n) == K5_SHAPE:
            worst = float((got.float() - plain.float()).abs().max())
        del x, y, got, plain
    for r, c in counters.items():
        c.launches = before[r]              # check launches do not count
    for (m, k, n), bk in (((256, 128, 384), 32), (K5_SHAPE, 128)):
        x = torch.randn(m, k, device=dev, generator=g).to(bf16)
        y = torch.randn(k, n, device=dev, generator=g).to(bf16)
        acc = torch.zeros(m, n, device=dev)
        for k0 in range(0, k, bk):
            acc = (acc + x[:, k0:k0 + bk].float() @ y[k0:k0 + bk].float()
                   ).to(bf16).float()
        _, ratio = _k5_ratio(acc.to(bf16), x, y)
        print(f"check blocked_matmul ({m},{k})@({k},{n}): a bf16 "
              f"accumulator between {bk}-wide k-slices at {ratio:.3e} of "
              f"the allowance (must exceed 1)", flush=True)
        if not ratio > 1.0:
            raise AssertionError("a bf16 accumulator stays within the K5 "
                                 f"rule ({ratio:.3e})")
    torch.cuda.empty_cache()
    return worst


def run_probe() -> dict:
    """Phase 2b: the narrow-K probe through its entry point at M 16384,
    PROBE_ITERS calls a chain. K5's counts are zeroed just before; its
    tensor-core build must launch shapes x 4 chains (one warm-up, three
    timed) x PROBE_ITERS times after (the probe's shapes are bf16 and
    aligned), its f32-FMA build never; every record must carry a
    positive rate and no error."""
    from shallowspeed_tpu_torch import bench_matmul
    from shallowspeed_tpu_torch.ops.matmul import (_blocked_matmul_tc,
                                                   blocked_matmul)

    blocked_matmul.launches = _blocked_matmul_tc.launches = 0
    records = bench_matmul.main(["--iters", str(PROBE_ITERS)])
    launches = _blocked_matmul_tc.launches
    want = len(bench_matmul.SHAPES) * 4 * PROBE_ITERS
    if launches != want or blocked_matmul.launches:
        raise AssertionError(f"the probe launched K5's tensor-core build "
                             f"{launches} times (want {want}) and its FMA "
                             f"build {blocked_matmul.launches} (want 0)")
    variants = [r["variant"] for r in records]
    if (len(records) != 2 * len(bench_matmul.SHAPES)
            or set(variants) != {"torch", "blocked"}
            or not all(r["error"] is None and r["tflops"] > 0
                       for r in records)):
        raise AssertionError(f"bad probe records: {records}")
    return {"launches": launches, "records": records}


def time_blocked_matmul(dev) -> dict:
    """Phase 5: K5 (its tensor-core build) at K5_SHAPE in bf16 with the
    probe's blocks, beside its plain version, `torch.matmul` (the library yardstick, which the
    port never calls in K5's place) and its bound, on two input sets
    (each output alone is over the 50 MB L2)."""
    import torch

    from shallowspeed_tpu_torch.ops.matmul import (_blocked_matmul_tc,
                                                   blocked_matmul,
                                                   blocked_matmul_reference)

    m, k, n = K5_SHAPE
    g = torch.Generator(device=dev).manual_seed(10)
    sets = [(torch.randn(m, k, device=dev, generator=g).bfloat16(),
             torch.randn(k, n, device=dev, generator=g).bfloat16())
            for _ in range(2)]
    before = _blocked_matmul_tc.launches
    out = {"ms": _time_ms(partial(blocked_matmul, **K5_BLOCKS), sets),
           "plain_ms": _time_ms(partial(blocked_matmul_reference,
                                        **K5_BLOCKS), sets),
           "library_ms": _time_ms(torch.matmul, sets)}
    if _blocked_matmul_tc.launches == before:
        raise AssertionError("the timed K5 calls did not reach the "
                             "tensor-core build")
    _blocked_matmul_tc.launches = before    # timing launches do not count
    flops = 2.0 * m * n * k
    nbytes = 2 * (m * k + k * n + m * n)    # bf16 x, y read; out written
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    out.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               tflops=flops / (out["ms"] * 1e-3) / 1e12,
               library_tflops=flops / (out["library_ms"] * 1e-3) / 1e12,
               shape=[m, k, n])
    print("time blocked_matmul: " + json.dumps(out), flush=True)
    return out


def time_kernels(dev, stats) -> dict:
    """Phase 5: K4 over float (bf16) and int8 pools at the serving
    shapes — S=8 slots, 16 heads, hd 128, bs 16, bf16 q, a table bucket
    of the longest request, positions like the traffic's (a prompt plus
    half the new tokens) — on 16 input sets, one per layer, as a tick
    reads them, beside the plain version, one library call (SDPA over
    the gathered table; for int8 pools over the gathered table
    dequantized to bf16 beforehand, outside the timed call) and the
    bound; the kernel's and the library call's times by events and, per
    call, on the device (the profiler)."""
    import torch
    import torch.nn.functional as F

    from shallowspeed_tpu_torch.ops.flash_attention import (
        _paged_flash_decode_int8, _sm_count, decode_splits,
        paged_flash_decode, paged_flash_decode_reference)
    from shallowspeed_tpu_torch.serving.cache import gather_table
    from shallowspeed_tpu_torch.serving.engine import table_width

    bs, hkv, hd = SLICE["block_size"], SLICE["kv_heads"], SLICE["head_dim"]
    s, h = SLICE["slots"], SLICE["heads"]
    rng = np.random.default_rng(2)
    pos = rng.integers(128, 1025, s) + MAX_NEW // 2
    # the bucket of the longest request, wide enough for every position
    width = table_width(max(stats["max_table_blocks"],
                            int(pos.max()) // bs + 1), 4)
    out = {}
    for name, kvq in (("paged_flash_decode", ""),
                      ("paged_flash_decode_int8", "int8")):
        sets = [_decode_inputs(rng, dev, torch.bfloat16, width=width,
                               pos=pos, kv_quant=kvq,
                               **{k: SLICE[k] for k in SLICE})
                for _ in range(16)]
        counts = (paged_flash_decode.launches,
                  _paged_flash_decode_int8.launches)

        def kern(q, pool, bt, p, w):
            paged_flash_decode(q, pool, bt, p, window=w)

        def plain(q, pool, bt, p, w):
            paged_flash_decode_reference(q, pool, bt, p, window=w)

        lib_sets = []
        for q, pool, bt, p, _ in sets:
            view = gather_table(pool, bt)
            if kvq:
                k = (view["k"].float() * view["k_s"]).to(torch.bfloat16)
                v = (view["v"].float() * view["v_s"]).to(torch.bfloat16)
            else:
                k, v = view["k"], view["v"]
            mask = (torch.arange(width * bs, device=dev)[None, :]
                    <= p.long()[:, None])[:, None, None, :]
            lib_sets.append((q[:, :, None], k, v, mask))

        def library(q, k, v, mask):
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        ms = _time_ms(kern, sets)
        plain_ms = _time_ms(plain, sets)
        library_ms = _time_ms(library, lib_sets)
        # device time a call, from the profiler: the event times above
        # include the wrapper's host work between these short calls
        device = {}
        for key, fn, args in (("device_ms", kern, sets),
                              ("library_device_ms", library, lib_sets)):
            prof = _profiled(lambda: [fn(*a) for a in args], [])
            device[key] = (prof["device_busy_ms"] / len(args)
                           if prof["device_busy_ms"] is not None else None)
        # timing launches do not count
        paged_flash_decode.launches, _paged_flash_decode_int8.launches = \
            counts

        # least time for one call: each input read once, the output
        # written once; K/V (and int8 scales) over the live blocks this
        # call's positions need
        live = int(sum(p // bs + 1 for p in pos[:-1])) + 1   # + scratch
        per_block = 2 * hkv * bs * (hd + 4 if kvq else 2 * hd)
        nbytes = (live * per_block                            # live K/V
                  + 2 * s * h * hd * 2                        # q, out
                  + s * width * 4 + s * 4)                    # bt, pos
        n_pos = int(sum(p + 1 for p in pos[:-1])) + 1         # + scratch
        flops = 4 * h * hd * n_pos                            # QK and PV
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        out[name] = {"ms": ms, "device_ms": device["device_ms"],
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_device_ms": device["library_device_ms"],
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "width": width,
                     "splits": decode_splits(s, hkv, width,
                                             _sm_count(dev)),
                     "live_kv_bytes": live * per_block}
        print(f"time {name}: " + json.dumps(out[name]), flush=True)
    out["sweep"] = _decode_sweep(dev)
    return out


def _decode_sweep(dev) -> list:
    """Phase 5: K4's device time a call against the live length, every
    row (but the scratch row) at one position over a 128-column table,
    at the serving shapes: its split and merge kernels apart, and the
    split kernel's rate over the live K/V bytes (the fixed cost and the
    per-byte rate of the design)."""
    import torch

    from shallowspeed_tpu_torch.ops.flash_attention import (
        _paged_flash_decode_int8, paged_flash_decode)

    bs, hkv, hd = SLICE["block_size"], SLICE["kv_heads"], SLICE["head_dim"]
    s = SLICE["slots"]
    rng = np.random.default_rng(3)
    groups = [("merge", ("paged_decode_combine",)),
              ("split", ("paged_decode_kernel",))]
    counts = (paged_flash_decode.launches, _paged_flash_decode_int8.launches)
    rows = []
    for pools, kvq in (("bf16", ""), ("int8", "int8")):
        per_block = 2 * hkv * bs * (hd + 4 if kvq else 2 * hd)
        for n_pos in (16, 256, 1024, 2048):
            sets = [_decode_inputs(rng, dev, torch.bfloat16, width=128,
                                   pos=np.full(s, n_pos - 1), kv_quant=kvq,
                                   **SLICE) for _ in range(8)]
            for q, pool, bt, p, w in sets[:2]:
                paged_flash_decode(q, pool, bt, p, window=w)
            prof = _profiled(lambda: [paged_flash_decode(q, pool, bt, p,
                                                         window=w)
                                      for q, pool, bt, p, w in sets],
                             groups)
            if prof["device_ms"] is None:
                raise AssertionError("the profiler saw no device time")
            split = prof["device_ms"]["split"] / len(sets)
            live = (s - 1) * ((n_pos - 1) // bs + 1) + 1      # + scratch
            row = {"pools": pools, "positions": n_pos,
                   "split_ms": split,
                   "merge_ms": prof["device_ms"]["merge"] / len(sets),
                   "split_gb_per_s": live * per_block / (split * 1e-3)
                   / 1e9}
            rows.append(row)
            print("time paged_flash_decode sweep: " + json.dumps(row),
                  flush=True)
            del sets
    paged_flash_decode.launches, _paged_flash_decode_int8.launches = counts
    torch.cuda.empty_cache()
    return rows


# the dense shapes of one decode tick of the 1.21B LM, (K, N) with their
# calls a tick (16 layers; the head once), at the tick's 8 rows
TICK_DENSE = {"qkv": ((2048, 6144), 16), "proj": ((2048, 2048), 16),
              "gate": ((2048, 8192), 16), "up": ((2048, 8192), 16),
              "down": ((8192, 2048), 16), "head": ((2048, 32768), 1)}


def time_dequant_matmul(dev) -> dict:
    """Phase 5: `dequant_matmul` (int8 weights, bf16 x, the tensor-core
    route) at each dense shape of a decode tick with its 8 rows, cycling
    through enough distinct weights that the 50 MB L2 holds none of
    them, beside its plain version, the library yardstick (`torch.mm`
    with an f32 output on the weight dequantized to bf16 before the
    timing starts, which the port never calls) and its bound: the
    1-byte weight (plus x, ws and the output) once at 3.35 TB/s. Also
    the sums over one tick's calls. Returns {shape: numbers, "tick":
    sums}."""
    import torch

    from shallowspeed_tpu_torch.ops import matmul as MM

    g = torch.Generator(device=dev).manual_seed(11)
    m = SLICE["slots"]
    before = MM._dequant_matmul_tc.launches
    out, tick = {}, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "device_ms": 0.0, "library_device_ms": 0.0}
    for name, ((k, n), calls) in TICK_DENSE.items():
        n_sets = max(2, -(-150 * 2 ** 20 // (k * n)))
        sets = [(torch.randn(m, k, device=dev, generator=g).bfloat16(),
                 *_quant_weight(dev, k, n, "int8", g))
                for _ in range(n_sets)]
        lib = [(x, wq.to(torch.bfloat16)) for x, wq, _ in sets]

        def library(x, w):
            torch.mm(x, w, out_dtype=torch.float32)

        row = {"ms": _time_ms(MM.dequant_matmul, sets),
               "plain_ms": _time_ms(MM.dequant_matmul_reference, sets),
               "library_ms": _time_ms(library, lib)}
        # device time a call (the event times above include the host's
        # launch gaps between these short calls), from the profiler
        for key, fn, args in (("device_ms", MM.dequant_matmul, sets),
                              ("library_device_ms", library, lib)):
            prof = _profiled(lambda: [fn(*a) for a in args], [])
            row[key] = (prof["device_busy_ms"] / len(args)
                        if prof["device_busy_ms"] is not None else None)
        nbytes = k * n + m * k * 2 + n * 4 + m * n * 2
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2.0 * m * k * n / BF16_FLOPS_PER_S
        row.update(bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   shape=[m, k, n], splits=MM.tc_splits(m, n, k),
                   weight_gb_per_s=k * n / (row["ms"] * 1e-3) / 1e9)
        out[name] = row
        for key in tick:
            tick[key] += calls * (row[key] or 0.0)
        print(f"time dequant_matmul {name}: " + json.dumps(row), flush=True)
        del sets, lib
    if MM._dequant_matmul_tc.launches == before:
        raise AssertionError("the timed dequant_matmul calls did not reach "
                             "the tensor-core route")
    MM._dequant_matmul_tc.launches = before   # timing launches do not count
    out["tick"] = tick
    print("time dequant_matmul, one tick's calls: " + json.dumps(tick),
          flush=True)
    torch.cuda.empty_cache()
    return out


def run_generate(dev, cfg, params) -> dict:
    """Phase 5b: the contiguous `generate()` over GEN_BATCH prompts of
    GEN_PROMPT tokens, GEN_NEW greedy tokens, with K1 prefill
    (`flash_prefill_at=GEN_PROMPT`), for a bf16 and an int8 cache. K1
    (its bf16 build, on tensor cores) must launch once per layer (the
    prefill), the decode kernels never;
    every token must lie in the vocabulary."""
    import torch

    from shallowspeed_tpu_torch.models.generate import (decode_report,
                                                        generate,
                                                        prompt_bucket_len)
    from shallowspeed_tpu_torch.ops import flash_attention as FA

    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)).astype(
        np.int32)
    cache_len = prompt_bucket_len(GEN_PROMPT, GEN_NEW, cfg.max_seq) + GEN_NEW
    out = {}
    for kvq in ("", "int8"):
        torch.cuda.reset_peak_memory_stats(dev)
        kernels = (FA._flash_fwd_tc, FA.paged_flash_decode,
                   FA._paged_flash_decode_int8)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(params, prompt, cfg, GEN_NEW, temperature=0.0,
                        kv_quant=kvq, flash_prefill_at=GEN_PROMPT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = [k.launches for k in kernels]
        if launches != [cfg.n_layers, 0, 0]:
            raise AssertionError(f"generate(kv_quant={kvq!r}) launched "
                                 f"K1, K4, K4 int8 {launches} times, want "
                                 f"[{cfg.n_layers}, 0, 0]")
        if toks.shape != (GEN_BATCH, GEN_NEW) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"generate(kv_quant={kvq!r}) gave "
                                 f"{toks.shape} tokens in "
                                 f"[{toks.min()}, {toks.max()}]")
        rep = decode_report(params, cfg, GEN_BATCH, cache_len, GEN_NEW, dt,
                            kv_quant=kvq)
        out[kvq or "bf16"] = dict(rep, seconds=dt, k1_launches=launches[0],
                                  peak_mem_gb=torch.cuda.max_memory_allocated(
                                      dev) / 1e9)
        print(f"generate kv_quant={kvq or 'bf16'} (includes the prefill): "
              + json.dumps(out[kvq or "bf16"]), flush=True)
    return out


# (B, Tq, Tk, H, Hkv, D, causal, window, rel), the dtypes checked, and
# whether q, k, v are strided slices of one fused (B, T, H, 3, D)
# tensor, as the model's `_qkv` makes them on the training path
TRAIN_KERNEL_CASES = [
    ("small-mha", (2, 256, 256, 4, 4, 64, True, 0, 0), ("f32", "bf16"),
     False),
    ("small-gqa", (2, 256, 256, 16, 4, 128, True, 0, 0), ("f32", "bf16"),
     False),
    ("small-window", (2, 256, 256, 4, 4, 64, True, 96, 0), ("f32", "bf16"),
     False),
    ("rel-causal", (1, 128, 320, 8, 4, 128, True, 0, 192), ("f32", "bf16"),
     False),
    ("ragged-T", (2, 200, 200, 4, 4, 128, True, 0, 0), ("f32", "bf16"),
     False),
    ("slice", (TRAIN_BATCH, 2048, 2048, 16, 16, 128, True, 0, 0), ("bf16",),
     False),
    ("slice-fused", (TRAIN_BATCH, 2048, 2048, 16, 16, 128, True, 0, 0),
     ("bf16",), True),
    # a pipeline stage's calls (phases 14 and 15): one-row microbatches
    # (a stage's, and a vpp chunk's), a tp cell's half of the heads, an
    # sp tile of a ring-flash hop on and off the diagonal (K2 and K3 as
    # the hop calls them; its K1, the f32-output build, is phase 12a's
    # RING_HOP_CASES), and an ulysses-flash cell's gathered head group
    ("stage", (1, 2048, 2048, 16, 16, 128, True, 0, 0), ("bf16",), True),
    ("stage-tp2", (1, 2048, 2048, 8, 8, 128, True, 0, 0), ("bf16",),
     True),
    ("sp-tile", (1, 1024, 1024, 16, 16, 128, True, 0, 0), ("bf16",), True),
    ("sp-tile-rel", (1, 1024, 1024, 16, 16, 128, True, 0, 1024), ("bf16",),
     True),
    ("ulysses-group", (1, 2048, 2048, 8, 8, 128, True, 0, 0), ("bf16",),
     False),
]
# Kernel vs plain, per element: `flash_attention.kernel_ratio`'s rule
# (KERNEL_TOL (|ref| + mean |ref|), + BF16_ULP |ref| for o in bf16, + for
# the bf16 builds of K1 and K3 the `tc_rounding_terms` of their one
# rounding of P or dS to bf16). lse: max |diff| / max |ref| over the rows
# that see a key, within LSE_TOL. PERF.md has the measurements.
LSE_TOL = 1e-5
# the names of the bf16 (tensor-core) builds of K1, K2 and K3, which the
# main path runs, in the kernels line
TC_NAMES = {"flash_fwd": "flash_fwd_tc", "flash_dq": "flash_dq_tc",
            "flash_dkv": "flash_dkv_tc"}


def _train_kernel_inputs(dev, dtype, shape, seed, fused=False):
    """Random q, k, v, dO on the card for a (B, Tq, Tk, H, Hkv, D) case;
    with `fused`, q, k, v are the strided views [..., i, :] of one
    (B, T, H, 3, D) tensor (needs Tq == Tk and H == Hkv)."""
    import torch

    b, tq, tk, h, hkv, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sz):
        return torch.randn(*sz, device=dev, generator=g).to(dtype)

    if fused:
        qkv = rnd(b, tq, h, 3, d)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        if q.is_contiguous() or k.is_contiguous() or v.is_contiguous():
            raise AssertionError("fused q, k, v are not strided views")
        return q, k, v, rnd(b, tq, h, d)
    return rnd(b, tq, h, d), rnd(b, tk, hkv, d), rnd(b, tk, hkv, d), \
        rnd(b, tq, h, d)


def _lse_err(lse, lse_ref) -> float:
    """max |diff| / max |ref| of lse over the rows that see a key; the
    kernel must mark the same rows as seeing nothing (lse -1e30)."""
    import torch

    seen = lse_ref > -1e29
    if not torch.equal(lse > -1e29, seen):
        raise AssertionError("the kernel and the plain version disagree on "
                             "which rows see a key")
    return float((lse[seen] - lse_ref[seen]).abs().max()
                 / lse_ref[seen].abs().max().clamp_min(1e-6))


def check_train_kernels(dev) -> dict:
    """Phase 2: K1, K2, K3 against their plain versions, per element
    under `FA.kernel_ratio`'s rule, the bf16 builds (tensor cores) with
    their `FA.tc_rounding_terms`; lse within LSE_TOL. Each call must
    count on the launcher its dtype selects (bf16: the tensor-core
    kernels). On the bf16 cases the plain version with P and dS rounded
    to float8_e4m3fn must fail the rule (o, dQ and dK). Returns the max
    |diff| of each kernel over the slice-shape cases."""
    import torch

    from shallowspeed_tpu_torch.ops import flash_attention as FA

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {}
    for ci, (name, case, dnames, fused) in enumerate(TRAIN_KERNEL_CASES):
        *shape, causal, window, rel = case
        kw = dict(causal=causal, window=window, rel=rel)
        for dn in dnames:
            bf = dn == "bf16"
            q, k, v, do = _train_kernel_inputs(dev, dtypes[dn], shape, ci,
                                               fused)
            counters = ((FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
                        if bf else (FA.flash_fwd, FA.flash_dq, FA.flash_dkv))
            before = [c.launches for c in counters]
            o, lse = FA.flash_fwd(q, k, v, **kw)
            delta = FA.attention_delta(do, o)
            dq = FA.flash_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = FA.flash_dkv(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            if [c.launches - n for c, n in zip(counters, before)] != [1] * 3:
                raise AssertionError(f"{name} {dn}: the calls did not launch "
                                     f"{[c.__name__ for c in counters]}")
            o_ref, lse_ref = FA.flash_fwd_reference(q, k, v, **kw)
            dq_ref = FA.flash_dq_reference(q, k, v, do, lse, delta, **kw)
            dk_ref, dv_ref = FA.flash_dkv_reference(q, k, v, do, lse, delta,
                                                    **kw)
            terms = (FA.tc_rounding_terms(q, k, v, do, lse, delta, **kw)
                     if bf else {})
            errs = {"flash_fwd": [FA.kernel_ratio(o, o_ref, rounded=bf,
                                                  extra=terms.get("o"))],
                    "flash_dq": [FA.kernel_ratio(dq, dq_ref,
                                                 extra=terms.get("dq"))],
                    "flash_dkv": [FA.kernel_ratio(dk, dk_ref,
                                                  extra=terms.get("dk")),
                                  FA.kernel_ratio(dv, dv_ref,
                                                  extra=terms.get("dv"))]}
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (o, lse, dq, dk, dv))
            lse_rel = _lse_err(lse, lse_ref)
            print(f"check flash_fwd lse {name} {dn}: rel {lse_rel:.3e} (tol "
                  f"{LSE_TOL:g})", flush=True)
            if not lse_rel <= LSE_TOL:
                raise AssertionError(f"lse {name} {dn}: rel err {lse_rel:.3e}")
            for kern, pairs in errs.items():
                err = max(e for e, _ in pairs)
                ratios = ", ".join(f"{r:.3e}" for _, r in pairs)
                print(f"check {kern} {name} {dn}: max_abs_err {err:.3e}, "
                      f"worst element at {ratios} of its allowance",
                      flush=True)
                if not (max(r for _, r in pairs) <= 1.0 and finite):
                    raise AssertionError(f"{kern} {name} {dn}: an element "
                                         f"off by {ratios} x its allowance "
                                         f"(finite: {finite})")
                if name.startswith("slice"):     # bf16: on tensor cores
                    key = TC_NAMES.get(kern, kern)
                    worst[key] = max(worst.get(key, 0.0), err)
            if bf:
                s_o, s_dq, s_dk, _ = FA.rounded_reference(
                    q, k, v, do, lse, delta, torch.float8_e4m3fn, **kw)
                slip = (FA.kernel_ratio(s_o, o_ref, rounded=True,
                                        extra=terms["o"])[1],
                        FA.kernel_ratio(s_dq, dq_ref, extra=terms["dq"])[1],
                        FA.kernel_ratio(s_dk, dk_ref, extra=terms["dk"])[1])
                print(f"check e4m3 slip {name}: o at {slip[0]:.3e}, dQ at "
                      f"{slip[1]:.3e}, dK at {slip[2]:.3e} of the allowance "
                      f"(must exceed 1)", flush=True)
                if not min(slip) > 1.0:
                    raise AssertionError(f"an e4m3 rounding of P / dS stays "
                                         f"within the rule on {name}: {slip}")
                del s_o, s_dq, s_dk, terms
            del o_ref, lse_ref, dq_ref, dk_ref, dv_ref
            torch.cuda.empty_cache()
    return worst


def _train_batch(cfg):
    """The repeated training batch: (TRAIN_BATCH, max_seq) next-token
    pairs of random ids, numpy seed 3."""
    rng = np.random.default_rng(3)
    seq = rng.integers(0, cfg.vocab, (TRAIN_BATCH, cfg.max_seq + 1))
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def train(dev, cfg, np_params) -> dict:
    """Phase 6: train the 1.21B LM through the kernels. The warm-up
    step's loss (at the initial weights) is checked against the plain
    attention's no-grad loss on the same weights and batch."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.ops import flash_attention as FA
    from shallowspeed_tpu_torch.ops.attention import attention
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    tok, tgt = _train_batch(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ContextParallelEngine(cfg, AdamW(3e-4, weight_decay=0.01,
                                           grad_clip=1.0),
                                attn="flash", device=dev, params=np_params)
    with torch.no_grad():
        plain = float(T.loss(eng.params, torch.from_numpy(tok).to(dev),
                             torch.from_numpy(tgt).to(dev), cfg,
                             attn_fn=partial(attention, causal=True,
                                             window=cfg.attn_window)))
    t0 = time.perf_counter()
    warm = eng.train_batch(tok, tgt)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    loss_rel = abs(warm - plain) / abs(plain)
    print(f"train loss at init, bf16: kernels {warm:.6f} plain {plain:.6f} "
          f"rel {loss_rel:.3e} (tol {LOSS_TOL_BF16:g})", flush=True)
    if not loss_rel <= LOSS_TOL_BF16:
        raise AssertionError(f"kernel loss off the plain loss by "
                             f"{loss_rel:.3e} > {LOSS_TOL_BF16:g}")

    # the bf16 step runs the tensor-core builds of K1, K2 and K3; their
    # f32-FMA builds must stay idle
    kernels = (FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
    idle = (FA.flash_fwd, FA.flash_dq, FA.flash_dkv)
    for k in kernels + idle:
        k.launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {k.__name__.lstrip("_"): k.launches for k in kernels}
    for name, n in launches.items():
        if n != cfg.n_layers * TRAIN_STEPS:
            raise AssertionError(f"{name} launched {n} times over "
                                 f"{TRAIN_STEPS} steps of {cfg.n_layers} "
                                 f"layers")
    if any(k.launches for k in idle):
        raise AssertionError(f"the f32-FMA builds ran in a bf16 step: "
                             f"{[k.launches for k in idle]}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {losses}")
    p50 = float(np.median(step_s))
    tok_s = TRAIN_BATCH * cfg.max_seq / p50
    perf = mfu(tok_s, cfg, cfg.max_seq, "bf16", device=dev)
    profile = profile_step(eng, tok, tgt)
    out = {"steps": TRAIN_STEPS, "losses": [warm] + losses,
           "warmup_step_s": warm_s, "step_ms": [1e3 * x for x in step_s],
           "step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
           "tflops": perf["tflops"], "mfu": perf["mfu"],
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print("train: " + json.dumps(out), flush=True)
    print("train profile: " + json.dumps(profile), flush=True)
    return out


# Phase 6b: the data and checkpoint path at full width. A token-shard
# corpus of CKPT_WINDOWS training windows of max_seq + 1 tokens (plus a
# 10 % held-out split), drawn as CKPT_MOTIFS random 16-token motifs in
# random order (numpy seed 7), so the loss falls; CKPT_STEPS steps, a
# checkpoint after CKPT_SAVE_AT of them, validation every CKPT_SAVE_AT.
CKPT_WINDOWS = 64
# phase 6b's depth (its width is never cut): 1 of the 16 layers, a ~2.4
# GB checkpoint in place of 14.55 GB, to keep the script within its time
# (2 before phase 19 came)
CKPT_LAYERS = 1
CKPT_MOTIFS = 64
CKPT_STEPS = 6
CKPT_SAVE_AT = 3
CKPT_REQUESTS = 4


def _motif_corpus(vocab, seq_len) -> np.ndarray:
    """Enough ids for CKPT_WINDOWS windows after a 10 % val split."""
    rng = np.random.default_rng(7)
    motifs = rng.integers(0, vocab, (CKPT_MOTIFS, 16))
    n = -(-CKPT_WINDOWS * (seq_len + 1) * 10 // 9) + 16
    picks = rng.integers(0, CKPT_MOTIFS, -(-n // 16))
    return motifs[picks].reshape(-1)[:n].astype(np.int32)


def _events(path, kind) -> list:
    return [e for e in map(json.loads, open(path)) if e["event"] == kind]


def _drive(dev, argv, steps, vals) -> dict:
    """One `train_lm.main(argv)` run, its launch counts zeroed just
    before it and read just after: in bf16 the tensor-core K1 launches
    n_layers x (steps + validation passes), K2 and K3 n_layers x steps,
    the f32-FMA builds none. Returns the losses `train_batch` gave, its
    seconds, and the JSONL log's events."""
    import torch

    from shallowspeed_tpu_torch import train_lm
    from shallowspeed_tpu_torch.ops import flash_attention as FA
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    n_layers = int(argv[argv.index("--n-layers") + 1])
    bf16 = "--bf16" in argv and dev.type == "cuda"
    kernels = (FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
    idle = (FA.flash_fwd, FA.flash_dq, FA.flash_dkv)
    losses, step_s = [], []
    step = ContextParallelEngine.train_batch

    def recorded(self, tok, tgt):
        t0 = time.perf_counter()
        losses.append(step(self, tok, tgt))
        step_s.append(time.perf_counter() - t0)
        return losses[-1]

    for k in kernels + idle:
        k.launches = 0
    ContextParallelEngine.train_batch = recorded
    t0 = time.time()
    try:
        train_lm.main(argv)
    finally:
        ContextParallelEngine.train_batch = step
    wall = time.time() - t0
    launches = [k.launches for k in kernels]
    want = [n_layers * (steps + vals), n_layers * steps,
            n_layers * steps] if bf16 else [0, 0, 0]
    if launches != want or any(k.launches for k in idle):
        raise AssertionError(
            f"train_lm {' '.join(argv[-8:])}: K1, K2, K3 (tensor cores) "
            f"launched {launches} times, want {want}; f32-FMA builds "
            f"{[k.launches for k in idle]}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train_lm ran {len(losses)} steps, want "
                             f"{steps}: losses {losses}")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log = argv[argv.index("--log-file") + 1]
    return {"losses": losses, "step_s": step_s, "wall_s": wall,
            "launches": launches, "log": log}


def deflate_cost(tmp_dir, mib=64) -> dict:
    """What deflating a checkpoint would cost on this host: one npz of
    `mib` MiB of N(0, 0.02) float32 (numpy seed 0) written with
    `np.savez_compressed` (the JAX package's format) and `np.savez`
    (the port's): seconds of each, and the compressed size's ratio."""
    import os

    x = np.random.default_rng(0).normal(0, 0.02, mib << 18).astype(
        np.float32)
    out = {}
    for name, fn in (("deflated", np.savez_compressed), ("stored", np.savez)):
        path = os.path.join(tmp_dir, f"{name}.npz")
        t0 = time.perf_counter()
        fn(path, leaf_0=x)
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_bytes"] = os.path.getsize(path)
        os.remove(path)
    out["ratio"] = out["deflated_bytes"] / out["stored_bytes"]
    return out


def _gbps(nbytes, secs):
    return nbytes / secs / 1e9 if secs > 0 else None


def run_data_ckpt(dev, cfg) -> dict:
    """Phase 6b: the port's data and checkpoint path at full width,
    through `train_lm.main` and the serve driver's checkpoint loader.

    Run A trains CKPT_STEPS steps from the shard corpus with validation
    and prefetch; run B the same flags for CKPT_SAVE_AT steps with a
    synchronous save; run C resumes B's checkpoint with --async-save
    --keep-last 2 and must reproduce run A's losses bit for bit. Then a
    byte of C's checkpoint is flipped: `--sample-only` must quarantine
    it and restore B's. B's parameters are served (CKPT_REQUESTS of
    phase 3's requests, K4 n_layers x ticks) and their paged logits held
    against the plain forward. The checkpoints live in a temporary
    directory removed at the end, whatever happens."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from shallowspeed_tpu_torch import serve as S
    from shallowspeed_tpu_torch.data import build_shards

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    t_phase = time.time()
    try:
        data, ck = root / "shards", root / "ckpt"
        t0 = time.time()
        build_shards(_motif_corpus(cfg.vocab, cfg.max_seq), data,
                     cfg.vocab, val_fraction=0.1)
        shards_s = time.time() - t0
        flags = ["--data-dir", str(data), "--seq-len", str(cfg.max_seq),
                 "--batch-size", str(TRAIN_BATCH),
                 "--d-model", str(cfg.d_model),
                 "--n-heads", str(cfg.n_heads),
                 "--n-layers", str(cfg.n_layers), "--rope",
                 "--norm", cfg.norm, "--ffn", cfg.ffn, "--optimizer",
                 "adamw", "--lr", "3e-4", "--grad-clip", "1.0",
                 "--val-every", str(CKPT_SAVE_AT), "--prefetch", "2",
                 "--log-every", "1"]
        if cfg.compute_dtype is not None:
            flags.append("--bf16")
        if dev.type == "cpu":
            flags += ["--device", "cpu"]

        def argv(name, *extra):
            return [*flags, *extra, "--log-file", str(root / f"{name}.jsonl")]

        a = _drive(dev, argv("a", "--steps", str(CKPT_STEPS)),
                   CKPT_STEPS, CKPT_STEPS // CKPT_SAVE_AT)
        if not a["losses"][-1] < a["losses"][0]:
            raise AssertionError(f"run A's loss did not fall: {a['losses']}")
        # phase 20 (a): runs B and C and the flipped byte, through the
        # supervisor and a fault plan (`run_drill`); (b) beside it
        with gang_drill(dev):
            drill = run_drill(dev, flags, root, ck, a)
        c = drill["survivor"]
        # each validation step's last val loss in the drill's log (the
        # restarted child's where it replayed one) is the straight run's
        vals = {r: {e["step"]: e["val_loss"] for e in _events(log, "val")}
                for r, log in (("a", a["log"]), ("drill", drill["log"]))}
        if vals["drill"] != vals["a"]:
            raise AssertionError(f"the drill's val losses {vals['drill']} "
                                 f"!= the straight run's {vals['a']}")
        saves = {e["step"]: e for e in _events(drill["log"], "ckpt_save")}
        save_b, save_c = saves[drill["first"]], saves[CKPT_STEPS - 1]
        restore_c, = _events(drill["log"], "restore")
        first, last = ck / f"ckpt_{drill['first']}", \
            ck / f"ckpt_{CKPT_STEPS - 1}"
        kept = sorted(p.name for p in ck.iterdir()
                      if not p.name.startswith("."))
        if kept != sorted([first.name, last.name]) \
                or restore_c["path"] != str(first):
            raise AssertionError(f"checkpoints {kept}, the drill's restart "
                                 f"restored {restore_c['path']}")

        # the drill's plan corrupted the newest checkpoint after it
        # landed: --sample-only must quarantine it and restore the first
        s = _drive(dev, argv("s", "--steps", str(CKPT_STEPS), "--save-dir",
                             str(ck), "--sample-only", "--generate", "16"),
                   0, 0)
        restore_s, = _events(s["log"], "restore")
        if restore_s["path"] != str(first) or restore_s["quarantined"] != [
                str(last) + ".corrupt"]:
            raise AssertionError(f"--sample-only restored "
                                 f"{restore_s['path']}, quarantined "
                                 f"{restore_s['quarantined']}")

        # serve the surviving checkpoint through serve --ckpt's loader
        t0 = time.time()
        params = S.load_ckpt_params(first, cfg, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        load_s = time.time() - t0
        prompts = dict(list(_random_prompts(cfg.vocab).items())
                       [:CKPT_REQUESTS])
        run = serve(dev, cfg, params, prompts=prompts, profile=False,
                    label="ckpt")
        rel = check_logits(dev, cfg, params, prompts, run["eng"].results,
                           LOGITS_TOL_BF16 if cfg.compute_dtype is not None
                           else LOGITS_TOL_F32, tag="ckpt ")
        served = run["stats"]
        del run, params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        nbytes = save_b["bytes"]
        ckpt = {
            "bytes": nbytes, "shards_s": shards_s,
            "save_sync": {k: save_b[k] for k in (
                "fetch_s", "write_s", "hash_s", "rename_s")},
            "save_async": {k: save_c[k] for k in (
                "fetch_s", "write_s", "hash_s", "rename_s")},
            "restore": {k: restore_c[k] for k in (
                "verify_s", "load_s", "place_s")},
            "restore_after_quarantine": {k: restore_s[k] for k in (
                "verify_s", "load_s", "place_s")},
            "serve_ckpt_load_s": load_s,
            "deflate_64mib": deflate_cost(root),
        }
        for stage in ("save_sync", "save_async", "restore",
                      "restore_after_quarantine"):
            ckpt[stage + "_gbps"] = {
                k: _gbps(nbytes, v) for k, v in ckpt[stage].items()
                if k != "rename_s"}
        ckpt["serve_ckpt_load_gbps"] = _gbps(
            (first / "params.npz").stat().st_size, load_s)
        sps = {r: 1.0 / float(np.median(x["step_s"])) for r, x in
               (("a", a), ("c", c))}
        out = {"ckpt": ckpt, "data": {
            "prefetch": {"a": 2, "c": 0}, "steps_per_s_p50": sps,
            "steps_per_s_driver": {
                "a": _events(a["log"], "step")[-1]["tokens_per_sec_cum"]
                / (TRAIN_BATCH * cfg.max_seq)},
            "wall_s": {"a": a["wall_s"], "drill": drill["wall_s"],
                       "sample_only": s["wall_s"]}},
            "losses_a": a["losses"], "losses_c": c["losses"],
            "val_a": list(vals["a"].values()), "launches_a": a["launches"],
            "launches_c": c["launches"],
            "drill_launches": drill["launches"], "serve": {
                k: served[k] for k in ("ticks", "launches", "wall_s")},
            "logits_rel": rel}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.time() - t_phase
    print("ckpt: " + json.dumps(out.pop("ckpt")), flush=True)
    print("data: " + json.dumps(out.pop("data")), flush=True)
    print("data ckpt: " + json.dumps(out), flush=True)
    return out


# Phase 20: supervised fault drills (`elastic`, `chaos`). (a) runs in
# phase 6b's temporary directory, in place of its runs B and C and its
# flipped byte: `train_lm` children under the supervisor, with phase
# 6b's flags, a sync save at step DRILL_SAVE_EVERY - 1 (the first child,
# started without a checkpoint; the restarted child saves through
# `AsyncSaver`), and the plan DRILL_PLAN: a stall in the data loader at
# step 1, a kill at the top of step 4 (after the first save landed:
# the restart resumes from it) and the post-hoc corruption of the
# second save (the restarted child's last, which `--sample-only` then
# quarantines). (b) `train --engine spmd --dp 2` as two processes on the
# card (gloo) under `GangSupervisor`, process 1 killed at the top of
# epoch 1 (GANG_PLAN), held to the one-process run's hash; it runs
# beside (a) (`gang_drill`).
DRILL_PLAN = "stall@1:0.5,kill@4,corrupt@2"
DRILL_SAVE_EVERY = 3
DRILL_HANG_S = 90             # the supervisor's hang timeout: a net only
GANG_PLAN = "kill@1"
GANG_EPOCHS = 2
GANG_BATCHES = 8


def drill_child(kind: str, out: str, *argv) -> int:
    """Phase 20's child, `python3 chip_smoke.py --phase20-child KIND OUT
    -- ARGV`, which the supervisor starts (again after each failure).
    Its output goes to OUT/KIND_PID.log. KIND "lm" runs `train_lm.main
    (ARGV)` (adding --async-save when the save dir already holds a
    checkpoint: the restarted child) with the K1-K3 launch counters
    zeroed at entry, and after every step and validation pass writes
    OUT/lm_PID.json: each step's loss (repr, exact), step seconds,
    validation passes, the counters, the seconds from entry to the
    first step (a SIGKILL loses nothing written before it). KIND "gang"
    runs `train.train(ARGV)` as one process of a gang, the fault plan
    kept by process 1 only, and writes OUT/gang_PID.json with the
    model hash."""
    t_entry = time.time()
    out = Path(out)
    me = out / f"{kind}_{os.getpid()}"
    fh = open(f"{me}.log", "w")
    os.dup2(fh.fileno(), 1)
    os.dup2(fh.fileno(), 2)
    sys.stdout.reconfigure(line_buffering=True)
    argv = list(argv[1:] if argv[:1] == ("--",) else argv)
    import torch

    # the main process's settings, under which run A ran
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if kind == "gang":
        from shallowspeed_tpu_torch import train
        from shallowspeed_tpu_torch.utils import get_model_hash

        if os.environ.get("JAX_PROCESS_ID") != "1":
            for k in [k for k in os.environ
                      if k.startswith("SHALLOWSPEED_CHAOS")]:
                del os.environ[k]
        _, eng = train.train(train.parse_args(argv))
        digest = get_model_hash(eng.params)     # collective
        Path(f"{me}.json").write_text(json.dumps({
            "process": int(os.environ["JAX_PROCESS_ID"]), "hash": digest}))
        return 0
    from shallowspeed_tpu_torch import checkpoint, train_lm
    from shallowspeed_tpu_torch.ops import flash_attention as FA
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    import_s = time.time() - t_entry
    if checkpoint.has_checkpoint(argv[argv.index("--save-dir") + 1]):
        argv.append("--async-save")
    kernels = (FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
    idle = (FA.flash_fwd, FA.flash_dq, FA.flash_dkv)
    rec = {"pid": os.getpid(), "t_entry": t_entry, "argv": argv,
           "import_s": import_s, "steps": [], "step_s": [], "evals": 0,
           "first_step_s": None}

    def dump():
        rec["launches"] = [k.launches for k in kernels]
        rec["idle"] = [k.launches for k in idle]
        Path(f"{me}.tmp").write_text(json.dumps(rec))
        os.replace(f"{me}.tmp", f"{me}.json")

    step, evaluate = (ContextParallelEngine.train_batch,
                      ContextParallelEngine.eval_loss)

    def train_batch(self, tok, tgt):
        n, t0 = self._step_count, time.perf_counter()
        if rec["first_step_s"] is None:
            rec["first_step_s"] = time.time() - t_entry
        loss = step(self, tok, tgt)
        rec["step_s"].append(time.perf_counter() - t0)
        rec["steps"].append([n, repr(float(loss))])
        dump()
        return loss

    def eval_loss(self, tok, tgt):
        v = evaluate(self, tok, tgt)
        rec["evals"] += 1
        dump()
        return v

    for k in kernels + idle:
        k.launches = 0
    ContextParallelEngine.train_batch = train_batch
    ContextParallelEngine.eval_loss = eval_loss
    dump()
    return train_lm.main(argv)


def _child_logs(out: Path) -> str:
    return "\n".join(f"--- {p.name}:\n{p.read_text()[-3000:]}"
                     for p in sorted(out.glob("*.log")))


def _supervise(dev, cmd, plan, state, procs=1, max_restarts=4,
               term_grace=3.0) -> tuple[int, float]:
    """Supervise `cmd` in this process as `python -m
    shallowspeed_tpu_torch.elastic [--procs N] --max-restarts R
    --backoff 0.3 --jitter 0 --term-grace G --hang-timeout DRILL_HANG_S
    --chaos PLAN --chaos-state STATE -- CMD` does (the supervisor makes
    no CUDA call; its children share the card), polling every 0.2 s,
    after freeing this process's cached device memory. Returns (exit
    code, seconds)."""
    from shallowspeed_tpu_torch import elastic
    from shallowspeed_tpu_torch.chaos import FaultPlan

    gc.collect()
    if dev.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    policy = elastic.RestartPolicy(max_restarts=max_restarts, backoff=0.3)
    env = {k: v for k, v in FaultPlan.parse(
        plan, state_dir=state).export_env().items()
        if k.startswith("SHALLOWSPEED_CHAOS")}
    kw = dict(hang_timeout=DRILL_HANG_S, term_grace=term_grace,
              child_env=env, poll_interval=0.2)
    sup = (elastic.GangSupervisor(cmd, procs, policy, **kw) if procs > 1
           else elastic.Supervisor(cmd, policy, **kw))
    t0 = time.time()
    rc = sup.run()
    return rc, time.time() - t0


def run_drill(dev, flags, root, ck, oracle) -> dict:
    """Phase 20 (a), in phase 6b's directory `root` (see DRILL_PLAN):
    `train_lm` with phase 6b's `flags` under the supervisor
    (`_supervise`: --max-restarts 4 --backoff 0.3 --term-grace 3 --chaos
    DRILL_PLAN), children `--phase20-child lm`,
    checkpoints in `ck`. Gates: the supervisor ends at 0 with two
    children; every step's last loss equals run A's (`oracle`) bit for
    bit; the three faults stamped once each; the restart resumed from
    the first save, never from a corrupted directory; `run_goodput` has
    a crash MTTR and accounts for >= 95 % of the wall; each child's
    K1 launches n_layers x (steps it ran + validations), K2 and K3
    n_layers x steps, the f32-FMA builds none. Prints the `drill (a):`
    line; returns what phase 6b checks next."""
    from shallowspeed_tpu_torch.telemetry.goodput import run_goodput
    from shallowspeed_tpu_torch.telemetry.schema import validate_file

    out, log = root / "drill", root / "drill.jsonl"
    out.mkdir()
    n_layers = int(flags[flags.index("--n-layers") + 1])
    child = [sys.executable, str(Path(__file__).resolve()),
             "--phase20-child", "lm", str(out), "--", *flags,
             "--steps", str(CKPT_STEPS), "--save-dir", str(ck),
             "--save-every", str(DRILL_SAVE_EVERY), "--keep-last", "2",
             "--auto-resume", "--prefetch", "0", "--log-file", str(log)]
    rc, wall = _supervise(dev, child, DRILL_PLAN, root / "chaos")
    recs = sorted((json.loads(p.read_text()) for p in out.glob("*.json")),
                  key=lambda r: r["t_entry"])
    if rc != 0 or len(recs) != 2:
        raise AssertionError(f"drill (a): supervisor exit {rc}, "
                             f"{len(recs)} children:\n{_child_logs(out)}")
    losses = {}
    for r in recs:
        losses.update(dict(r["steps"]))
    want = [repr(float(x)) for x in oracle["losses"]]
    if [losses.get(i) for i in range(CKPT_STEPS)] != want:
        raise AssertionError(f"drill (a): losses {losses} != run A's "
                             f"{want}")
    faults = _events(log, "fault")
    if sorted(f["kind"] for f in faults) != ["corrupt", "kill", "stall"]:
        raise AssertionError(f"drill (a): faults stamped {faults}")
    corrupt, = (f for f in faults if f["kind"] == "corrupt")
    restore, = _events(log, "restore")
    first = DRILL_SAVE_EVERY - 1
    if restore["path"] != str(ck / f"ckpt_{first}") \
            or restore["path"] == str(Path(corrupt["path"]).parent) \
            or restore["quarantined"]:
        raise AssertionError(f"drill (a): the restart restored "
                             f"{restore['path']} (quarantined "
                             f"{restore['quarantined']}); corrupted "
                             f"{corrupt['path']}")
    rep = run_goodput(log)
    crash = rep["mttr"].get("crash", {})
    if not crash.get("count") or rep["accounted_frac"] < 0.95 \
            or rep["faults"] != {"corrupt": 1, "kill": 1, "stall": 1}:
        raise AssertionError(f"drill (a): goodput {json.dumps(rep)}")
    # the fault lines under the schema (the log's checkpoint events are
    # the port's own, which the copied schema does not know)
    stamped = root / "faults.jsonl"
    stamped.write_text("".join(json.dumps(f) + "\n" for f in faults))
    bad = validate_file(stamped)
    if bad:
        raise AssertionError(f"drill (a): fault lines fail the schema: "
                             f"{bad}")
    bf16 = "--bf16" in flags and dev.type == "cuda"
    for r in recs:
        ran = len(r["steps"])
        k = [n_layers * (ran + r["evals"]), n_layers * ran,
             n_layers * ran] if bf16 else [0, 0, 0]
        if r["launches"] != k or any(r["idle"]):
            raise AssertionError(
                f"drill (a) child {r['pid']}: K1, K2, K3 (tensor cores) "
                f"launched {r['launches']} times, want {k}; f32-FMA "
                f"builds {r['idle']}")
    survivor = recs[-1]
    saves = _events(log, "ckpt_save")
    line = {
        "wall_s": wall, "children": len(recs), "plan": DRILL_PLAN,
        "steps_run": [len(r["steps"]) for r in recs],
        "crash_mttr_s": crash["mttr_s"],
        "restart_downtime_s": rep["losses"].get("restart_downtime"),
        "child_import_s": [r["import_s"] for r in recs],
        "child_first_step_s": [r["first_step_s"] for r in recs],
        "save_s": {e["step"]: sum(e[k] for k in (
            "fetch_s", "write_s", "hash_s", "rename_s")) for e in saves},
        "restore_s": sum(restore[k] for k in ("verify_s", "load_s",
                                               "place_s")),
        "goodput": rep["goodput"], "accounted_frac": rep["accounted_frac"],
        "losses_s": rep["losses"],
        "launches": [r["launches"] for r in recs]}
    print("drill (a): " + json.dumps(line), flush=True)
    return {"log": str(log), "wall_s": wall, "first": first,
            "resumed_at": restore["step"],
            "launches": {name: [r["launches"][i] for r in recs]
                         for i, name in enumerate(
                             ("flash_fwd_tc", "flash_dq_tc", "flash_dkv_tc"))},
            "survivor": {"losses": [float(x) for _, x in survivor["steps"]],
                         "step_s": survivor["step_s"],
                         "launches": survivor["launches"]}}


@contextlib.contextmanager
def gang_drill(dev):
    """Phase 20 (b), run beside the code in its `with` block (drill (a):
    both are mostly process start-up): the MLP's `train --engine spmd
    --schedule gpipe --dp 2` (GANG_EPOCHS epochs of GANG_BATCHES
    batches) once in this process, then as two processes
    (`--phase20-child gang`) under the gang supervisor on a thread
    (`_supervise`: --procs 2 --max-restarts 2 --term-grace 2 --chaos
    GANG_PLAN) with `--save-dir --auto-resume`: process 1 is killed at
    the top of epoch 1, the gang is killed and restarted, both resume
    from epoch 0's checkpoint. At the block's end the thread is joined
    (also when the block raises: no process outlives it). Gates: the
    supervisor ends at 0; both processes end on the one-process run's
    model hash; the kill stamped, one restart stamped with its class, a
    member resumed. Prints the `drill (b):` line."""
    import shutil
    import tempfile
    import threading

    from shallowspeed_tpu_torch import train
    from shallowspeed_tpu_torch.data.mnist import ensure_mnist
    from shallowspeed_tpu_torch.telemetry.goodput import run_goodput
    from shallowspeed_tpu_torch.utils import get_model_hash

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gang_"))
    try:
        data, out, log = root / "mnist", root / "out", root / "gang.jsonl"
        out.mkdir()
        ensure_mnist(data)       # before two processes would race for it
        flags = ["--engine", "spmd", "--schedule", "gpipe", "--dp", "2",
                 "--epochs", str(GANG_EPOCHS), "--max-batches",
                 str(GANG_BATCHES), "--data-dir", str(data)]
        if dev.type == "cpu":
            flags += ["--device", "cpu"]
        t0 = time.time()
        _, eng = train.train(train.parse_args(flags))
        one = get_model_hash(eng.params)
        one_s = time.time() - t0
        del eng
        box = {}

        def supervise():
            try:
                box["rc"], box["wall"] = _supervise(
                    dev, [sys.executable, str(Path(__file__).resolve()),
                          "--phase20-child", "gang", str(out), "--",
                          *flags, "--save-dir", str(root / "ck"),
                          "--auto-resume", "--log-file", str(log)],
                    GANG_PLAN, root / "chaos", procs=2, max_restarts=2,
                    term_grace=2.0)
            except BaseException as e:   # raised on the main thread
                box["err"] = e

        th = threading.Thread(target=supervise, name="gang-drill")
        th.start()
        try:
            yield
        finally:
            th.join()
        if "err" in box:
            raise box["err"]
        got = [r["hash"] for r in sorted(
            (json.loads(p.read_text()) for p in out.glob("*.json")),
            key=lambda r: r["process"])]
        faults = _events(log, "fault") if log.exists() else []
        rep = run_goodput(log) if log.exists() else {"mttr": {}}
        crash = rep["mttr"].get("crash", {})
        resumed = [p.name for p in out.glob("*.log")
                   if "resumed from" in p.read_text()]
        if box["rc"] != 0 or got != [one, one] \
                or [f["kind"] for f in faults] != ["kill"] \
                or crash.get("count") != 1 or not resumed:
            raise AssertionError(
                f"drill (b): supervisor exit {box['rc']}, hashes {got} vs "
                f"the one-process run's {one}, faults {faults}, mttr "
                f"{rep['mttr']}, resumed in {resumed}:\n"
                f"{_child_logs(out)}")
        line = {"wall_s": box["wall"], "hash": one, "processes": 2,
                "one_process_s": one_s, "crash_mttr_s": crash["mttr_s"],
                "member_logs": len(list(out.glob("*.log")))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("drill (b): " + json.dumps(line), flush=True)


# device-kernel groups of a training step and of a decode tick, by
# kernel-name fragment
KERNEL_GROUPS = [("K1 flash_fwd", ("flash_fwd",)),
                 ("K2 flash_dq", ("flash_dq",)),
                 ("K3 flash_dkv", ("flash_dkv",)),
                 ("matmul", ("gemm", "cutlass", "nvjet", "xmma"))]
# the port's dequant_matmul kernels before the library's matmuls; "cast"
# gathers the dtype-conversion copies (the old route's bf16 weights)
TICK_GROUPS = [("K4 paged_decode", ("paged_decode",)),
               ("dequant_matmul", ("gemm_tc", "split_sum",
                                   "blocked_matmul")),
               ("matmul", ("gemm", "cutlass", "nvjet", "xmma")),
               ("cast", ("copy_kernel",))]


def _profiled(fn, groups) -> dict:
    """fn() once under torch.profiler: device time per kernel group, the
    number of device kernels, and the device's idle share of the call's
    wall time (the profiler's own host overhead lengthens the call, so
    the idle share is an upper bound). Reports None where the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    totals = {name: 0.0 for name, _ in groups + [("other", ())]}
    by_name: dict[str, list] = {}
    n = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        n += 1
        ms = ev.time_range.elapsed_us() / 1e3
        low = ev.name.lower()
        name = next((g for g, keys in groups
                     if any(k in low for k in keys)), "other")
        totals[name] += ms
        entry = by_name.setdefault(f"{name}: {ev.name[:70]}", [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    busy = sum(totals.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms, "device_kernels": n,
            "device_ms": totals if n else None,
            "device_busy_ms": busy if n else None,
            "idle_share": 1.0 - busy / wall_ms if n else None,
            "top_kernels_ms_calls": {k: v for k, v in top}}


def profile_step(eng, tok, tgt) -> dict:
    """One more training step (after the counted ones) under
    torch.profiler (`_profiled`)."""
    return _profiled(lambda: eng.train_batch(tok, tgt), KERNEL_GROUPS)


def profile_tick(eng, cfg) -> dict:
    """A decode tick of every slot, through the engine's own
    `decode_logits` on its params and pools, at positions like the
    traffic's (a prompt plus half the new tokens, numpy seed 5): the
    median wall time of 5 ticks, then one tick under torch.profiler
    (`_profiled`). The same state for every pool and weight mode, so
    the modes compare tick for tick; the launches here do not count."""
    import torch

    from shallowspeed_tpu_torch.ops import flash_attention as FA
    from shallowspeed_tpu_torch.serving.cache import blocks_for
    from shallowspeed_tpu_torch.serving.engine import (decode_logits,
                                                       table_width)

    bs, s = SLICE["block_size"], SLICE["slots"]
    rng = np.random.default_rng(5)
    pos = rng.integers(128, 1025, s) + MAX_NEW // 2
    need = [blocks_for(p + 1, bs) for p in pos]
    bt = np.zeros((s, table_width(max(need), 4)), np.int32)
    ids = iter(range(1, N_BLOCKS))
    for r, n in enumerate(need):
        bt[r, :n] = [next(ids) for _ in range(n)]
    args = [torch.from_numpy(a).to(eng.device) for a in
            (rng.integers(0, cfg.vocab, s).astype(np.int32),
             pos.astype(np.int32), bt)]
    counts = (FA.paged_flash_decode.launches,
              FA._paged_flash_decode_int8.launches)

    def tick():
        decode_logits(eng.params, eng.pools, *args, cfg=cfg, attn="flash")

    tick()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    out = {"tick_ms": float(np.median(walls)),
           **_profiled(tick, TICK_GROUPS)}
    FA.paged_flash_decode.launches, FA._paged_flash_decode_int8.launches = \
        counts
    return out


def _grad_parity(eng_a, eng_b, tok, tgt) -> tuple[float, float, str]:
    """(loss rel diff, worst gradient-leaf max |diff| / max |ref|, that
    leaf's path) of engine a against engine b on one batch."""
    from shallowspeed_tpu_torch.weights import leaves

    la, ga = eng_a.loss_and_grads(tok, tgt)
    lb, gb = eng_b.loss_and_grads(tok, tgt)
    worst, where = 0.0, ""
    for path, a, b in zip(leaves(_paths(gb)), leaves(ga), leaves(gb)):
        ref = float(b.abs().max())
        err = float((a - b).abs().max())
        rel = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, where = rel, path
    return abs(float(la) - float(lb)) / abs(float(lb)), worst, where


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its path string."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def check_training_parity(dev, cfg, np_params) -> dict:
    """Phase 7: f32 compute, full width, 2 layers: the kernels' loss and
    gradients against the plain attention under autograd, from the same
    weights and batch; then the same plain path with q and K rounded to
    bf16 before the scores must land above GRAD_TOL_F32."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.ops.attention import attention
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype=None)
    np2 = _first_layers(np_params, 2)
    tok, tgt = _train_batch(cfg2)
    flash = ContextParallelEngine(cfg2, SGD(0.0), attn="flash", device=dev,
                                  params=np2)
    plain = ContextParallelEngine(cfg2, SGD(0.0), attn="ring", device=dev,
                                  params=np2)
    loss_rel, grad_rel, leaf = _grad_parity(flash, plain, tok, tgt)
    print(f"train parity f32, 2 layers: loss rel {loss_rel:.3e}, worst "
          f"grad leaf {leaf} rel {grad_rel:.3e} (tol {GRAD_TOL_F32:g})",
          flush=True)
    if not max(loss_rel, grad_rel) <= GRAD_TOL_F32:
        raise AssertionError(f"kernel gradients off the plain ones: loss "
                             f"{loss_rel:.3e}, {leaf} {grad_rel:.3e}")

    def bf(t):
        return t.to(torch.bfloat16).to(t.dtype)

    def slipped(q, k, v):
        return attention(bf(q), bf(k), v, causal=True,
                         window=cfg2.attn_window)

    plain.attn_fn = slipped
    s_loss, s_grad, s_leaf = _grad_parity(flash, plain, tok, tgt)
    print(f"train parity f32 with a bf16 q/K slip in the plain scores: "
          f"loss rel {s_loss:.3e}, worst grad leaf {s_leaf} rel "
          f"{s_grad:.3e} (must exceed {GRAD_TOL_F32:g})", flush=True)
    if not max(s_loss, s_grad) > GRAD_TOL_F32:
        raise AssertionError(f"a bf16 score slip moved the f32 gradients "
                             f"by only {s_grad:.3e}: GRAD_TOL_F32 cannot "
                             f"see it")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "leaf": leaf,
            "slip_loss_rel": s_loss, "slip_grad_rel": s_grad}


def time_train_kernels(dev) -> dict:
    """Phase 8: K1, K2, K3 at the training shape (B 4, T 2048, 16 heads x
    128, bf16, causal: their tensor-core builds) on two
    input sets (each over 50 MB, so the L2 holds neither), beside their
    plain versions, the library's attention (SDPA forward for K1; its
    autograd backward, which covers K2 and K3 together) and their
    bounds."""
    import torch
    import torch.nn.functional as F

    from shallowspeed_tpu_torch.ops import flash_attention as FA

    b, t, h, d = TRAIN_BATCH, 2048, 16, 128
    sets = []
    for seed in range(2):
        q, k, v, do = _train_kernel_inputs(dev, torch.bfloat16,
                                           (b, t, t, h, h, d), 100 + seed)
        o, lse = FA.flash_fwd_reference(q, k, v)
        sets.append((q, k, v, do, lse, FA.attention_delta(do, o)))
    counters = (FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
    before = [f.launches for f in counters]

    fwd = [s[:3] for s in sets]
    bwd = sets
    out = {
        "flash_fwd_tc": {"ms": _time_ms(FA.flash_fwd, fwd),
                         "plain_ms": _time_ms(FA.flash_fwd_reference, fwd)},
        "flash_dq_tc": {"ms": _time_ms(FA.flash_dq, bwd),
                        "plain_ms": _time_ms(FA.flash_dq_reference, bwd)},
        "flash_dkv_tc": {"ms": _time_ms(FA.flash_dkv, bwd),
                         "plain_ms": _time_ms(FA.flash_dkv_reference, bwd)},
    }
    if any(f.launches == n for f, n in zip(counters, before)):
        raise AssertionError("the timed calls did not reach the bf16 builds")
    for f, n in zip(counters, before):
        f.launches = n      # timing launches do not count

    # the library yardstick, never called by the port: SDPA in (B, H, T, D)
    lib = []
    for q, k, v, do, _, _ in sets:
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib.append((qt, kt, vt, ot, do.transpose(1, 2).contiguous()))

    def sdpa(qt, kt, vt, ot, dot):
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_bwd(qt, kt, vt, ot, dot):
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    out["flash_fwd_tc"]["library_ms"] = _time_ms(sdpa, lib)
    bwd_ms = _time_ms(sdpa_bwd, lib)
    out["flash_dq_tc"]["library_ms"] = bwd_ms    # covers K2 and K3 together
    out["flash_dkv_tc"]["library_ms"] = bwd_ms

    # least time: live causal pairs of this run's inputs, each input
    # read once and each output written once
    pairs = b * h * t * (t + 1) // 2
    act = b * t * h * d                        # elements of q (= k, v, o)
    stats = b * h * t * 4                      # one f32 (B, H, T) plane
    work = {"flash_fwd_tc": (4 * d * pairs, 4 * act * 2 + stats),
            "flash_dq_tc": (6 * d * pairs,
                            4 * act * 2 + 2 * stats + act * 4),
            "flash_dkv_tc": (8 * d * pairs,
                             4 * act * 2 + 2 * stats + 2 * act * 4)}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / BF16_FLOPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name].update(bound_ms=1e3 * max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes", gflop=flops / 1e9,
                         mbytes=nbytes / 1e6)
        print(f"time {name}: " + json.dumps(out[name]), flush=True)
    return out


# Phase 9: the source paper's MLP at the reference's full width
# (`train.LAYER_SIZES`), global batch 128, 4 microbatches, SGD lr 0.006,
# on synthetic MNIST (70,000 samples). Each layout trains MLP_BATCHES
# batches and is held against the serial fused run within the JAX
# package's cross-engine bound (`tests/test_integration.py:81-85`).
MLP_BATCHES = 8
MLP_RTOL, MLP_ATOL = 2e-4, 2e-6
MLP_LAYOUTS = {             # name: (engine, dp, pp, schedule)
    "fused_dp1": ("fused", 1, 1, None),
    "fused_dp2": ("fused", 2, 1, None),
    "vm_pp1_naive": ("vm", 1, 1, "naive"),
    "vm_dp4_gpipe": ("vm", 4, 1, "gpipe"),
    "vm_pp4_naive": ("vm", 1, 4, "naive"),
    "vm_pp4_gpipe": ("vm", 1, 4, "gpipe"),
    "vm_pp4_pipedream": ("vm", 1, 4, "pipedream"),
    "vm_dp2_pp2_gpipe": ("vm", 2, 2, "gpipe"),
    "vm_dp2_pp4_pipedream": ("vm", 2, 4, "pipedream"),
    "spmd_pp2": ("spmd", 1, 2, "gpipe"),
    "spmd_dp2_pp4": ("spmd", 2, 4, "gpipe"),
}
MLP_GROUPS = [("matmul", ("gemm", "cutlass", "nvjet", "xmma"))]


def _mlp_engine(dev, layout, data_dir):
    """One of the driver's engines for `layout`, with its args parsed
    by the driver itself (its defaults: the reference's MLP and SGD)."""
    from shallowspeed_tpu_torch import train

    kind, dp, pp, sched = layout
    args = train.parse_args(["--dp", str(dp), "--pp", str(pp), "--engine",
                             kind, "--schedule", sched or "naive",
                             "--data-dir", data_dir])
    return train.build(args, dev), train.SCHEDULES[sched or "naive"]


def _mlp_flat(eng) -> list:
    import torch

    return [torch.as_tensor(x).to("cpu", torch.float64)
            for layer in eng.get_canonical_params()
            for x in (layer["W"], layer["b"])]


def _mlp_layout(dev, name, layout, oracle, data_dir) -> tuple:
    """Train MLP_BATCHES batches of `layout`: batches 1.. timed (synced),
    the last one profiled; its params against the oracle's, its replicas
    bit-identical."""
    import torch

    from shallowspeed_tpu_torch.utils import assert_replicas_in_sync

    (eng, train_ds, _), sched = _mlp_engine(dev, layout, data_dir)
    epoch_batches = train_ds[0].get_num_batches()

    def batch(b):
        if layout[0] == "vm":
            eng.train_batch(sched, 4, b, train_ds)
        else:
            eng.train_batch(b, train_ds)

    times = []
    for b in range(MLP_BATCHES - 1):
        t0 = time.perf_counter()
        batch(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof = _profiled(lambda: batch(MLP_BATCHES - 1), MLP_GROUPS)
    assert_replicas_in_sync(eng.replicas())
    got = _mlp_flat(eng)
    out = {"batch_ms_p50": 1e3 * _p50(times[1:]),
           "first_batch_ms": 1e3 * times[0],
           "device_ops_per_batch": prof["device_kernels"],
           "device_busy_ms": prof["device_busy_ms"],
           "busy_share_profiled": (None if prof["idle_share"] is None
                                   else 1.0 - prof["idle_share"]),
           "profiled_batch_ms": prof["wall_ms"]}
    out["samples_per_s"] = 128 / (out["batch_ms_p50"] / 1e3)
    # the profiler lengthens the batch it watches: the busy device time
    # over an unwatched batch's wall time is the closer busy share
    if prof["device_busy_ms"] is not None:
        out["busy_share"] = prof["device_busy_ms"] / out["batch_ms_p50"]
    out["epoch_s_at_p50"] = epoch_batches * out["batch_ms_p50"] / 1e3
    if oracle is not None:
        err = max(float((a - b).abs().max()) for a, b in zip(got, oracle))
        ratio = max(float(((a - b).abs() / (MLP_ATOL + MLP_RTOL * b.abs()))
                          .max()) for a, b in zip(got, oracle))
        out.update(max_abs_err=err, bound_ratio=ratio)
        if ratio > 1.0:
            raise AssertionError(f"mlp {name}: params {ratio:.3g}x the "
                                 f"bound of the serial run (max abs {err:.3g})")
    print(f"mlp layout {name}: " + json.dumps(out), flush=True)
    del eng
    return out, got


def _mlp_drive(argv) -> dict:
    """One `train.train` run; its JSONL's epoch records and final
    accuracy, which must be finite and above epoch 0's."""
    from shallowspeed_tpu_torch import train

    log = argv[argv.index("--log-file") + 1]
    t0 = time.time()
    acc, eng = train.train(train.parse_args(argv))
    wall = time.time() - t0
    epochs = _events(log, "epoch")
    start = epochs[0]["accuracy_start"]
    if not (np.isfinite(acc) and acc > start):
        raise AssertionError(f"train {' '.join(argv)}: accuracy {start} -> "
                             f"{acc}, want a finite rise")
    from shallowspeed_tpu_torch.utils import get_model_hash

    return {"accuracy": [e["accuracy_start"] for e in epochs] + [acc],
            "epoch_s": [e["epoch_seconds"] for e in epochs],
            "samples_per_s": [e["samples_per_sec"] for e in epochs],
            "wall_s": wall, "engine": type(eng).__name__,
            "hash": get_model_hash(eng.params), "flat": _mlp_flat(eng)}


# ---------------------------------------------------------------- phase 10


def _train_counters():
    """(tensor-core launchers of K1, K2, K3; their f32-FMA launchers)."""
    from shallowspeed_tpu_torch.ops import flash_attention as FA

    return ((FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc),
            (FA.flash_fwd, FA.flash_dq, FA.flash_dkv))


def _zero_train_counts() -> None:
    for group in _train_counters():
        for k in group:
            k.launches = 0


def _train_counts() -> dict:
    """{"flash_fwd_tc": n, ..., "fma": [K1, K2, K3 f32 launches]}."""
    tc, fma = _train_counters()
    out = {k.__name__.lstrip("_"): k.launches for k in tc}
    out["fma"] = [k.launches for k in fma]
    return out


def _check_counts(label, counts, k1, k23) -> None:
    want = {"flash_fwd_tc": k1, "flash_dq_tc": k23, "flash_dkv_tc": k23,
            "fma": [0, 0, 0]}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")


def run_recipe(dev, cfg, np_params, plain_peak_gb=None) -> dict:
    """Phase 10a: the 1.21B LM's own recipe at full width and depth
    (Adafactor 3e-4, remat policy "dots", xent_chunk 1024, flash) on
    phase 6's batch: the warm-up step's loss against the plain
    attention's no-remat, unchunked no-grad loss on the same weights;
    then timed steps whose K1, K2 and K3 launches (tensor-core builds)
    must each be n_layers a step, and a profiled step. The peak memory
    is measured from before the engine's construction, as phase 6's,
    and printed beside phase 6's (`plain_peak_gb`)."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.ops.attention import attention
    from shallowspeed_tpu_torch.optim import Adafactor
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    rcfg = dataclasses.replace(cfg, remat=True, remat_policy="dots",
                               xent_chunk=1024)
    tok, tgt = _train_batch(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ContextParallelEngine(rcfg, Adafactor(3e-4), attn="flash",
                                device=dev, params=np_params)
    with torch.no_grad():
        plain = float(T.loss(eng.params, torch.from_numpy(tok).to(dev),
                             torch.from_numpy(tgt).to(dev), cfg,
                             attn_fn=partial(attention, causal=True,
                                             window=cfg.attn_window)))
    t0 = time.perf_counter()
    warm = eng.train_batch(tok, tgt)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    loss_rel = abs(warm - plain) / abs(plain)
    print(f"recipe loss at init: dots remat + chunked xent + kernels "
          f"{warm:.6f}, plain unchunked {plain:.6f}, rel {loss_rel:.3e} "
          f"(tol {LOSS_TOL_BF16:g})", flush=True)
    if not loss_rel <= LOSS_TOL_BF16:
        raise AssertionError(f"recipe loss off the plain loss by "
                             f"{loss_rel:.3e} > {LOSS_TOL_BF16:g}")
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    n = rcfg.n_layers * TRAIN_STEPS
    _check_counts("recipe", counts, n, n)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"recipe losses {losses}")
    p50 = float(np.median(step_s))
    tok_s = TRAIN_BATCH * cfg.max_seq / p50
    perf = mfu(tok_s, cfg, cfg.max_seq, "bf16", device=dev)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    profile = profile_step(eng, tok, tgt)
    out = {"steps": TRAIN_STEPS, "losses": [warm] + losses,
           "warmup_step_s": warm_s, "step_ms": [1e3 * x for x in step_s],
           "step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
           "tflops": perf["tflops"], "mfu": perf["mfu"],
           "launches": {k: v for k, v in counts.items() if k != "fma"},
           "peak_mem_gb": peak}
    print("recipe: " + json.dumps(out), flush=True)
    print(f"recipe peak memory {peak:.2f} GB beside phase 6's (AdamW, no "
          f"remat, unchunked) {plain_peak_gb} GB", flush=True)
    print("recipe profile: " + json.dumps(profile), flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["ladder"] = recipe_ladder(dev, cfg, np_params, tok, tgt)
    return out


# the recipe's features one at a time at full depth: (name, remat
# policy or None, xent_chunk), all with Adafactor 3e-4
LADDER = [("adafactor", None, 0), ("adafactor + dots", "dots", 0),
          ("adafactor + xent_chunk 1024", None, 1024)]
LADDER_STEPS = 3


def recipe_ladder(dev, cfg, np_params, tok, tgt) -> dict:
    """What each of the recipe's features buys and costs at full depth:
    Adafactor alone, then with remat "dots" or with xent_chunk 1024
    alone, each 1 warm-up + LADDER_STEPS timed steps on phase 6's batch:
    step p50, tok/s, MFU and the peak memory from before the engine's
    construction (no plain-loss check inside it, unlike phases 6 and
    10a). The launches here do not count."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.optim import Adafactor
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    out = {}
    for name, policy, chunk in LADDER:
        lcfg = dataclasses.replace(cfg, remat=policy is not None,
                                   remat_policy=policy or "full",
                                   xent_chunk=chunk)
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ContextParallelEngine(lcfg, Adafactor(3e-4), attn="flash",
                                    device=dev, params=np_params)
        eng.train_batch(tok, tgt)
        step_s = []
        for _ in range(LADDER_STEPS):
            t0 = time.perf_counter()
            loss = eng.train_batch(tok, tgt)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        if not np.isfinite(loss):
            raise AssertionError(f"recipe ladder {name}: loss {loss}")
        p50 = float(np.median(step_s))
        tok_s = TRAIN_BATCH * cfg.max_seq / p50
        out[name] = {"step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
                     "mfu": mfu(tok_s, cfg, cfg.max_seq, "bf16",
                                device=dev)["mfu"],
                     "peak_mem_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print("recipe ladder: " + json.dumps(out), flush=True)
    return out


def _worst_leaf(ga, gb) -> tuple[float, str]:
    """(worst gradient-leaf max |diff| / max |ref|, its path) of tree a
    against tree b."""
    from shallowspeed_tpu_torch.weights import leaves

    worst, where = 0.0, ""
    for path, a, b in zip(leaves(_paths(gb)), leaves(ga), leaves(gb)):
        ref = float(b.abs().max())
        err = float((a.float() - b.float()).abs().max())
        rel = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, where = rel, path
    return worst, where


def run_feature_matrix(dev, cfg, np_params) -> dict:
    """Phase 10b: at full width and FEATURE_LAYERS layers, bf16, phase
    6's batch: each feature's loss and gradients (no update) against its
    own plain counterpart's on the card, within LOSS_TOL_BF16 and
    GRAD_TOL_BF16: each remat policy and dropout 0.1 under "full" remat
    against no remat (the masks must repeat), xent_chunk 1024 and 1000
    (a remainder chunk) against unchunked, accum 2 against accum 1 on
    the same B 4 batch, attention dropout 0.1 (the plain attention,
    which must launch no K1) under "full" remat against no remat. The
    launch counts are zeroed before each row: K1 2 x n_layers under
    "full", n_layers otherwise, K2 and K3 n_layers; accum 2 doubles
    each. Each row also reports its call's wall ms and the memory it
    allocated at its peak."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    cfg2 = dataclasses.replace(cfg, n_layers=FEATURE_LAYERS)
    np2 = _first_layers(np_params, FEATURE_LAYERS)
    tok, tgt = _train_batch(cfg2)
    nl = cfg2.n_layers

    def grads(attn="flash", accum=1, **feature):
        """(loss, gradients, launch counts, {"ms": the call's wall ms,
        "peak_gb": what the row allocated at its peak, the engine's
        parameters included, over what was allocated before it})."""
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ContextParallelEngine(
            dataclasses.replace(cfg2, **feature), SGD(0.0), attn=attn,
            device=dev, accum=accum, params=np2)
        _zero_train_counts()
        t0 = time.perf_counter()
        loss, g = eng.loss_and_grads(tok, tgt)
        torch.cuda.synchronize()
        cost = {"ms": 1e3 * (time.perf_counter() - t0),
                "peak_gb": (torch.cuda.max_memory_allocated(dev)
                            - before) / 1e9}
        counts = _train_counts()
        del eng
        return float(loss), g, counts, cost

    rows = {}

    def row(name, got, ref, k1, k23):
        loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
        grad_rel, leaf = _worst_leaf(got[1], ref[1])
        _check_counts(name, got[2], k1, k23)
        rows[name] = {"loss": got[0], "loss_rel": loss_rel,
                      "grad_rel": grad_rel, "leaf": leaf,
                      "launches": {k: v for k, v in got[2].items()
                                   if k != "fma"}, **got[3]}
        print(f"features {name}: loss {got[0]:.6f} rel {loss_rel:.3e}, "
              f"worst grad leaf {leaf} rel {grad_rel:.3e}, launches "
              f"{got[2]}, {got[3]['ms']:.1f} ms, peak "
              f"{got[3]['peak_gb']:.2f} GB", flush=True)
        if not (loss_rel <= LOSS_TOL_BF16 and grad_rel <= GRAD_TOL_BF16):
            raise AssertionError(f"feature {name} off its counterpart: "
                                 f"loss {loss_rel:.3e}, {leaf} "
                                 f"{grad_rel:.3e}")

    base = grads()
    _check_counts("no remat", base[2], nl, nl)
    rows["off"] = {"loss": base[0], **base[3]}
    for policy in ("full", "attn", "dots"):
        row(f"remat {policy}", grads(remat=True, remat_policy=policy), base,
            2 * nl if policy == "full" else nl, nl)
    for chunk in (1024, 1000):
        row(f"xent_chunk {chunk}", grads(xent_chunk=chunk), base, nl, nl)
    row("accum 2", grads(accum=2), base, 2 * nl, 2 * nl)
    del base
    drop = grads(dropout=0.1)
    if drop[0] == rows["off"]["loss"]:
        raise AssertionError("dropout 0.1 left the loss unchanged")
    rows["dropout 0.1"] = {"loss": drop[0], **drop[3]}
    row("dropout 0.1, remat full", grads(dropout=0.1, remat=True), drop,
        2 * nl, nl)
    del drop
    adrop = grads(attn="ring", attn_dropout=0.1)
    rows["attn_dropout 0.1"] = {"loss": adrop[0], **adrop[3]}
    row("attn_dropout 0.1, remat full",
        grads(attn="ring", attn_dropout=0.1, remat=True), adrop, 0, 0)
    del adrop
    torch.cuda.empty_cache()
    print("features: " + json.dumps(rows), flush=True)
    return rows


def run_moe(dev, cfg) -> dict:
    """Phase 10c: the MoE FFN at full width (MOE_LAYERS layers,
    MOE_EXPERTS experts, top-2, capacity 2.0, bf16) through
    `ExpertParallelEngine` (the plain attention: no K1 launch) with
    AdamW on phase 6's batch: MOE_STEPS steps whose losses must be
    finite and fall, the routing stats, and the engine's logits against
    `T.forward` on the same weights."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine

    mcfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS,
                               n_experts=MOE_EXPERTS, moe_top_k=2,
                               moe_capacity_factor=2.0)
    npm = T.init_numpy(mcfg, seed=0)
    tok, tgt = _train_batch(mcfg)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ExpertParallelEngine(mcfg, AdamW(3e-4, weight_decay=0.01,
                                           grad_clip=1.0), device=dev,
                               params=npm)
    del npm
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    _check_counts("moe", _train_counts(), 0, 0)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"moe losses {losses}")
    stats = eng.router_stats(tok)
    got = eng.logits(tok).float()
    with torch.no_grad():
        ref = T.forward(eng.params, torch.from_numpy(tok).to(dev),
                        mcfg).float()
    rel = float((got - ref).abs().max() / ref.abs().max())
    out = {"losses": losses, "step_ms": [1e3 * x for x in step_s],
           "step_ms_p50": 1e3 * float(np.median(step_s[1:])),
           "router": stats, "logits_rel": rel,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print("moe: " + json.dumps(out), flush=True)
    if not rel <= LOGITS_TOL_BF16:
        raise AssertionError(f"moe engine logits off T.forward by {rel:.3e}")
    return out


def run_mlp(dev, card) -> dict:
    """Phase 9: the MLP path of the source paper on the card — every
    layout against the serial oracle, the driver's default, VM and SPMD
    paths, and save/resume bit for bit. Prints `mlp layout ...` lines
    and one `mlp:` line."""
    import shutil
    import tempfile

    import torch

    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="mlp_smoke_")
    try:
        data_dir = str(prepare_mnist(root + "/mnist", synthetic=True))
        layouts, oracle = {}, None
        for name, layout in MLP_LAYOUTS.items():
            layouts[name], flat = _mlp_layout(dev, name, layout, oracle,
                                              data_dir)
            if oracle is None:
                oracle = flat
            gc.collect()
            torch.cuda.empty_cache()
        base = ["--data-dir", data_dir]
        runs = {}
        for key, extra in (
                ("fused_2_epochs", ["--epochs", "2", "--save-dir",
                                    root + "/a"]),
                ("vm_pp4_pipedream_50", ["--pp", "4", "--schedule",
                                         "pipedream", "--epochs", "1",
                                         "--max-batches", "50"]),
                ("spmd_pp2_gpipe_50", ["--pp", "2", "--schedule", "gpipe",
                                       "--epochs", "1", "--max-batches",
                                       "50"])):
            runs[key] = _mlp_drive(base + extra + [
                "--log-file", f"{root}/{key}.jsonl"])
        _mlp_drive(base + ["--epochs", "1", "--save-dir", root + "/b",
                           "--log-file", root + "/b1.jsonl"])
        resumed = _mlp_drive(base + ["--epochs", "2", "--save-dir",
                                     root + "/b", "--resume", "--log-file",
                                     root + "/b2.jsonl"])
        straight = runs["fused_2_epochs"]
        same = (resumed["hash"] == straight["hash"] and all(
            torch.equal(a, b) for a, b in zip(resumed["flat"],
                                              straight["flat"])))
        if not same:
            raise AssertionError("mlp: a 1-epoch run resumed to epoch 2 "
                                 "differs from a straight 2-epoch run")
        for r in runs.values():
            del r["flat"]
        out = {"card": card, "layouts": layouts, "driver": runs,
               "resume_bit_identical": same, "hash": straight["hash"],
               "phase_s": time.time() - t_phase}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("mlp: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------- phase 11

# H100 SXM data-sheet peak for e4m3 x e4m3 on the tensor cores, dense
FP8_FLOPS_PER_S = 1979e12
# fp8_matmul's shapes on the main paths: the 1.21B step's denses (M =
# B x T = 8192: qkv, proj, gate / up, down, head) and the MLP's layers
# (M = its batch, 128)
FP8_LM_SHAPES = [(8192, 2048, 6144), (8192, 2048, 2048), (8192, 2048, 8192),
                 (8192, 8192, 2048), (8192, 2048, 32768)]
FP8_MLP_SHAPES = [(128, 784, 128), (128, 128, 127), (128, 127, 126),
                  (128, 126, 125), (128, 125, 124), (128, 124, 123),
                  (128, 123, 10)]
# the e4m3 GEMM's tensor-core build against its exact-f32 FMA build on
# the same inputs: ||tc - exact|| <= FP8_TC_VS_FMA ||fma - exact||. Both
# sum in f32; the tensor cores truncate once a group of products, the
# FMA rounds to nearest once a product, so the ratio grows with K: on an
# H100 it read 0.97 at K 784, 1.82 at K 2048 and 4.07 at K 8192; the
# rule is twice the largest. An accumulator of 14 bits (the 8-bit
# wgmma's), simulated by `_fp8_coarse`, read ~15,000-25,000x.
FP8_TC_VS_FMA = 8.0
# the reference's runtime loss-parity envelope (telemetry/numerics.py),
# the rule of its tests/test_numerics.py:506-531: the fp8 step's loss at
# init against the bf16 step's
PARITY_LOSS_BUDGET = 0.05
FP8_STEPS = 3
# the fp8 MLP driver on the card against the same run on the CPU: the
# f32 sums differ in order, and an amax an ulp apart can move a delayed
# scale across an e4m3 tie (one byte one e4m3 step), so losses and the
# final validation loss are held within 1e-3 relative
# (tests/test_torch_fp8.py's cross-package bound)
FP8_DRIVER_TOL = 1e-3
FP8_DRIVER_ARGV = ["--engine", "fp8", "--epochs", "1", "--max-batches", "14",
                   "--shadow-every", "4", "--log-every", "4", "--health",
                   "guard"]
MONITOR_STEPS = 3


def _fp8_counters():
    from shallowspeed_tpu_torch.ops import matmul as MM

    return {"tc": MM._fp8_matmul_tc, "fma": MM._fp8_matmul_fma}


def _fp8_exact(xq, wq, scale):
    """The exact product (f64 on the card) and the f32 order bound of a
    sum of K products, K 2^-24 sum|terms|, per element."""
    xd, wd, sd = xq.double(), wq.double(), scale.double()
    exact = (xd @ wd) * sd
    bound = xq.shape[1] * 2.0 ** -24 * ((xd.abs() @ wd.abs()) * sd.abs())
    return exact, bound


def _fp8_ratio(got, exact, bound) -> float:
    """max over elements of |got - exact| / the f32 order bound."""
    return float(((got.double() - exact).abs()
                  / bound.clamp(min=1e-300)).max())


def _fp8_rel(got, exact) -> float:
    """||got - exact|| / ||exact|| (Frobenius): the error against a
    typical output."""
    return float((got.double() - exact).norm() / exact.norm())


def _fp8_coarse(xq, wq, scale, bits=14, step=32):
    """The product summed the way the 8-bit wgmma sums: each `step` of K
    added (exactly) to an f32 accumulator that keeps `bits` significant
    bits (truncated), then scaled. The slip the tensor-core build's
    FP8_TC_VS_FMA rule must catch."""
    import torch

    acc = torch.zeros(xq.shape[0], wq.shape[1], dtype=torch.float32,
                      device=xq.device)
    mask = ~((1 << (24 - bits)) - 1)
    for k0 in range(0, xq.shape[1], step):
        part = xq[:, k0:k0 + step].double() @ wq[k0:k0 + step].double()
        acc = ((acc.double() + part).float().view(torch.int32)
               & mask).view(torch.float32)
    return acc * scale


def check_fp8_matmul(dev, card) -> dict:
    """Phase 11a: the e4m3 GEMM (`fp8_matmul`) at every shape of the LM
    step and the MLP, each on the build `fp8_matmul_route` picks: the
    card's quantized bytes equal the CPU's; the kernel's and the plain
    version's outputs within the f32 order bound (ratio <= 1); at the
    tensor-core build's shapes its error against the exact product
    within FP8_TC_VS_FMA times the exact-f32 FMA build's on the same
    inputs, where a simulated 14-bit accumulator (`_fp8_coarse`) must
    land past it; a NaN input row a NaN output row. Times the tc build
    at the LM shapes and the FMA build at the MLP's (128, 128, 127)
    beside the plain version, `torch._scaled_mm` (unit scales, f32 out:
    the product alone; a yardstick) and the bound."""
    import torch

    from shallowspeed_tpu_torch.ops import matmul as MM

    g = torch.Generator().manual_seed(11)
    counters = _fp8_counters()
    worst = {"tc": 0.0, "fma": 0.0}
    timing, lines = {}, []
    for (m, k, n) in FP8_LM_SHAPES + FP8_MLP_SHAPES:
        x = torch.randn(m, k, generator=g) * 3
        w = torch.randn(k, n, generator=g) * 0.05
        xd, wd = x.to(dev), w.to(dev)
        sx = torch.clamp(torch.amax(xd.abs()) / MM.E4M3_MAX, min=1e-12)
        sw = MM._w_scale(wd)
        xq, wq = MM.fp8_quantize(xd, sx), MM.fp8_quantize(wd, sw)
        for q, ref in ((xq, MM.fp8_quantize(x, sx.cpu())),
                       (wq, MM.fp8_quantize(w, sw.cpu()))):
            if not torch.equal(q.view(torch.uint8).cpu(),
                               ref.view(torch.uint8)):
                raise AssertionError(f"fp8_quantize ({m},{k},{n}): the "
                                     f"card's bytes differ from the CPU's")
        scale = sx * sw
        route = MM.fp8_matmul_route(k, n)
        before = {r: c.launches for r, c in counters.items()}
        got = MM.fp8_matmul(xq, wq, scale)
        torch.cuda.synchronize()
        after = {r: c.launches for r, c in counters.items()}
        if after[route] != before[route] + 1 or sum(after.values()) != \
                sum(before.values()) + 1:
            raise AssertionError(f"fp8_matmul ({m},{k},{n}) did not launch "
                                 f"its {route} build once: {after}")
        plain = MM.fp8_matmul_reference(xq, wq, scale)
        exact, bound = _fp8_exact(xq, wq, scale)
        line = {"card": card, "shape": [m, k, n], "route": route,
                "ratio": _fp8_ratio(got, exact, bound),
                "plain_ratio": _fp8_ratio(plain, exact, bound),
                "rel_err": _fp8_rel(got, exact),
                "plain_rel_err": _fp8_rel(plain, exact),
                "max_abs_err": float((got - plain).abs().max())}
        ok = line["ratio"] <= 1.0 and line["plain_ratio"] <= 1.0
        if route == "tc":
            fma = MM._fp8_matmul_fma(xq, wq, scale)
            line["fma_rel_err"] = _fp8_rel(fma, exact)
            line["vs_fma"] = line["rel_err"] / line["fma_rel_err"]
            ok = ok and line["vs_fma"] <= FP8_TC_VS_FMA
            if (m, k, n) in (FP8_LM_SHAPES[0], FP8_MLP_SHAPES[0]):
                coarse = _fp8_coarse(xq, wq, scale)
                line["coarse14_vs_fma"] = (_fp8_rel(coarse, exact)
                                           / line["fma_rel_err"])
                ok = ok and line["coarse14_vs_fma"] > FP8_TC_VS_FMA
                del coarse
            del fma
        worst[route] = max(worst[route], line["max_abs_err"])
        xn = xd.clone()
        xn[m // 2] = float("nan")
        out_n = MM.fp8_matmul(MM.fp8_quantize(xn, sx), wq, scale)
        line["nan_row"] = bool(torch.isnan(out_n[m // 2]).all()
                               and torch.isfinite(out_n[:m // 2]).all())
        lines.append(line)
        if not (ok and line["nan_row"]):
            raise AssertionError(f"fp8_matmul ({m},{k},{n}) {route}: {line}")
        if m == 8192 or (m, k, n) == FP8_MLP_SHAPES[1]:
            name = f"fp8_matmul_{route}"
            ins = [(MM.fp8_quantize(torch.randn(m, k, device=dev) * 3, sx),
                    wq, scale) for _ in range(3)]
            wq_t = wq.view(torch.uint8).t().contiguous().view(
                torch.float8_e4m3fn)
            one = torch.ones((), device=dev)
            ms = _time_ms(MM.fp8_matmul, ins)
            plain_ms = _time_ms(MM.fp8_matmul_reference, ins)
            lib_ms = (_time_ms(lambda a, b, c: torch._scaled_mm(
                a, wq_t.t(), scale_a=one, scale_b=one,
                out_dtype=torch.float32), ins) if n % 16 == 0 and k % 16 == 0
                else None)
            flops = 2.0 * m * n * k
            nbytes = m * k + k * n + 4 * n + 4 * m * n
            bound_s = max(flops / FP8_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
            row = {"shape": [m, k, n], "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": 1e3 * bound_s,
                   "bound_by": ("operations" if flops / FP8_FLOPS_PER_S
                                >= nbytes / HBM_BYTES_PER_S else "bytes"),
                   "tflops": flops / ms / 1e9}
            line.update(row)
            # the kernels line reports the head (tc) and the MLP's
            # (128, 128, 127) (fma), the largest call of each build
            if (m, k, n) in (FP8_LM_SHAPES[-1], FP8_MLP_SHAPES[1]):
                timing[name] = row
        del exact, bound, plain, got
    for line in lines:
        print("check fp8_matmul: " + json.dumps(line), flush=True)
    torch.cuda.empty_cache()
    return {"errs": {f"fp8_matmul_{r}": e for r, e in worst.items()},
            "timing": timing}


def run_fp8_lm(dev, cfg, np_params, bf16_loss, card) -> dict:
    """Phase 11b: the 1.21B LM with fp8_dense (bf16 compute, AdamW 3e-4,
    phase 6's batch, flash): the warm-up step's loss within
    PARITY_LOSS_BUDGET of phase 6's bf16 loss at the same weights, its
    gradients finite (the health pack's sentinel); FP8_STEPS timed steps
    with the counts zeroed before them: the e4m3 GEMM's tensor-core
    build 81 a step (16 layers x 5 denses + the head), the FMA build 0,
    K1-K3 16 a step; losses finite and falling; step p50, MFU against
    989 TFLOP/s bf16 (the model's FLOPs), the peak memory, and a
    profiled step's device ms by group (the fp8 GEMM, the f32 cuBLAS
    products of the backward, K1-K3, the rest)."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    cfg8 = dataclasses.replace(cfg, fp8_dense=True)
    tok, tgt = _train_batch(cfg8)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ContextParallelEngine(cfg8, AdamW(3e-4, weight_decay=0.01,
                                            grad_clip=1.0),
                                attn="flash", device=dev, params=np_params,
                                health="monitor")
    warm = eng.train_batch(tok, tgt)
    snap = eng.health_snapshot()
    rel = abs(warm - bf16_loss) / abs(bf16_loss)
    print(f"fp8 train loss at init: fp8 {warm:.6f} bf16 {bf16_loss:.6f} "
          f"rel {rel:.3e} (budget {PARITY_LOSS_BUDGET:g}); grad norm "
          f"{snap['grad_norm']:.4g}, nonfinite {snap['nonfinite']}; {card}",
          flush=True)
    if not (rel <= PARITY_LOSS_BUDGET and snap["nonfinite"] == 0
            and np.isfinite(snap["grad_norm"])):
        raise AssertionError(f"fp8 step at init: loss rel {rel:.3e}, pack "
                             f"{snap}")
    eng.health = "off"
    counters = _fp8_counters()
    for c in counters.values():
        c.launches = 0
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(FP8_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {f"fp8_matmul_{r}": c.launches for r, c in counters.items()}
    want = (5 * cfg8.n_layers + 1) * FP8_STEPS
    if launches != {"fp8_matmul_tc": want, "fp8_matmul_fma": 0}:
        raise AssertionError(f"fp8 step launches {launches}, want {want} "
                             f"tensor-core launches")
    _check_counts("fp8 step", _train_counts(), cfg8.n_layers * FP8_STEPS,
                  cfg8.n_layers * FP8_STEPS)
    if not (all(np.isfinite(losses)) and losses[-1] < warm):
        raise AssertionError(f"fp8 training losses {[warm] + losses}")
    p50 = float(np.median(step_s))
    tok_s = TRAIN_BATCH * cfg8.max_seq / p50
    perf = mfu(tok_s, cfg8, cfg8.max_seq, "bf16", device=dev)
    profile = _profiled(lambda: eng.train_batch(tok, tgt), [
        ("fp8 GEMM", ("gemm_tc_kernel", "split_sum")),
        ("K1 flash_fwd", ("flash_fwd",)),
        ("K2 flash_dq", ("flash_dq",)), ("K3 flash_dkv", ("flash_dkv",)),
        ("f32 matmul", ("gemm", "cutlass", "nvjet", "xmma"))])
    out = {"card": card, "losses": [warm] + losses,
           "loss_rel_to_bf16": rel,
           "step_ms": [1e3 * x for x in step_s], "step_ms_p50": 1e3 * p50,
           "tok_per_s": tok_s, "tflops": perf["tflops"], "mfu": perf["mfu"],
           "mfu_peak": "989 TFLOP/s bf16 (model FLOPs)",
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches}
    print("fp8 train: " + json.dumps(out), flush=True)
    print("fp8 train profile: " + json.dumps({"card": card, **profile}),
          flush=True)
    del eng
    return out


def _mlp_steps(log) -> list:
    return [(e["step"], e["loss"]) for e in _events(log, "step")]


def run_fp8_mlp(dev, cfg, np_params, card) -> dict:
    """Phase 11c: `train --engine fp8 --health guard --shadow-every 4
    --log-every 4` on the card at the MLP's full width, 14 batches, with
    the counts zeroed before it (both builds of the e4m3 GEMM must run:
    the tensor-core one for the 784 -> 128 layer, the FMA one for the
    widths that are not multiples of 16), against the same run on the
    CPU (FP8_DRIVER_TOL); then the guard on the card: a NaN batch into
    the fused MLP engine under health="guard" leaves every parameter and
    momentum leaf bit for bit; then phase 6's 1.21B step with health
    "off", "monitor" and "guard" in turns (off, monitor, guard, guard,
    monitor, off): the pack's and the guard's added ms, and each mode's
    peak memory."""
    import shutil
    import tempfile

    import torch

    from shallowspeed_tpu_torch import train
    from shallowspeed_tpu_torch.data.dataset import Dataset
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist
    from shallowspeed_tpu_torch.engine import FusedDPEngine
    from shallowspeed_tpu_torch.models.mlp import MLPStage
    from shallowspeed_tpu_torch.optim import AdamW, MomentumSGD
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_mesh
    from shallowspeed_tpu_torch.weights import leaves

    root = tempfile.mkdtemp(prefix="fp8_smoke_")
    try:
        data_dir = str(prepare_mnist(root + "/mnist", synthetic=True))
        base = FP8_DRIVER_ARGV + ["--data-dir", data_dir]
        counters = _fp8_counters()
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        final, eng = train.train(train.parse_args(
            base + ["--log-file", root + "/card.jsonl"]))
        card_s = time.time() - t0
        launches = {f"fp8_matmul_{r}": c.launches
                    for r, c in counters.items()}
        if not (launches["fp8_matmul_fma"] and launches["fp8_matmul_tc"]):
            raise AssertionError(f"fp8 driver launches {launches}")
        if eng.device.type != dev.type or eng.precision != "fp8":
            raise AssertionError(f"fp8 driver ran on {eng.device}, "
                                 f"precision {eng.precision}")
        final_cpu, _ = train.train(train.parse_args(
            base + ["--log-file", root + "/cpu.jsonl", "--device", "cpu"]))
        card_steps = _mlp_steps(root + "/card.jsonl")
        cpu_steps = _mlp_steps(root + "/cpu.jsonl")
        worst = max([abs(a[1] - b[1]) / abs(b[1])
                     for a, b in zip(card_steps, cpu_steps)]
                    + [abs(final - final_cpu) / abs(final_cpu)])
        shadow = _events(root + "/card.jsonl", "step")[-1][
            "num_shadow_total"]
        if [s for s, _ in card_steps] != [s for s, _ in cpu_steps] \
                or not worst <= FP8_DRIVER_TOL or shadow != 3:
            raise AssertionError(f"fp8 driver card {card_steps} final "
                                 f"{final} vs CPU {cpu_steps} {final_cpu}; "
                                 f"shadow samples {shadow}")

        # the guard on the card: batch 1's inputs are NaN
        ds = Dataset(data_dir, 128, 32).load(0, 1)
        guard = FusedDPEngine(MLPStage(train.LAYER_SIZES, 0, 1,
                                       batch_size=128),
                              MomentumSGD(0.006), make_mesh(1, 1, dev),
                              health="guard")
        stack = ds.load_mubatch_stack(0)
        xs = [torch.from_numpy(stack[0]).to(dev)]
        ys = [torch.from_numpy(stack[1]).to(dev)]
        guard._step(xs, ys)

        def state():
            return [t.clone() for t in leaves((guard.params,
                                               guard.opt_state))]

        before = state()
        guard._step([xs[0] * float("nan")], ys)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(state(), before))
        snap = guard.health_snapshot()
        guard._step(xs, ys)
        moved = not all(torch.equal(a, b) for a, b in zip(state(), before))
        if not (same and moved and snap["skipped"] == 1
                and snap["skipped_total"] == 1 and snap["nonfinite"] > 0):
            raise AssertionError(f"guard on the card: unchanged {same}, "
                                 f"trains after {moved}, pack {snap}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the health pack's and the guard's cost on phase 6's step, in turns
    tok, tgt = _train_batch(cfg)
    lm = ContextParallelEngine(cfg, AdamW(3e-4, weight_decay=0.01,
                                          grad_clip=1.0),
                               attn="flash", device=dev, params=np_params)
    lm.train_batch(tok, tgt)
    times = {"off": [], "monitor": [], "guard": []}
    peak = dict.fromkeys(times, 0.0)
    for mode in ("off", "monitor", "guard", "guard", "monitor", "off"):
        lm.health = mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(MONITOR_STEPS):
            t0 = time.perf_counter()
            lm.train_batch(tok, tgt)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
        peak[mode] = max(peak[mode],
                         torch.cuda.max_memory_allocated(dev) / 1e9)
        if mode == "guard":
            snap = lm.health_snapshot()
            if not (snap["skipped"] == 0 and snap["update_ratio"] > 0):
                raise AssertionError(f"guard pack {snap}")
    pack = lm.health_snapshot()
    del lm
    if not (pack["nonfinite"] == 0 and np.isfinite(pack["grad_norm"])
            and pack["update_ratio"] > 0):
        raise AssertionError(f"monitor pack {pack}")
    p50 = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    out = {"card": card, "driver_s": card_s, "final_val_loss": final,
           "final_val_loss_cpu": final_cpu, "worst_rel": worst,
           "shadow_samples": shadow, "launches": launches,
           "guard_skip_bit_identical": same,
           "step_ms_p50_off": p50["off"],
           "step_ms_p50_monitor": p50["monitor"],
           "step_ms_p50_guard": p50["guard"],
           "pack_added_ms": p50["monitor"] - p50["off"],
           "guard_added_ms": p50["guard"] - p50["off"],
           "peak_mem_gb": peak,
           "pack": {k: pack[k] for k in ("grad_norm", "param_norm",
                                         "update_ratio", "nonfinite")}}
    print("fp8 mlp and health: " + json.dumps(out), flush=True)
    return out


# Phase 12: data x sequence parallelism on the one card, every cell of a
# (dp, sp) grid the card. (a) K1's f32-output build at the ring's chunk
# shape; (b) `ring_flash_attention` whole against one-device
# `flash_attention`; (c) `ContextParallelEngine` at CP_LAYERS layers in
# CP_LAYOUTS; (d) the driver at CP_DRIVER_LAYERS layers with a checkpoint
# that crosses layouts.
RING_CHUNK = (2, 1024, 16, 128)          # B, T / sp, heads, head_dim
RING_CHUNK_CASES = [("rel0", 0, 0, 16), ("rel1024", 1024, 0, 16),
                    ("rel-1024-window512", -1024, 512, 16),
                    ("gqa", 0, 0, 4)]    # name, rel, window, kv heads
# a ring-flash hop inside a pipeline stage (phase 15c): a one-row
# microbatch's sp tile, q, k, v the strided views of the fused qkv, on
# the diagonal and off it (name, rel)
RING_HOP = (1, 1024, 16, 128)
RING_HOP_CASES = [("stage-hop-rel0", 0), ("stage-hop-rel1024", 1024)]
RING_WHOLE = (2, 2048, 16, 128)
RING_SPS = (2, 4)
# ring (or the engine) against one-device flash_attention: both round o
# and the gradients to bf16 once, at other points; the bf16 bound of
# tests/test_torch_cuda.py::test_flash_attention_grads_match_plain_
# attention, as max |diff| / max |ref|
RING_TOL_BF16 = 2e-2
# name, dp, sp, attn, engine options
CP_LAYOUTS = [("dp2-sp2-ring-flash", 2, 2, "ring-flash", {}),
              ("dp1-sp4-ulysses-flash", 1, 4, "ulysses-flash", {}),
              ("dp2-sp1-flash-zero1", 2, 1, "flash", {"zero1": True}),
              ("dp2-sp2-ring-flash-zero2-accum2", 2, 2, "ring-flash",
               {"zero2": True, "accum": 2})]
CP_STEPS = 5
# phase 12c's depth: 1 of 16 layers (the script's time; 2 before phase
# 20 came; phase 15 holds the sp substrates inside a pipeline stage at
# PP15_SP_LAYERS, and phase 16b runs 12c's ZeRO-2 layout at
# OV_Z2_LAYERS)
CP_LAYERS = 1
# 12d's driver at 1 layer (2 before phase 19 came, cut for the script's time)
CP_DRIVER_LAYERS = 1
CP_DRIVER_STEPS = 4


def check_ring_chunk(dev) -> tuple[float, dict]:
    """Phase 12a: K1's bf16 build with the f32 epilogue
    (`_flash_fwd_tc_f32o`) at RING_CHUNK, for each RING_CHUNK_CASES entry,
    and at RING_HOP on the fused qkv's views, for each RING_HOP_CASES
    entry, against its plain version (`out_dtype` float32) under
    `FA.kernel_ratio`'s rule with the o term of `tc_rounding_terms` (the
    output is f32: no bf16 ulp), lse within LSE_TOL; a fully masked
    chunk must give o 0 and lse -1e30; the bf16 build's o must be the
    f32 o rounded once. Then its time at rel 1024 (no mask) beside the
    plain version, SDPA's non-causal forward and the bound. Returns
    (max |diff|, timing)."""
    import torch
    import torch.nn.functional as F

    from shallowspeed_tpu_torch.ops import flash_attention as FA

    b, t, h, d = RING_CHUNK
    f32 = torch.float32
    worst = 0.0
    cases = ([(n, RING_CHUNK, rel, w, hkv, False)
              for n, rel, w, hkv in RING_CHUNK_CASES]
             + [(n, RING_HOP, rel, 0, RING_HOP[2], True)
                for n, rel in RING_HOP_CASES])
    for ci, (name, (cb, ct, ch, cd), rel, window, hkv, fused) in \
            enumerate(cases):
        q, k, v, _ = _train_kernel_inputs(dev, torch.bfloat16,
                                          (cb, ct, ct, ch, hkv, cd), 200 + ci,
                                          fused)
        kw = dict(causal=True, window=window, rel=rel)
        before = FA._flash_fwd_tc_f32o.launches
        o, lse = FA.flash_fwd(q, k, v, out_dtype=f32, **kw)
        torch.cuda.synchronize()
        if FA._flash_fwd_tc_f32o.launches != before + 1 or o.dtype != f32:
            raise AssertionError(f"ring chunk {name}: the call did not "
                                 f"launch _flash_fwd_tc_f32o or gave "
                                 f"{o.dtype}")
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"ring chunk {name}: non-finite o")
        o_ref, lse_ref = FA.flash_fwd_reference(q, k, v, out_dtype=f32, **kw)
        if not bool((lse_ref > -1e29).any()):
            if float(o.abs().max()) != 0.0 or not bool((lse == -1e30).all()):
                raise AssertionError(f"ring chunk {name}: every row is "
                                     f"masked, yet o or lse is not 0 / -1e30")
            print(f"check flash_fwd_tc_f32o {name}: every row masked, o 0 "
                  f"and lse -1e30", flush=True)
            continue
        terms = FA.tc_rounding_terms(q, k, v, **kw)
        err, ratio = FA.kernel_ratio(o, o_ref, extra=terms["o"])
        lse_rel = _lse_err(lse, lse_ref)
        o16, _ = FA.flash_fwd(q, k, v, **kw)
        r16 = FA.kernel_ratio(o16, o, rounded=True)[1]
        print(f"check flash_fwd_tc_f32o {name}: max_abs_err {err:.3e}, "
              f"worst element at {ratio:.3e} of its allowance, lse rel "
              f"{lse_rel:.3e}; the bf16 build's o at {r16:.3e} of one "
              f"rounding of it (bit-equal: "
              f"{torch.equal(o16, o.to(torch.bfloat16))})", flush=True)
        if not (ratio <= 1.0 and lse_rel <= LSE_TOL and r16 <= 1.0):
            raise AssertionError(f"ring chunk {name}: o at {ratio:.3e}, "
                                 f"lse {lse_rel:.3e}, bf16 o at {r16:.3e}")
        worst = max(worst, err)
        del o_ref, lse_ref, terms

    # timing at rel 1024: every key before every query, no mask
    counts = FA._flash_fwd_tc_f32o.launches
    sets = [_train_kernel_inputs(dev, torch.bfloat16, (b, t, t, h, h, d),
                                 210 + i)[:3] for i in range(6)]

    def kern(q, k, v):
        FA.flash_fwd(q, k, v, rel=t, out_dtype=f32)

    def plain(q, k, v):
        FA.flash_fwd_reference(q, k, v, rel=t, out_dtype=f32)

    lib = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]

    def library(q, k, v):
        F.scaled_dot_product_attention(q, k, v)

    out = {"ms": _time_ms(kern, sets), "plain_ms": _time_ms(plain, sets),
           "library_ms": _time_ms(library, lib)}
    for key, fn, args in (("device_ms", kern, sets),
                          ("library_device_ms", library, lib)):
        prof = _profiled(lambda: [fn(*a) for a in args], [])
        out[key] = (prof["device_busy_ms"] / len(args)
                    if prof["device_busy_ms"] is not None else None)
    FA._flash_fwd_tc_f32o.launches = counts     # timing launches do not count
    flops = 4 * d * b * h * t * t
    nbytes = 3 * b * t * h * d * 2 + b * t * h * d * 4 + b * h * t * 4
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    out.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print("time flash_fwd_tc_f32o: " + json.dumps(out), flush=True)
    return worst, out


def _max_rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _grad_worst(grads, ref) -> tuple[float, str]:
    """The worst leaf of `grads` against the host list `ref` (max |diff|
    / max |ref|) and its path."""
    from shallowspeed_tpu_torch.weights import leaves

    worst, where = 0.0, ""
    for path, g, r in zip(leaves(_paths(grads)), leaves(grads), ref):
        rel = _max_rel(g, r.to(g.device))
        if not rel <= worst:
            worst, where = rel, path
    return worst, where


def check_ring_whole(dev) -> dict:
    """Phase 12b: `ring_flash_attention` at RING_WHOLE over sp cells of
    the card, for each of RING_SPS, against `flash_attention` over the
    gathered sequence: o and dq, dk, dv (the cotangent dO random) within
    RING_TOL_BF16, o also per element against the plain f32 attention
    under the kernels' rule (one bf16 rounding of o, the P term of
    `tc_rounding_terms`); each layer's K1 (f32 o), K2 and K3 launches
    sp (sp + 1) / 2."""
    import torch

    from shallowspeed_tpu_torch.ops import flash_attention as FA

    b, t, h, d = RING_WHOLE
    q, k, v, do = _train_kernel_inputs(dev, torch.bfloat16, (b, t, t, h, h, d),
                                       300)

    def run(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        grads = torch.autograd.grad(o, xs, do)
        torch.cuda.synchronize()
        return o.detach(), grads

    o_flash, g_flash = run(lambda a, b_, c: FA.flash_attention(a, b_, c))
    o_plain, _ = FA.flash_fwd_reference(q, k, v, out_dtype=torch.float32)
    term = FA.tc_rounding_terms(q, k, v)["o"]
    counters = (FA._flash_fwd_tc_f32o, FA._flash_dq_tc, FA._flash_dkv_tc)
    saved = [c.launches for c in counters]
    out = {}
    for sp in RING_SPS:
        before = [c.launches for c in counters]
        o, grads = run(lambda a, b_, c: FA.ring_flash_attention(
            a, b_, c, [dev] * sp))
        launched = [c.launches - n for c, n in zip(counters, before)]
        want = [sp * (sp + 1) // 2] * 3
        rels = {"o": _max_rel(o, o_flash), **{
            f"d{n}": _max_rel(g, r) for n, g, r in zip("qkv", grads,
                                                       g_flash)}}
        ratio = FA.kernel_ratio(o, o_plain, rounded=True, extra=term)[1]
        out[f"sp{sp}"] = {"vs_flash": rels, "o_vs_plain_ratio": ratio,
                          "launches": launched}
        print(f"check ring_flash_attention sp {sp}: vs flash_attention "
              f"{json.dumps(rels)} (tol {RING_TOL_BF16:g}), o at "
              f"{ratio:.3e} of the kernels' allowance against the plain "
              f"f32 attention; K1 (f32 o), K2, K3 launches {launched} "
              f"(want {want})", flush=True)
        if launched != want or ratio > 1.0 or not all(
                np.isfinite(x) and x <= RING_TOL_BF16 for x in rels.values()):
            raise AssertionError(f"ring_flash_attention sp {sp}: {rels}, o "
                                 f"ratio {ratio:.3e}, launches {launched}")
    for c, n in zip(counters, saved):
        c.launches = n
    return out


def _cp_counters(attn):
    """The K1, K2, K3 launchers a bf16 substrate runs: ring-flash's K1
    writes f32 chunk outputs."""
    from shallowspeed_tpu_torch.ops import flash_attention as FA

    k1 = FA._flash_fwd_tc_f32o if attn == "ring-flash" else FA._flash_fwd_tc
    return k1, FA._flash_dq_tc, FA._flash_dkv_tc


def _all_train_counters():
    """Every launcher of K1, K2 and K3: `_train_counters`' and K1's
    f32-output build."""
    from shallowspeed_tpu_torch.ops import flash_attention as FA

    tc, fma = _train_counters()
    return (*tc, FA._flash_fwd_tc_f32o, *fma)


def cp_launches_per_step(attn, dp, sp, accum, n_layers, window=0) -> int:
    """K1, K2 and K3 launches (each) of one step, the reference's
    branches: per layer, replica and microbatch, ring-flash sp (sp + 1) /
    2 under causal masking with no window (sp^2 with one),
    ulysses-flash sp (one per cell's head group), flash 1."""
    per = {"ring-flash": sp * (sp + 1) // 2 if window == 0 else sp * sp,
           "ulysses-flash": sp, "flash": 1}[attn]
    return per * dp * accum * n_layers


def _tensor_bytes(tree) -> int:
    from shallowspeed_tpu_torch.weights import leaves

    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if hasattr(x, "element_size"))


def run_context_parallel(dev, cfg, np_params, card) -> dict:
    """Phase 12c: `ContextParallelEngine` at full width and CP_LAYERS
    layers in each CP_LAYOUTS layout (AdamW 3e-4, phase 6's batch and
    weights): the loss at init within PARITY_LOSS_BUDGET and every
    first-step gradient leaf within GRAD_TOL_BF16 of the one-device
    flash engine's (max |diff| / max |ref|); CP_STEPS timed steps with
    the launch counts zeroed before them (K1, K2, K3 each
    `cp_launches_per_step`, the other builds 0), finite and falling
    losses, step p50, tok/s, MFU, the steps' peak memory and the
    optimizer state the cells hold, and one profiled step; then the
    dense dp 2 layout beside ZeRO-1 and ZeRO-2 with the bytes ZeRO
    should free."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.optim import SGD, AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
    from shallowspeed_tpu_torch.weights import leaves

    tok, tgt = _train_batch(cfg)
    cfg = dataclasses.replace(cfg, n_layers=CP_LAYERS)
    np_params = {**np_params, "blocks": np_params["blocks"][:CP_LAYERS]}
    ref = ContextParallelEngine(cfg, SGD(0.0), attn="flash", device=dev,
                                params=np_params)
    ref_loss, ref_grads = ref.loss_and_grads(tok, tgt)
    ref_loss = float(ref_loss)
    ref_grads = [g.to("cpu") for g in leaves(ref_grads)]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    counters = _all_train_counters()
    results, launches = {}, {}
    for name, dp, sp, attn, kw in CP_LAYOUTS:
        t0 = time.perf_counter()
        eng = ContextParallelEngine(
            cfg, AdamW(3e-4, weight_decay=0.01, grad_clip=1.0), attn=attn,
            mesh=make_context_mesh(dp, sp, dev), params=np_params, **kw)
        init_s = time.perf_counter() - t0
        loss0, grads = eng.loss_and_grads(tok, tgt)
        loss0 = float(loss0)
        worst, where = _grad_worst(grads, ref_grads)
        del grads
        print(f"cp {name}: loss at init {loss0:.6f} vs the one-device "
              f"{ref_loss:.6f} (budget {PARITY_LOSS_BUDGET}), worst first-"
              f"step grad leaf {where} at {worst:.3e} of the one-device "
              f"flash engine's (tol {GRAD_TOL_BF16:g})", flush=True)
        if not (abs(loss0 - ref_loss) <= PARITY_LOSS_BUDGET
                and worst <= GRAD_TOL_BF16):
            raise AssertionError(f"cp {name}: loss {loss0} vs {ref_loss}, "
                                 f"grad leaf {where} {worst:.3e}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        losses, step_s = [], []
        for _ in range(CP_STEPS):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(tok, tgt))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        counts = {c.__name__.lstrip("_"): c.launches for c in counters}
        used = _cp_counters(attn)
        n = CP_STEPS * cp_launches_per_step(attn, dp, sp, kw.get("accum", 1),
                                            cfg.n_layers, cfg.attn_window)
        want = {c.__name__.lstrip("_"): (n if c in used else 0)
                for c in counters}
        if counts != want:
            raise AssertionError(f"cp {name}: launches {counts}, want "
                                 f"{want}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"cp {name}: losses {losses}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        p50 = float(np.median(step_s))
        tok_s = TRAIN_BATCH * cfg.max_seq / p50
        perf = mfu(tok_s, cfg, cfg.max_seq, "bf16", device=dev)
        results[name] = {
            "dp": dp, "sp": sp, "attn": attn, **kw,
            "loss_at_init": loss0, "grad_rel_worst": worst,
            "losses": losses, "step_ms": [1e3 * x for x in step_s],
            "step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
            "tflops": perf["tflops"], "mfu": perf["mfu"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "opt_state_gb": _tensor_bytes(
                eng._zero.shards if eng._zero is not None
                else eng._states) / 1e9,
            "params_gb": _tensor_bytes(eng._replicas) / 1e9,
            "launches": {k: v for k, v in counts.items() if v},
            "init_s": init_s}
        print(f"cp layout {name}: " + json.dumps(results[name]) + f"  [{card}]",
              flush=True)
        print(f"cp profile {name}: " + json.dumps(profile_step(eng, tok, tgt)),
              flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    dense, z1, z2 = (results[n] for n in (CP_LAYOUTS[0][0], CP_LAYOUTS[2][0],
                                          CP_LAYOUTS[3][0]))
    per_replica = dense["params_gb"] / 2
    print("cp zero memory: " + json.dumps({
        "dense_dp2": {k: dense[k] for k in ("peak_mem_gb", "opt_state_gb")},
        "zero1_dp2": {k: z1[k] for k in ("peak_mem_gb", "opt_state_gb")},
        "zero2_dp2": {k: z2[k] for k in ("peak_mem_gb", "opt_state_gb")},
        # AdamW's two moments per replica, halved over 2 cells; ZeRO-2
        # also keeps one slice of the reduced f32 gradient a cell instead
        # of a whole copy a replica
        "zero1_should_free_gb": dense["opt_state_gb"] / 2,
        "zero2_should_free_gb": dense["opt_state_gb"] / 2 + per_replica,
        "note": "the layouts differ in substrate and accum too"}) +
        f"  [{card}]", flush=True)
    return {"layouts": results, "launches": launches}


def run_cp_driver(dev, cfg) -> dict:
    """Phase 12d: `train_lm --dp 2 --sp 2 --attn ring-flash --zero2
    --accum 2` at full width and CP_DRIVER_LAYERS layers, CP_DRIVER_STEPS
    steps with a save at the end (K1 f32 o, K2, K3 launches as
    `cp_launches_per_step`); `--resume` of that checkpoint at --dp 1
    --sp 1 --attn flash to CP_DRIVER_STEPS + 2 steps; its losses within
    PARITY_LOSS_BUDGET of a straight (1, 1) run's at the same steps.
    The checkpoints live in a temporary directory removed at the end."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from shallowspeed_tpu_torch import train_lm

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cp_"))
    n, total = CP_DRIVER_LAYERS, CP_DRIVER_STEPS + 2
    flags = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
             "--n-heads", str(cfg.n_heads), "--n-layers", str(n),
             "--d-ff", str(cfg.ffn_dim), "--seq-len", str(cfg.max_seq),
             "--batch-size", str(TRAIN_BATCH), "--rope", "--norm", cfg.norm,
             "--ffn", cfg.ffn, "--optimizer", "adamw", "--lr", "3e-4",
             "--grad-clip", "1.0", "--log-every", "1"]
    if cfg.compute_dtype is not None:
        flags.append("--bf16")
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    counters = _all_train_counters()

    def drive(tag, *extra):
        for c in counters:
            c.launches = 0
        log = root / f"{tag}.jsonl"
        t0 = time.time()
        train_lm.main([*flags, *extra, "--log-file", str(log)])
        wall = time.time() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"losses": [e["loss"] for e in _events(log, "step")],
                "launches": {c.__name__.lstrip("_"): c.launches
                             for c in counters if c.launches},
                "wall_s": wall, "log": log}

    try:
        ck = str(root / "ck")
        a = drive("a", "--dp", "2", "--sp", "2", "--attn", "ring-flash",
                  "--zero2", "--accum", "2", "--steps", str(CP_DRIVER_STEPS),
                  "--save-dir", ck, "--save-every", str(CP_DRIVER_STEPS))
        k = CP_DRIVER_STEPS * cp_launches_per_step("ring-flash", 2, 2, 2, n)
        if a["launches"] != dict.fromkeys(("flash_fwd_tc_f32o",
                                           "flash_dq_tc", "flash_dkv_tc"), k):
            raise AssertionError(f"cp driver: launches {a['launches']}, "
                                 f"want {k} each of K1 (f32 o), K2, K3")
        b = drive("b", "--attn", "flash", "--steps", str(total),
                  "--save-dir", ck, "--resume")
        restore, = _events(b["log"], "restore")
        c = drive("c", "--attn", "flash", "--steps", str(total))
        gap = max(abs(x - y) for x, y in zip(b["losses"],
                                             c["losses"][CP_DRIVER_STEPS:]))
        out = {"losses_dp2_sp2_zero2": a["losses"],
               "losses_resumed_dp1": b["losses"],
               "losses_straight_dp1": c["losses"],
               "resumed_gap": gap, "restore": {
                   k: restore[k] for k in ("path", "step", "verify_s",
                                           "load_s", "place_s")},
               "launches": {"a": a["launches"], "b": b["launches"]},
               "wall_s": {r: x["wall_s"] for r, x in
                          (("a", a), ("b", b), ("c", c))}}
        print("cp driver: " + json.dumps(out), flush=True)
        if not (len(a["losses"]) == CP_DRIVER_STEPS and len(b["losses"]) == 2
                and restore["step"] == CP_DRIVER_STEPS
                and all(np.isfinite(a["losses"] + b["losses"]))
                and gap <= PARITY_LOSS_BUDGET):
            raise AssertionError(f"cp driver: the resumed run {b['losses']} "
                                 f"does not continue the straight run's "
                                 f"{c['losses']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# Phase 13: the GSPMD engine family (tensor, FSDP, composite dp x sp x
# tp, expert parallelism) on the one card, every cell of each grid the
# card. The family runs the plain attention (the reference's GSPMD
# engines run XLA attention), so it launches no K1-K3. Depth is cut to
# GSPMD_LAYERS of 16: the plain attention keeps ~3 f32 (B, H, T, T)
# tensors a layer for its backward (~3.2 GB a layer at 4 x 16 x 2048^2),
# and the script's time (2 before phase 19 came).
GSPMD_LAYERS = 1
GSPMD_STEPS = 3
# name, engine class name, grid axes, grid sizes, options
GSPMD_LAYOUTS = [("tp4", "TensorParallelEngine", ("dp", "tp"), (1, 4), {}),
                 ("dp2-tp2-zero1", "TensorParallelEngine", ("dp", "tp"),
                  (2, 2), {"zero1": True}),
                 ("fsdp-dp4", "FSDPEngine", ("dp",), (4,), {}),
                 ("dp2-sp2-tp2-fsdp", "Composite3DEngine",
                  ("dp", "sp", "tp"), (2, 2, 2), {"fsdp": True}),
                 ("moe-ep4", "ExpertParallelEngine", ("dp", "ep"), (1, 4),
                  {}),
                 ("moe-dp2-sp2-ep2", "ExpertParallelEngine",
                  ("dp", "sp", "ep"), (2, 2, 2), {})]
# 13c's driver at 1 layer (2 before phase 19 came, cut for the script's time)
GSPMD_DRIVER_LAYERS = 1
GSPMD_DRIVER_STEPS = 4


def _gspmd_class(name):
    from shallowspeed_tpu_torch.parallel import (composite, expert, fsdp,
                                                 tensor)

    for mod in (tensor, fsdp, composite, expert):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


def _kernel_counts(counters) -> dict:
    return {c.__name__.lstrip("_"): c.launches for c in counters}


def _timed_steps(dev, eng, mcfg, tok, tgt, counters, label) -> dict:
    """GSPMD_STEPS timed steps of `eng` with the K1-K3 counts zeroed
    before them and 0 after, finite and falling losses: step p50,
    tok/s, MFU, the steps' peak memory."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    losses, step_s = [], []
    for _ in range(GSPMD_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = _kernel_counts(counters)
    if any(counts.values()):
        raise AssertionError(f"gspmd {label}: K1-K3 launches {counts}, "
                             f"want none (plain attention)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"gspmd {label}: losses {losses}")
    p50 = float(np.median(step_s))
    tok_s = TRAIN_BATCH * mcfg.max_seq / p50
    perf = mfu(tok_s, mcfg, mcfg.max_seq, "bf16", device=dev)
    return {"losses": losses, "step_ms": [1e3 * x for x in step_s],
            "step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
            "tflops": perf["tflops"], "mfu": perf["mfu"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": counts}


def run_gspmd(dev, cfg, card, np_params) -> dict:
    """Phase 13a/b: the 1.21B LM's width at GSPMD_LAYERS layers (the
    first of phase 6's weights; MoE at phase 10c's config, its own
    `init_numpy(seed 0)`), phase 6's batch, AdamW
    3e-4. (a) The yardstick: the one-device plain-attention engine
    (`ContextParallelEngine(attn="ring")`; for MoE `ExpertParallelEngine`
    at (1, 1)) on the same weights and batch, its loss and gradient at
    init and its timed steps. (b) Each GSPMD_LAYOUTS layout: the loss at
    init within PARITY_LOSS_BUDGET of (a)'s, every first-step gradient
    leaf within GRAD_TOL_BF16 of (a)'s (max |diff| / max |ref|),
    `_timed_steps`, and the parameter and optimizer bytes the fullest
    cell holds beside the one-device total; one profiled step. MoE's
    loss and gradients are compared in f32 compute: a bf16 ulp moved by
    another blocking of the same products flips a near-tied token's
    expert in a later layer, and that token's whole contribution to a
    leaf (its head column) moves with it."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import SGD, AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_grid
    from shallowspeed_tpu_torch.weights import leaves

    dense = dataclasses.replace(cfg, n_layers=GSPMD_LAYERS)
    moe = dataclasses.replace(dense, n_experts=MOE_EXPERTS, moe_top_k=2,
                              moe_capacity_factor=2.0)
    counters = _all_train_counters()
    results = {}

    def adamw():
        return AdamW(3e-4, weight_decay=0.01, grad_clip=1.0)

    def one_device(c, opt, npm):
        if c.n_experts:
            return ExpertParallelEngine(c, opt, device=dev, params=npm)
        return ContextParallelEngine(c, opt, attn="ring", device=dev,
                                     params=npm)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    for kind, mcfg in (("dense", dense), ("moe", moe)):
        npm = (_first_layers(np_params, mcfg.n_layers) if kind == "dense"
               else T.init_numpy(mcfg, seed=0))
        tok, tgt = _train_batch(mcfg)
        pcfg = (mcfg if kind == "dense"
                else dataclasses.replace(mcfg, compute_dtype=None))
        ref = one_device(pcfg, SGD(0.0), npm)
        ref_loss, grads = ref.loss_and_grads(tok, tgt)
        ref_loss = float(ref_loss)
        ref_grads = [g.to("cpu") for g in leaves(grads)]
        del ref, grads
        release()
        n_params = sum(x.size for x in leaves(npm))
        one_bytes = 3 * 4 * n_params   # f32 masters and AdamW's 2 moments
        eng = one_device(mcfg, adamw(), npm)
        results[f"one-device-{kind}"] = {
            "engine": type(eng).__name__, "layers": mcfg.n_layers,
            "experts": mcfg.n_experts, "params": n_params,
            "loss_at_init": ref_loss, "parity_dtype":
                "bf16" if pcfg is mcfg else "f32",
            **_timed_steps(dev, eng, mcfg, tok, tgt, counters, kind)}
        print(f"gspmd layout one-device-{kind}: "
              + json.dumps(results[f"one-device-{kind}"]) + f"  [{card}]",
              flush=True)
        del eng
        release()
        for name, cls, axes, sizes, kw in GSPMD_LAYOUTS:
            if (cls == "ExpertParallelEngine") != (kind == "moe"):
                continue
            mesh = make_grid(axes, sizes, dev)
            t0 = time.perf_counter()
            eng = _gspmd_class(cls)(pcfg, adamw(), 0, mesh=mesh, params=npm,
                                    **kw)
            init_s = time.perf_counter() - t0
            loss0, grads = eng.loss_and_grads(tok, tgt)
            loss0 = float(loss0)
            worst, where = _grad_worst(grads, ref_grads)
            del grads
            if pcfg is not mcfg:       # the timed engine computes in bf16
                del eng
                release()
                t0 = time.perf_counter()
                eng = _gspmd_class(cls)(mcfg, adamw(), 0, mesh=mesh,
                                        params=npm, **kw)
                init_s = time.perf_counter() - t0
            print(f"gspmd {name}: loss at init {loss0:.6f} vs the one-device "
                  f"engine's {ref_loss:.6f} (budget {PARITY_LOSS_BUDGET}), "
                  f"worst first-step grad leaf {where} at {worst:.3e} "
                  f"(tol {GRAD_TOL_BF16:g})", flush=True)
            if not (abs(loss0 - ref_loss) <= PARITY_LOSS_BUDGET
                    and worst <= GRAD_TOL_BF16):
                raise AssertionError(f"gspmd {name}: loss {loss0} vs "
                                     f"{ref_loss}, grad leaf {where} "
                                     f"{worst:.3e}")
            timed = _timed_steps(dev, eng, mcfg, tok, tgt, counters, name)
            held = eng.cell_bytes()
            full = max(held, key=lambda c: sum(held[c]))
            results[name] = {
                "engine": cls, "grid": dict(zip(axes, sizes)), **kw,
                "layers": mcfg.n_layers, "experts": mcfg.n_experts,
                "parity_dtype": "bf16" if pcfg is mcfg else "f32",
                "loss_at_init": loss0, "yardstick_loss": ref_loss,
                "grad_rel_worst": worst, "grad_rel_worst_leaf": where,
                **timed, "fullest_cell": list(full),
                "fullest_cell_params_gb": held[full][0] / 1e9,
                "fullest_cell_opt_gb": held[full][1] / 1e9,
                "one_device_params_opt_gb": one_bytes / 1e9,
                "init_s": init_s}
            print(f"gspmd layout {name}: " + json.dumps(results[name])
                  + f"  [{card}]", flush=True)
            print(f"gspmd profile {name}: "
                  + json.dumps(profile_step(eng, tok, tgt)), flush=True)
            del eng
            release()
        del npm, ref_grads
    return results


def run_gspmd_driver(dev, cfg) -> dict:
    """Phase 13c: `train_lm --dp 2 --tp 2` at full width and
    GSPMD_DRIVER_LAYERS layers, GSPMD_DRIVER_STEPS steps with a save at
    the end; `--resume` of that checkpoint at `--fsdp --dp 4` to
    GSPMD_DRIVER_STEPS + 2 steps, its losses within PARITY_LOSS_BUDGET of
    a straight `--fsdp --dp 4` run's at the same steps; one `--ep 2
    --experts 4` run of GSPMD_DRIVER_STEPS steps with finite losses (a
    new motif each step: the stream's losses need not fall).
    K1-K3 launch in none of them. The checkpoints live in a temporary
    directory removed at the end."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from shallowspeed_tpu_torch import train_lm

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gspmd_"))
    total = GSPMD_DRIVER_STEPS + 2
    flags = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
             "--n-heads", str(cfg.n_heads),
             "--n-layers", str(GSPMD_DRIVER_LAYERS),
             "--d-ff", str(cfg.ffn_dim), "--seq-len", str(cfg.max_seq),
             "--batch-size", str(TRAIN_BATCH), "--rope", "--norm", cfg.norm,
             "--ffn", cfg.ffn, "--optimizer", "adamw", "--lr", "3e-4",
             "--grad-clip", "1.0", "--log-every", "1"]
    if cfg.compute_dtype is not None:
        flags.append("--bf16")
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    counters = _all_train_counters()

    def drive(tag, *extra):
        for c in counters:
            c.launches = 0
        log = root / f"{tag}.jsonl"
        t0 = time.time()
        train_lm.main([*flags, *extra, "--log-file", str(log)])
        wall = time.time() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        counts = _kernel_counts(counters)
        if any(counts.values()):
            raise AssertionError(f"gspmd driver {tag}: K1-K3 launches "
                                 f"{counts}, want none")
        return {"losses": [e["loss"] for e in _events(log, "step")],
                "wall_s": wall, "log": log}

    try:
        ck = str(root / "ck")
        a = drive("a", "--dp", "2", "--tp", "2",
                  "--steps", str(GSPMD_DRIVER_STEPS), "--save-dir", ck,
                  "--save-every", str(GSPMD_DRIVER_STEPS))
        b = drive("b", "--fsdp", "--dp", "4", "--steps", str(total),
                  "--save-dir", ck, "--resume")
        restore, = _events(b["log"], "restore")
        c = drive("c", "--fsdp", "--dp", "4", "--steps", str(total))
        gap = max(abs(x - y) for x, y in
                  zip(b["losses"], c["losses"][GSPMD_DRIVER_STEPS:]))
        e = drive("e", "--ep", "2", "--experts", str(MOE_EXPERTS),
                  "--steps", str(GSPMD_DRIVER_STEPS))
        out = {"losses_dp2_tp2": a["losses"],
               "losses_resumed_fsdp_dp4": b["losses"],
               "losses_straight_fsdp_dp4": c["losses"],
               "resumed_gap": gap,
               "losses_ep2": e["losses"],
               "restore": {k: restore[k] for k in ("path", "step", "verify_s",
                                                   "load_s", "place_s")},
               "wall_s": {r: x["wall_s"] for r, x in
                          (("a", a), ("b", b), ("c", c), ("e", e))}}
        print("gspmd driver: " + json.dumps(out), flush=True)
        if not (len(a["losses"]) == GSPMD_DRIVER_STEPS
                and len(b["losses"]) == 2
                and restore["step"] == GSPMD_DRIVER_STEPS
                and len(e["losses"]) == GSPMD_DRIVER_STEPS
                and all(np.isfinite(a["losses"] + b["losses"] + e["losses"]))
                and gap <= PARITY_LOSS_BUDGET):
            raise AssertionError(f"gspmd driver: {out}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------- phases 14, 15

# phase 14's depth: 4 of 16 layers (the script's time; phase 15 runs its
# layouts at 16)
PP14_LAYERS = 4

# name, dp, pp, the grid's extra axis ({"tp" | "sp" | "ep": size} or {}),
# schedule, attn, the model's overrides of the 1.21B LM's config, engine
# options
PP_LAYOUTS = [("a-pp4-gpipe-flash", 1, 4, {}, "gpipe", "flash",
               {"n_layers": PP14_LAYERS}, {}),
              ("b-pp4-1f1b-flash", 1, 4, {}, "1f1b", "flash",
               {"n_layers": PP14_LAYERS}, {}),
              ("c-pp4-zb-flash", 1, 4, {}, "zb", "flash",
               {"n_layers": PP14_LAYERS}, {}),
              ("d-dp2-pp2-tp2-1f1b-flash-zero1", 2, 2, {"tp": 2}, "1f1b",
               "flash", {"n_layers": PP14_LAYERS}, {"zero1": True}),
              ("e-dp2-pp2-fsdp-gpipe-flash", 2, 2, {}, "gpipe", "flash",
               {"n_layers": PP14_LAYERS}, {"fsdp": True}),
              ("f-pp2-gpipe-plain", 1, 2, {}, "gpipe", "xla",
               {"n_layers": 4}, {})]
# phase 10c's MoE at its own depth (MOE_LAYERS)
PP_MOE = {"n_layers": MOE_LAYERS, "n_experts": MOE_EXPERTS, "moe_top_k": 2,
          "moe_capacity_factor": 2.0}
# phase 15's depth for (a)-(d): 8 of 16 layers, the least pp 4 x vpp 2
# takes (16 in PR 15; cut for the script's time when phase 16 came)
PP15_LAYERS = 8
# (c) and (d) at 4 layers, cut from 8 for the script's time
PP15_SP_LAYERS = 4
PP15_LAYOUTS = [("a-pp4-vpp2-gpipe-flash", 1, 4, {}, "gpipe", "flash",
                 {"n_layers": PP15_LAYERS}, {"virtual_pp": 2}),
                ("b-pp4-vpp2-1f1b-flash", 1, 4, {}, "1f1b", "flash",
                 {"n_layers": PP15_LAYERS}, {"virtual_pp": 2}),
                ("c-pp2-sp2-gpipe-ring-flash", 1, 2, {"sp": 2}, "gpipe",
                 "ring-flash", {"n_layers": PP15_SP_LAYERS}, {}),
                ("d-pp2-sp2-1f1b-ulysses-flash", 1, 2, {"sp": 2}, "1f1b",
                 "ulysses-flash", {"n_layers": PP15_SP_LAYERS}, {}),
                ("e-moe-pp2-ep2-1f1b-flash", 1, 2, {"ep": 2}, "1f1b",
                 "flash", PP_MOE, {})]
PP_N_MU = 4
PP_STEPS = 2
PP_PROFILED = "b-pp4-1f1b-flash"
PP15_PROFILED = "b-pp4-vpp2-1f1b-flash"
PP_DRIVER_LAYERS = 2
PP15_DRIVER_LAYERS = 4
PP_DRIVER_STEPS = 3
PP_GENERATE = 16


def pp_launches_per_step(schedule, dp, tp, n_mu, n_layers, attn="flash",
                         sp=1, ep=1, window=0) -> dict:
    """K1, K2, K3 launches of one pipeline step: per layer, microbatch,
    data replica (dp x ep) and tp cell, the substrate's per-layer count
    (`cp_launches_per_step`: flash 1, ring-flash sp (sp + 1) / 2 causal
    without a window, ulysses-flash sp), whatever the vpp; K1 twice under
    1f1b (its backward reruns the chunk forward). Under ring-flash K1 is
    its f32-output build."""
    n = cp_launches_per_step(attn, 1, sp, 1, 1, window) * (
        n_layers * n_mu * dp * ep * tp)
    k1 = "flash_fwd_tc_f32o" if attn == "ring-flash" else "flash_fwd_tc"
    return {k1: 2 * n if schedule == "1f1b" else n,
            "flash_dq_tc": n, "flash_dkv_tc": n}


def run_pipeline(dev, cfg, np_params, bf16_loss, card, layouts=PP_LAYOUTS,
                 profiled=PP_PROFILED, vs_a=("b-", "c-"), refs=None,
                 tag="pp") -> dict:
    """Phase 14a-f and 15a-e (see the module docstring): each layout's
    parity against the one-device engine on the same weights at the same
    depth (the flash engine; the plain one on the plain attention; for
    MoE the plain one-device engine over the same microbatches, each
    routing its own tokens, in f32 compute as phase 13 compares MoE,
    loss and gradients within GRAD_TOL_F32, the timed engine then built
    again in bf16), at full depth within PARITY_LOSS_BUDGET of
    `bf16_loss` (phase 6's), the `vs_a` layouts' gradients also against
    the first layout's, launches, step time, MFU, peak memory
    and fullest cell. `refs` caches the yardsticks across calls."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import SGD, AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine
    from shallowspeed_tpu_torch.weights import leaves

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    tok, tgt = _train_batch(cfg)
    refs = {} if refs is None else refs

    def yardstick(model, attn):
        """(loss, host gradient list, numpy weights, parity config) of
        the one-device engine for `model`."""
        mcfg = dataclasses.replace(cfg, **model)
        ref_attn = "flash" if attn != "xla" else "ring"
        key = (tuple(sorted(model.items())), ref_attn)
        if key in refs:
            return refs[key]
        if mcfg.n_experts:
            # the same objective: each microbatch routes and averages
            # its own balance loss, so the yardstick accumulates over
            # the pipeline's PP_N_MU microbatches
            npm = T.init_numpy(mcfg, seed=0)
            pcfg = dataclasses.replace(mcfg, compute_dtype=None)
            ref = ContextParallelEngine(pcfg, SGD(0.0), attn="ring",
                                        device=dev, params=npm,
                                        accum=PP_N_MU)
        else:
            npm = (np_params if mcfg.n_layers == cfg.n_layers else
                   {**np_params,
                    "blocks": np_params["blocks"][:mcfg.n_layers]})
            pcfg = mcfg
            ref = ContextParallelEngine(mcfg, SGD(0.0), attn=ref_attn,
                                        device=dev, params=npm)
        loss, grads = ref.loss_and_grads(tok, tgt)
        refs[key] = (float(loss), [g.to("cpu") for g in leaves(grads)],
                     npm, pcfg)
        del ref, grads
        release()
        return refs[key]

    counters = _all_train_counters()
    results, launches, first_grads = {}, {}, None
    for name, dp, pp, grid, schedule, attn, model, kw in layouts:
        mcfg = dataclasses.replace(cfg, **model)
        layers = mcfg.n_layers
        ref_loss, ref_grads, npm, pcfg = yardstick(model, attn)
        ep, sp = grid.get("ep", 1), grid.get("sp", 1)
        n_mu = PP_N_MU // (dp * ep)

        def engine(c):
            return PipelineLMEngine(
                c, AdamW(3e-4, weight_decay=0.01, grad_clip=1.0),
                make_pipeline_mesh(dp, pp, grid.get("tp", 1), dev, sp=sp,
                                   ep=ep), n_mubatches=n_mu,
                schedule=schedule, attn=attn, params=npm, **kw)

        t0 = time.perf_counter()
        eng = engine(pcfg)
        init_s = time.perf_counter() - t0
        loss0, grads = eng.loss_and_grads(tok, tgt)
        loss0 = float(loss0)
        want_loss = (bf16_loss if model == {"n_layers": cfg.n_layers}
                     else ref_loss)
        worst, where = _grad_worst(grads, ref_grads)
        vs = None
        if first_grads is None:
            first_grads = [g.to("cpu") for g in leaves(grads)]
        elif name.startswith(vs_a):
            vs = _grad_worst(grads, first_grads)
        del grads
        if pcfg != mcfg:                # the timed engine computes in bf16
            del eng
            release()
            t0 = time.perf_counter()
            eng = engine(mcfg)
            init_s = time.perf_counter() - t0
        if pcfg == mcfg:                # bf16 against the flash engine
            loss_err = abs(loss0 - want_loss)
            loss_tol, grad_tol = PARITY_LOSS_BUDGET, GRAD_TOL_BF16
            how = "budget"
        else:                           # f32, as phase 7's parity
            loss_err = abs(loss0 - want_loss) / abs(want_loss)
            loss_tol, grad_tol = GRAD_TOL_F32, GRAD_TOL_F32
            how = "relative, tol"
        print(f"{tag} {name}: loss at init {loss0:.6f} vs {want_loss:.6f} "
              f"({how} {loss_tol:g}: {loss_err:.3e}), worst first-step "
              f"grad leaf {where} at {worst:.3e} of the one-device "
              f"engine's (tol {grad_tol:g})"
              + ("" if vs is None else
                 f", {vs[1]} at {vs[0]:.3e} of (a)'s (tol "
                 f"{GRAD_TOL_BF16:g})"), flush=True)
        if not (loss_err <= loss_tol and worst <= grad_tol
                and (vs is None or vs[0] <= GRAD_TOL_BF16)):
            raise AssertionError(f"{tag} {name}: loss {loss0} vs "
                                 f"{want_loss}, grad leaf {where} "
                                 f"{worst:.3e}, vs (a) {vs}")
        release()
        # a warm-up step, whose allocations the timed steps then reuse
        eng.train_batch(tok, tgt)
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        losses, step_s = [], []
        for _ in range(PP_STEPS):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(tok, tgt))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        counts = _kernel_counts(counters)
        per = (pp_launches_per_step(schedule, dp, grid.get("tp", 1), n_mu,
                                    layers, attn=attn, sp=sp, ep=ep)
               if attn != "xla" else {})
        want = {k: PP_STEPS * per.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{tag} {name}: launches {counts}, want "
                                 f"{want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{tag} {name}: losses {losses}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        p50 = float(np.median(step_s))
        tok_s = TRAIN_BATCH * cfg.max_seq / p50
        perf = mfu(tok_s, mcfg, cfg.max_seq, "bf16", device=dev)
        held = eng.cell_bytes()
        full = max(held, key=lambda c: sum(held[c]))
        results[name] = {
            "dp": dp, "pp": pp, **grid, "schedule": schedule, "attn": attn,
            "layers": layers, "experts": mcfg.n_experts, "n_mu": n_mu, **kw,
            "parity_dtype": "bf16" if pcfg == mcfg else "f32",
            "loss_at_init": loss0, "yardstick_loss": want_loss,
            "loss_tol": loss_tol, "grad_tol": grad_tol,
            "grad_rel_worst": worst, "grad_rel_worst_leaf": where,
            "grad_rel_vs_a": None if vs is None else vs[0],
            "losses": losses, "step_ms": [1e3 * x for x in step_s],
            "step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
            "tflops": perf["tflops"], "mfu": perf["mfu"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "fullest_cell": list(full),
            "fullest_cell_params_gb": held[full][0] / 1e9,
            "fullest_cell_opt_gb": held[full][1] / 1e9,
            "launches_per_step": {k: v // PP_STEPS
                                  for k, v in counts.items() if v},
            "stash_peak": eng.peak_stash, "init_s": init_s}
        print(f"pp layout {name}: " + json.dumps(results[name])
              + f"  [{card}]", flush=True)
        if name == profiled:
            print(f"pp profile {name}: "
                  + json.dumps(profile_step(eng, tok, tgt)), flush=True)
        del eng
        release()
    return {"layouts": results, "launches": launches, "refs": refs}


# phase 14g's and 15f's driver runs: (the first run's flags and schedule
# knobs for its launch formula), the resumed layout's, and the decode's
# (None for 14g: 15f makes the pipelined decode)
PP_DRIVER = {
    "14": (PP_DRIVER_LAYERS,
           (["--pp", "2", "--pp-schedule", "zb"], ("zb", 1, 1, {})),
           (["--dp", "2", "--pp", "2", "--tp", "2", "--pp-schedule",
             "1f1b"], ("1f1b", 2, 2, {})),
           None),
    "15": (PP15_DRIVER_LAYERS,
           (["--pp", "2", "--virtual-pp", "2", "--pp-schedule", "1f1b"],
            ("1f1b", 1, 1, {})),
           (["--pp", "2", "--sp", "2", "--attn", "ring-flash"],
            ("gpipe", 1, 1, {"attn": "ring-flash", "sp": 2})),
           ["--pp", "2", "--virtual-pp", "2"]),
}


def run_pp_driver(dev, cfg, phase="14") -> dict:
    """Phase 14g / 15f: `train_lm` at full width and the phase's driver
    depth (PP_DRIVER): the first layout with `--attn flash`,
    PP_DRIVER_STEPS steps and a save; `--resume` in the second layout to
    PP_DRIVER_STEPS + 2 steps, within PARITY_LOSS_BUDGET of a straight
    run of that layout; then (15f) `--sample-only --generate PP_GENERATE
    --temperature 0` through the pipelined decode on the resumed run's
    checkpoint, whose printed stream must equal
    `models.generate.generate`'s greedy stream on that checkpoint's
    parameters and prompt. K1-K3 (under ring-flash K1's f32-output
    build) launch as `pp_launches_per_step` says in the training runs.
    The checkpoints live in a temporary directory removed at the end."""
    import contextlib
    import io
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from shallowspeed_tpu_torch import checkpoint, train_lm
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.models.generate import generate
    from shallowspeed_tpu_torch.weights import params_from_numpy

    layers, (first, fk), (then, tk), gen = PP_DRIVER[phase]
    label = f"pp{'' if phase == '14' else phase} driver"
    root = Path(tempfile.mkdtemp(prefix=f"chip_smoke_pp{phase}_"))
    total = PP_DRIVER_STEPS + 2
    flags = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
             "--n-heads", str(cfg.n_heads), "--n-layers", str(layers),
             "--d-ff", str(cfg.ffn_dim), "--seq-len", str(cfg.max_seq),
             "--batch-size", str(TRAIN_BATCH), "--rope", "--norm", cfg.norm,
             "--ffn", cfg.ffn, "--optimizer", "adamw", "--lr", "3e-4",
             "--grad-clip", "1.0", "--log-every", "1", "--attn", "flash",
             "--n-mubatches", "2"]
    if cfg.compute_dtype is not None:
        flags.append("--bf16")
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    counters = _all_train_counters()

    def per_step(knobs):
        schedule, dp, tp, extra = knobs
        return pp_launches_per_step(schedule, dp, tp, 2, layers, **extra)

    def drive(tag, steps, per, *extra):
        for c in counters:
            c.launches = 0
        log = root / f"{tag}.jsonl"
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            train_lm.main([*flags, *extra, "--log-file", str(log)])
        wall = time.time() - t0
        print(out.getvalue(), end="", flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        counts = _kernel_counts(counters)
        want = {k: steps * per.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{label} {tag}: launches {counts}, "
                                 f"want {want}")
        return {"losses": [e["loss"] for e in _events(log, "step")],
                "wall_s": wall, "log": log, "out": out.getvalue()}

    try:
        ck = str(root / "ck")
        a = drive("a", PP_DRIVER_STEPS, per_step(fk), *first, "--steps",
                  str(PP_DRIVER_STEPS), "--save-dir", ck, "--save-every",
                  str(PP_DRIVER_STEPS))
        b = drive("b", 2, per_step(tk), *then, "--steps", str(total),
                  "--save-dir", ck, "--resume")
        restore, = _events(b["log"], "restore")
        c = drive("c", total, per_step(tk), *then, "--steps", str(total))
        gap = max(abs(x - y) for x, y in
                  zip(b["losses"], c["losses"][PP_DRIVER_STEPS:]))
        runs = [("a", a), ("b", b), ("c", c)]
        out = {"first": " ".join(first), "then": " ".join(then),
               "losses_first": a["losses"], "losses_resumed": b["losses"],
               "losses_straight": c["losses"], "resumed_gap": gap,
               "restore": {k: restore[k] for k in ("path", "step", "verify_s",
                                                   "load_s", "place_s")}}
        ok = (len(a["losses"]) == PP_DRIVER_STEPS and len(b["losses"]) == 2
              and restore["step"] == PP_DRIVER_STEPS
              and all(np.isfinite(a["losses"] + b["losses"]))
              and gap <= PARITY_LOSS_BUDGET)
        if gen is not None:
            gen_argv = [*gen, "--save-dir", ck, "--sample-only",
                        "--generate", str(PP_GENERATE), "--temperature", "0"]
            d = drive("d", 0, {}, *gen_argv)
            runs.append(("d", d))
            sample = [x for x in d["out"].splitlines()
                      if x.startswith("sample: ")]
            args = train_lm.parse_args([*flags, *gen_argv])
            prompt = train_lm.make_batch(args, cfg.vocab, 0)[0][:1, :16]
            mcfg = dataclasses.replace(cfg, n_layers=layers)
            params = params_from_numpy(checkpoint.load_params(
                checkpoint.latest(ck), T.param_shapes(mcfg)), dev)
            want = generate(params, prompt, mcfg, PP_GENERATE,
                            temperature=0.0)
            del params
            out.update(decode=" ".join(gen), sample=sample,
                       generate_stream=[int(x) for x in want[0]])
            ok = (ok and "pp-sharded decode" in d["out"]
                  and sample == ["sample: " + train_lm._show(want[0])])
        out["wall_s"] = {r: x["wall_s"] for r, x in runs}
        print(f"{label}: " + json.dumps(out), flush=True)
        if not ok:
            raise AssertionError(f"{label}: {out}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 16

# Phase 16: comm overlap (`parallel/overlap.py`), every cell the card.
# (a) the data-parallel flash engine at full width and depth, overlap
# off and on at two bucket sizes; (b)-(e) at cut depth (the script's
# time): ZeRO-2 with accumulation at OV_Z2_LAYERS, FSDP on the plain
# attention at OV_FSDP_LAYERS, the MLP engines, the drivers at
# OV_DRIVER_LAYERS.
OV_VARIANTS = (("off", None), ("on-4mb", 4.0), ("on-64mb", 64.0))
OV_STEPS = 4
# (b) and (c) at 1 layer (2 before phase 21 came, cut for the script's
# time)
OV_Z2_LAYERS = 1
# (a)'s depth: 1 of 16 layers, cut for the script's time (16 before
# phase 17 came, 8 before phase 19, 4 before phase 20, 2 before 21)
OV_LAYERS = 1
OV_FSDP_LAYERS = 1
OV_SHORT_STEPS = 2
OV_MLP_BATCHES = 6
# 16e's drivers at 1 layer (2 before phase 19 came, cut for the script's time)
OV_DRIVER_LAYERS = 1
OV_DRIVER_STEPS = 3


def _union(spans) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(spans, union) -> float:
    """The length of `spans` (disjoint, sorted) that lies inside
    `union` (disjoint, sorted)."""
    total, j = 0.0, 0
    for s, e in spans:
        while j < len(union) and union[j][1] <= s:
            j += 1
        k = j
        while k < len(union) and union[k][0] < e:
            total += min(e, union[k][1]) - max(s, union[k][0])
            k += 1
    return total


def stream_overlap(fn) -> dict:
    """fn() once under torch.profiler, the device's work split by CUDA
    stream (the profiler's `device_resource_id`): the main stream is the
    busiest, every other one the side. Returns the side stream's busy ms
    (the union of its kernels' and copies' intervals), the ms of it that
    coincide with main-stream work (and that as a share of the side's
    busy ms), the main stream's busy ms, and the host-idle share: 1 -
    the union of all device intervals / the call's wall time (an upper
    bound: the profiler lengthens the call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_stream: dict = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        by_stream.setdefault(ev.device_resource_id, []).append(
            (ev.time_range.start / 1e3, ev.time_range.end / 1e3))
    if not by_stream:
        return {"wall_ms": wall_ms, "device_kernels": 0}
    unions = {s: _union(v) for s, v in by_stream.items()}
    busy = {s: sum(e - b for b, e in u) for s, u in unions.items()}
    main = max(busy, key=busy.get)
    side = _union([iv for s, v in by_stream.items() if s != main
                   for iv in v])
    side_ms = sum(e - b for b, e in side)
    both = _covered(side, unions[main])
    every = _union([iv for v in by_stream.values() for iv in v])
    return {"wall_ms": wall_ms,
            "device_kernels": sum(map(len, by_stream.values())),
            "streams": len(by_stream), "main_busy_ms": busy[main],
            "side_busy_ms": side_ms, "side_kernels": sum(
                len(v) for s, v in by_stream.items() if s != main),
            "overlapped_ms": both,
            "overlapped_share": both / side_ms if side_ms else None,
            "device_busy_ms": sum(e - b for b, e in every),
            "host_idle_share": 1.0 - sum(e - b for b, e in every) / wall_ms}


def _bit_diff(got, ref) -> dict:
    """Leaf by leaf (tensors or floats): how many differ in any bit, and
    the worst max |diff| / max |ref| with its index."""
    import torch

    n, worst, where = 0, 0.0, None
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = (torch.as_tensor(x) for x in (a, b))
        if torch.equal(a, b.to(a.device)):
            continue
        n += 1
        b = b.to(a.device).float()
        rel = float((a.float() - b).abs().max()
                    / b.abs().max().clamp_min(1e-30))
        if not rel <= worst:
            worst, where = rel, i
    return {"leaves": len(ref), "differing": n, "worst_rel": worst,
            "worst_leaf": where}


def _ov_grads(eng, tok, tgt) -> list:
    """[loss, every gradient leaf] of one `loss_and_grads` call."""
    from shallowspeed_tpu_torch.weights import leaves

    loss, grads = eng.loss_and_grads(tok, tgt)
    return [float(loss)] + list(leaves(grads))


def _ov_steps(dev, eng, tok, tgt, n, counters, cfg) -> dict:
    """A warm-up step, then `n` timed steps with the K1-K3 counts zeroed
    before them: their losses, step p50, tok/s, MFU, peak memory, the
    launches and the buckets issued on the side stream."""
    import torch

    from shallowspeed_tpu_torch.flops import mfu
    from shallowspeed_tpu_torch.parallel.overlap import BucketReducer

    eng.train_batch(tok, tgt)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    side0 = BucketReducer.side_buckets
    losses, step_s = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    p50 = float(np.median(step_s))
    tok_s = tok.shape[0] * tok.shape[1] / p50
    perf = mfu(tok_s, cfg, tok.shape[1], "bf16", device=dev)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"overlap: losses {losses}")
    return {"losses": losses, "step_ms": [1e3 * x for x in step_s],
            "step_ms_p50": 1e3 * p50, "tok_per_s": tok_s,
            "tflops": perf["tflops"], "mfu": perf["mfu"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": {c.__name__.lstrip("_"): c.launches
                         for c in counters if c.launches},
            "side_buckets": BucketReducer.side_buckets - side0}


def _ov_pair_check(label, entry, ref_losses, bitwise_ok) -> None:
    """On against off: the first-step loss and every gradient leaf bit
    for bit and the timed steps' losses equal (or, where two overlap-off
    runs are not bit-equal on the card, within their spread)."""
    cmp = entry["vs_off"]
    if bitwise_ok:
        ok = cmp["differing"] == 0 and entry["losses"] == ref_losses
    else:
        ok = cmp["worst_rel"] <= entry["off_spread"]
    if not ok or entry["side_buckets"] <= 0:
        raise AssertionError(f"overlap {label}: {json.dumps(entry)}")


def run_overlap(dev, cfg, np_params, card) -> dict:
    """Phase 16a: `ContextParallelEngine` dp 2 flash at full width and
    depth (phase 6's batch and weights, AdamW 3e-4), overlap off, then on
    at 4 and 64 MiB buckets: the first-step loss and every gradient leaf
    of each against off's, bit for bit (two overlap-off calls first: if
    they are not bit-equal, on is held within their spread and the phase
    says so); a warm-up and OV_STEPS timed steps with the counts zeroed
    before them (K1, K2, K3 on their tensor-core builds 2 x n_layers a
    step each), their losses equal to off's; step p50, tok/s, MFU, peak
    memory; two profiled steps each, the second reported
    (`stream_overlap`: the side stream's busy and overlapped ms, the
    host-idle share)."""
    import torch

    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
    from shallowspeed_tpu_torch.parallel.overlap import OverlapConfig

    tok, tgt = _train_batch(cfg)
    counters = _all_train_counters()
    n = OV_STEPS * 2 * cfg.n_layers
    want = {"flash_fwd_tc": n, "flash_dq_tc": n, "flash_dkv_tc": n}
    results, ref, spread, launches = {}, None, None, {}
    for name, mb in OV_VARIANTS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = ContextParallelEngine(
            cfg, AdamW(3e-4, weight_decay=0.01, grad_clip=1.0),
            attn="flash", mesh=make_context_mesh(2, 1, dev),
            params=np_params,
            overlap=None if mb is None else OverlapConfig(bucket_mb=mb))
        init_s = time.perf_counter() - t0
        got = _ov_grads(eng, tok, tgt)
        entry = {"bucket_mb": mb, "buckets": len(eng._plan or ()),
                 "init_s": init_s}
        if ref is None:
            again = _ov_grads(eng, tok, tgt)
            spread = _bit_diff(again, got)
            print(f"overlap off against off (two calls, one engine): "
                  f"{json.dumps(spread)}  [{card}]", flush=True)
            ref = got
        else:
            entry["vs_off"] = _bit_diff(got, ref)
        del got
        entry.update(_ov_steps(dev, eng, tok, tgt, OV_STEPS, counters, cfg))
        # (on the CPU, a rehearsal, the wrappers count nothing)
        if dev.type == "cuda" and entry["launches"] != want:
            raise AssertionError(f"overlap {name}: launches "
                                 f"{entry['launches']}, want {want}")
        # the second of two profiled steps: the profiler's first use in
        # the process pays its own start-up
        stream_overlap(lambda: eng.train_batch(tok, tgt))
        entry["profile"] = stream_overlap(lambda: eng.train_batch(tok, tgt))
        if name == "off":
            off_losses = entry["losses"]
            if entry["side_buckets"]:
                raise AssertionError("overlap off issued side-stream buckets")
        else:
            entry["off_spread"] = spread["worst_rel"]
            _ov_pair_check(name, entry, off_losses,
                           spread["differing"] == 0)
            launches = entry["launches"]
        results[name] = entry
        print(f"overlap layout {name}: " + json.dumps(entry) + f"  [{card}]",
              flush=True)
        del eng
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    summary = {k: {"step_ms_p50": v["step_ms_p50"],
                   "side_busy_ms": v["profile"].get("side_busy_ms"),
                   "overlapped_ms": v["profile"].get("overlapped_ms"),
                   "overlapped_share": v["profile"].get("overlapped_share"),
                   "host_idle_share": v["profile"].get("host_idle_share")}
               for k, v in results.items()}
    print("overlap (a): " + json.dumps(summary) + f"  [{card}]", flush=True)
    return {"results": results, "launches": launches}


def _ov_lm_pair(dev, label, build, tok, tgt, n, counters, cfg, want, card):
    """Off and on engines of one layout (`build(overlap)`), one after
    the other: on's first-step loss and gradient leaves against off's,
    bit for bit, both trajectories' losses equal, launches `want`."""
    import torch

    from shallowspeed_tpu_torch.parallel.overlap import OverlapConfig

    out, ref = {}, None
    for name, ov in (("off", None), ("on", OverlapConfig(bucket_mb=4.0))):
        gc.collect()
        torch.cuda.empty_cache()
        eng = build(ov)
        got = _ov_grads(eng, tok, tgt)
        entry = {}
        if ref is None:
            ref = got
        else:
            entry["vs_off"] = _bit_diff(got, ref)
        del got
        entry.update(_ov_steps(dev, eng, tok, tgt, n, counters, cfg))
        if dev.type == "cuda" and entry["launches"] != want:
            raise AssertionError(f"overlap {label} {name}: launches "
                                 f"{entry['launches']}, want {want}")
        if ov is not None:
            entry["off_spread"] = 0.0
            _ov_pair_check(f"{label} {name}", entry, out["off"]["losses"],
                           True)
        out[name] = entry
        del eng
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    print(f"overlap {label}: " + json.dumps(out) + f"  [{card}]", flush=True)
    return out


def run_overlap_zero2(dev, cfg, np_params, card) -> dict:
    """Phase 16b: dp 2 x sp 2 ring-flash ZeRO-2 accum 2 at OV_Z2_LAYERS
    layers (K1's f32-output build), overlap off against on: bit for bit,
    launches `cp_launches_per_step` each, step p50."""
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh

    tok, tgt = _train_batch(cfg)
    mcfg = dataclasses.replace(cfg, n_layers=OV_Z2_LAYERS)
    params = {**np_params, "blocks": np_params["blocks"][:OV_Z2_LAYERS]}
    n = OV_SHORT_STEPS * cp_launches_per_step("ring-flash", 2, 2, 2,
                                              OV_Z2_LAYERS)
    return _ov_lm_pair(
        dev, "(b) dp2-sp2-ring-flash-zero2-accum2",
        lambda ov: ContextParallelEngine(
            mcfg, AdamW(3e-4, weight_decay=0.01, grad_clip=1.0),
            attn="ring-flash", mesh=make_context_mesh(2, 2, dev),
            zero2=True, accum=2, params=params, overlap=ov),
        tok, tgt, OV_SHORT_STEPS, _all_train_counters(), mcfg,
        {"flash_fwd_tc_f32o": n, "flash_dq_tc": n, "flash_dkv_tc": n}, card)


def run_overlap_fsdp(dev, cfg, np_params, card) -> dict:
    """Phase 16c: `FSDPEngine` dp 4 at OV_FSDP_LAYERS layers on the plain
    attention (AdamW): overlap off against on, bit for bit, no K1-K3
    launch, step p50; then the Adafactor refusal, shown."""
    from shallowspeed_tpu_torch.optim import Adafactor, AdamW
    from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_fsdp_mesh
    from shallowspeed_tpu_torch.parallel.overlap import OverlapConfig

    tok, tgt = _train_batch(cfg)
    mcfg = dataclasses.replace(cfg, n_layers=OV_FSDP_LAYERS)
    params = {**np_params, "blocks": np_params["blocks"][:OV_FSDP_LAYERS]}
    out = _ov_lm_pair(
        dev, "(c) fsdp-dp4",
        lambda ov: FSDPEngine(mcfg, AdamW(3e-4, weight_decay=0.01,
                                          grad_clip=1.0),
                              mesh=make_fsdp_mesh(4, dev), params=params,
                              overlap=ov),
        tok, tgt, OV_SHORT_STEPS, _all_train_counters(), mcfg, {}, card)
    try:
        FSDPEngine(mcfg, Adafactor(3e-4), mesh=make_fsdp_mesh(4, dev),
                   params=params, overlap=OverlapConfig())
    except ValueError as err:
        if "Adafactor" not in str(err):
            raise
        print(f"overlap (c) fsdp-dp4 with Adafactor refused: {err}",
              flush=True)
    else:
        raise AssertionError("overlap (c): FSDP with Adafactor and overlap "
                             "was not refused")
    return out


class _OvShard:
    """A seeded (n_mu, mubs, d) microbatch stack per batch (numpy seed
    [seed, batch]): `Dataset.load_mubatch_stack`'s interface."""

    def __init__(self, seed, n_mu, mubs, d_in, d_out):
        self.seed, self.n_mu, self.mubs = seed, n_mu, mubs
        self.d_in, self.d_out = d_in, d_out

    def load_mubatch_stack(self, batch_id):
        rng = np.random.default_rng([self.seed, batch_id])
        x = rng.standard_normal((self.n_mu, self.mubs, self.d_in)
                                ).astype(np.float32)
        y = np.eye(self.d_out, dtype=np.float32)[
            rng.integers(0, self.d_out, (self.n_mu, self.mubs))]
        return x, y


def run_overlap_mlp(dev, card) -> dict:
    """Phase 16d: the MLP engines at the reference's width (global batch
    128, 4 microbatches, SGD 0.006): `FusedDPEngine` dp 2 and
    `SPMDPipelineEngine` dp 2 x pp 2 in both hop modes, OV_MLP_BATCHES
    batches, each overlapped engine's parameters bit for bit its
    overlap-off twin's; batch ms p50 and the ticks `schedule_info`
    implies."""
    import torch

    from shallowspeed_tpu_torch.engine import FusedDPEngine
    from shallowspeed_tpu_torch.models.mlp import MLPStage
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel.mesh import make_mesh
    from shallowspeed_tpu_torch.parallel.overlap import (BucketReducer,
                                                         OverlapConfig)
    from shallowspeed_tpu_torch.parallel.spmd_pipeline import (
        SPMDPipelineEngine)
    from shallowspeed_tpu_torch.train import LAYER_SIZES, LR

    gbs, n_mu, dp = 128, 4, 2
    mubs = gbs // dp // n_mu
    shards = [_OvShard(r, n_mu, mubs, LAYER_SIZES[0], LAYER_SIZES[-1])
              for r in range(dp)]
    builds = {
        "fused-dp2": lambda ov: FusedDPEngine(
            MLPStage(LAYER_SIZES, 0, 1, batch_size=gbs), SGD(LR),
            make_mesh(dp, 1, dev), overlap=ov),
        "spmd-dp2-pp2": lambda ov: SPMDPipelineEngine(
            LAYER_SIZES, SGD(LR), make_mesh(dp, 2, dev), n_mu, mubs, gbs,
            overlap=ov)}
    out = {}
    for name, build in builds.items():
        hops = (None,) if name.startswith("fused") else (False, True)
        runs = {}
        for tag, ov in [("off", None)] + [
                (f"on{'' if db is None else '-db' if db else '-single'}",
                 OverlapConfig(bucket_mb=0.25, double_buffer_hops=bool(db)))
                for db in hops]:
            eng = build(ov)
            side0 = BucketReducer.side_buckets
            ms = []
            for b in range(OV_MLP_BATCHES):
                t0 = time.perf_counter()
                eng.train_batch(b, shards)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            flat = _mlp_flat(eng)
            entry = {"batch_ms_p50": float(np.median(ms)),
                     "side_buckets": BucketReducer.side_buckets - side0,
                     "buckets": len(eng._plan or ())}
            if hasattr(eng, "schedule_info"):
                entry["schedule_info"] = eng.schedule_info()
                entry["ticks"] = eng.ticks
            if tag == "off":
                ref = flat
            else:
                same = all(torch.equal(a, b) for a, b in zip(flat, ref))
                entry["bit_identical_to_off"] = same
                if not same or entry["side_buckets"] <= 0:
                    raise AssertionError(f"overlap (d) {name} {tag}: "
                                         f"{json.dumps(entry)}")
            runs[tag] = entry
            del eng
        out[name] = runs
    print("overlap (d) mlp: " + json.dumps(out) + f"  [{card}]", flush=True)
    return out


def run_overlap_driver(dev, cfg, card) -> dict:
    """Phase 16e: `train_lm --dp 2 --attn flash --overlap on --bucket-mb
    4` at full width and OV_DRIVER_LAYERS layers, OV_DRIVER_STEPS steps
    and a save (K1-K3 2 x n_layers a step each), resumed with overlap
    off to OV_DRIVER_STEPS + 2 steps, its losses within
    PARITY_LOSS_BUDGET of a straight overlap-off run's; then `train --dp
    2 --pp 2 --engine spmd --overlap on` (the MLP driver, 20 batches) and
    the same run with overlap off: accuracy rises, the two model hashes
    equal. The files live in a temporary directory removed at the end."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from shallowspeed_tpu_torch import train_lm
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ov_"))
    n, total = OV_DRIVER_LAYERS, OV_DRIVER_STEPS + 2
    flags = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
             "--n-heads", str(cfg.n_heads), "--n-layers", str(n),
             "--d-ff", str(cfg.ffn_dim), "--seq-len", str(cfg.max_seq),
             "--batch-size", str(TRAIN_BATCH), "--rope", "--norm", cfg.norm,
             "--ffn", cfg.ffn, "--optimizer", "adamw", "--lr", "3e-4",
             "--grad-clip", "1.0", "--log-every", "1", "--dp", "2",
             "--attn", "flash"]
    if cfg.compute_dtype is not None:
        flags.append("--bf16")
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    counters = _all_train_counters()

    def drive(tag, *extra):
        for c in counters:
            c.launches = 0
        log = root / f"{tag}.jsonl"
        t0 = time.time()
        train_lm.main([*flags, *extra, "--log-file", str(log)])
        wall = time.time() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"losses": [e["loss"] for e in _events(log, "step")],
                "launches": {c.__name__.lstrip("_"): c.launches
                             for c in counters if c.launches},
                "wall_s": wall, "log": log}

    try:
        ck = str(root / "ck")
        a = drive("a", "--overlap", "on", "--bucket-mb", "4", "--steps",
                  str(OV_DRIVER_STEPS), "--save-dir", ck, "--save-every",
                  str(OV_DRIVER_STEPS))
        k = OV_DRIVER_STEPS * 2 * n
        if dev.type == "cuda" and a["launches"] != dict.fromkeys(
                ("flash_fwd_tc", "flash_dq_tc", "flash_dkv_tc"), k):
            raise AssertionError(f"overlap driver: launches {a['launches']}"
                                 f", want {k} each of K1, K2, K3")
        b = drive("b", "--steps", str(total), "--save-dir", ck, "--resume")
        c = drive("c", "--steps", str(total))
        gap = max(abs(x - y) for x, y in zip(
            a["losses"] + b["losses"], c["losses"]))
        data_dir = str(prepare_mnist(root / "mnist", synthetic=True))
        mlp = {}
        for tag in ("on", "off"):
            mlp[tag] = _mlp_drive([
                "--data-dir", data_dir, "--dp", "2", "--pp", "2",
                "--schedule", "gpipe", "--engine", "spmd", "--overlap", tag,
                "--epochs", "1", "--max-batches", "20", "--log-file",
                str(root / f"mlp_{tag}.jsonl"),
                *(["--device", "cpu"] if dev.type == "cpu" else [])])
            del mlp[tag]["flat"]
        out = {"losses_overlap_on": a["losses"],
               "losses_resumed_off": b["losses"],
               "losses_straight_off": c["losses"], "gap": gap,
               "launches": a["launches"],
               "wall_s": {r: x["wall_s"] for r, x in
                          (("a", a), ("b", b), ("c", c))},
               "mlp_spmd": mlp,
               "mlp_hashes_equal": mlp["on"]["hash"] == mlp["off"]["hash"]}
        print("overlap (e) drivers: " + json.dumps(out) + f"  [{card}]",
              flush=True)
        if not (len(a["losses"]) == OV_DRIVER_STEPS
                and len(b["losses"]) == 2 and gap <= PARITY_LOSS_BUDGET
                and all(np.isfinite(a["losses"] + b["losses"]))
                and out["mlp_hashes_equal"]):
            raise AssertionError(f"overlap drivers: {json.dumps(out)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 17

# Phase 17: the multi-process launch (`shallowspeed_tpu_torch.
# distributed`). This script starts two worker processes of itself on the
# one card (`--phase17-worker`, the reference's three variables' values
# as arguments, a free local port); two processes share the card, so the
# transport is gloo with CUDA tensors staged through pinned host
# buffers. (a) the LM pipeline at MP_LAYERS of 16 layers, pp across the
# processes; (b) the context engine at dp 2 across them and (c) the
# checkpoint at MP_SMALL_LAYERS; (d) `train_lm --pp 2` launched as two
# processes. Each held bit for bit against the same run in one process.
MP_LAYERS = PP14_LAYERS
MP_SMALL_LAYERS = 2
MP_STEPS = 3
MP_SCHEDULES = ("gpipe", "1f1b")
MP_TIMEOUT = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _leaf_sha1s(tree) -> list:
    import hashlib

    from shallowspeed_tpu_torch.utils import tree_leaves
    from shallowspeed_tpu_torch.weights import to_host

    return [hashlib.sha1(np.ascontiguousarray(to_host(x)).tobytes())
            .hexdigest() for x in tree_leaves(tree)]


def _mp_describe(cfg) -> dict:
    """`cfg` as JSON, for the workers (`_mp_config` rebuilds it)."""
    import torch

    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name not in ("dtype", "compute_dtype")}
    out["bf16"] = cfg.compute_dtype == torch.bfloat16
    return out


def _mp_config(desc):
    import torch

    from shallowspeed_tpu_torch.models import transformer as T

    desc = dict(desc)
    bf16 = desc.pop("bf16")
    return T.TransformerConfig(**desc, dtype=np.float32,
                               compute_dtype=torch.bfloat16 if bf16
                               else None)


def _mp_steps(dev, eng, tok, tgt, counters, steps=MP_STEPS) -> dict:
    """`steps` timed steps of `eng` with the K1-K3 counts and the
    transport's counters zeroed before them: the losses (repr, exact),
    launches, step times, peak memory, the bytes a step moves between
    processes by hops and by sums, the share of the steps in transfers
    and in host-staged copies, and the sha1 of every parameter leaf at
    the end (a collective fetch across processes)."""
    import torch

    from shallowspeed_tpu_torch import distributed as D

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    D.reset_stats()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(tok, tgt))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    stats, total = dict(D.STATS), sum(step_s)
    out = {"losses": [repr(x) for x in losses],
           "launches": _kernel_counts(counters),
           "step_ms": [1e3 * x for x in step_s],
           "step_ms_p50": 1e3 * float(np.median(step_s)),
           "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
           "send_mb_per_step": stats["send_bytes"] / steps / 1e6,
           "sum_mb_per_step": stats["sum_bytes"] / steps / 1e6,
           "transfer_share": stats["comm_s"] / total,
           "staged_share": stats["stage_s"] / total}
    out["sha1"] = _leaf_sha1s(eng.get_canonical_params())
    return out


def _mp_pipeline(dev, cfg, npm, layers, schedule):
    """Phase 17's pipeline engine: dp 1 x pp 2 (pp across the processes
    in a two-process run), flash, PP_N_MU microbatches, AdamW 3e-4."""
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    return PipelineLMEngine(
        dataclasses.replace(cfg, n_layers=layers),
        AdamW(3e-4, weight_decay=0.01, grad_clip=1.0),
        make_pipeline_mesh(1, 2, devices=dev), n_mubatches=PP_N_MU,
        schedule=schedule, attn="flash",
        params={**npm, "blocks": npm["blocks"][:layers]})


def _mp_context(dev, cfg, npm):
    """Phase 17's context engine: dp 2 (across the processes in a
    two-process run), flash, MP_SMALL_LAYERS layers, AdamW 3e-4."""
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh

    return ContextParallelEngine(
        dataclasses.replace(cfg, n_layers=MP_SMALL_LAYERS),
        AdamW(3e-4, weight_decay=0.01, grad_clip=1.0), attn="flash",
        mesh=make_context_mesh(2, 1, dev),
        params={**npm, "blocks": npm["blocks"][:MP_SMALL_LAYERS]})


def _mp_runs(dev, cfg, npm, tok, tgt, rows=lambda x: x) -> dict:
    """(a) and (b): the runs both the workers and the one-process
    reference make (`rows`: this process's rows of a batch, for the
    context engine)."""
    import torch

    counters = _all_train_counters()
    out = {}
    for schedule in MP_SCHEDULES:
        eng = _mp_pipeline(dev, cfg, npm, MP_LAYERS, schedule)
        out[f"a-{schedule}"] = _mp_steps(dev, eng, tok, tgt, counters)
        del eng
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    eng = _mp_context(dev, cfg, npm)
    out["b"] = _mp_steps(dev, eng, rows(tok), rows(tgt), counters)
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mp_worker(pid: str, port: str, work: str, device: str) -> int:
    """Phase 17's worker, `python3 chip_smoke.py --phase17-worker PID
    PORT DIR DEVICE` (the main process starts two): joins the other at
    localhost:PORT (`distributed.initialize` with the reference's
    variables' values), loads the weights and the model the main process
    wrote to DIR, waits for DIR/go (the main process's one-process runs
    are done), then (a) and (b) (`_mp_runs`), then (c): the checkpoint
    engine's step, a save that process 0 writes, its `eval_loss`, the
    next step's loss and leaf sha1s, and an `AsyncSaver` failure
    injected on process 0 that must raise here too. Writes
    DIR/outPID.json."""
    import torch

    from shallowspeed_tpu_torch import checkpoint
    from shallowspeed_tpu_torch import distributed as D
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.weights import map_tree

    pid, work, dev = int(pid), Path(work), torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert D.initialize(f"localhost:{port}", 2, pid)
    card = _card_line() if dev.type == "cuda" else "cpu"
    cfg = _mp_config(json.loads((work / "cfg.json").read_text()))
    # the draw's own key order (a loaded tree's dicts come back sorted),
    # which the optimizer's and the clipping norm's leaf order follow
    shapes = T.param_shapes(dataclasses.replace(cfg, n_layers=MP_LAYERS))
    npm = map_tree(lambda _, x: x, shapes,
                   checkpoint.load_pytree(work / "params.npz"))
    tok, tgt = _train_batch(cfg)
    while not (work / "go").exists():
        time.sleep(0.1)
    t0 = time.time()
    out = {"pid": pid, "card": card, "backend": D.backend(),
           **_mp_runs(dev, cfg, npm, tok, tgt, D.local_rows)}
    eng = _mp_pipeline(dev, cfg, npm, MP_SMALL_LAYERS, "gpipe")
    eng.train_batch(tok, tgt)
    stats = {}
    ck = checkpoint.save(work / "ck", eng, 0, stats=stats)
    out["c"] = {"eval_loss": repr(eng.eval_loss(tok, tgt)),
                "path": str(ck), "save": stats,
                "next_loss": repr(eng.train_batch(tok, tgt)),
                "next_sha1": _leaf_sha1s(eng.get_canonical_params())}
    del eng
    saver = checkpoint.AsyncSaver()
    if pid == 0:
        saver._err = RuntimeError("injected write failure")
    try:
        saver.wait()
        out["c"]["async_failure_raised"] = False
    except RuntimeError as e:
        out["c"]["async_failure_raised"] = str(e)
    saver.close()
    out["wall_s"] = time.time() - t0
    (work / f"out{pid}.json").write_text(json.dumps(out))
    D.barrier("done")
    return 0


def _mp_wait(procs, logs, timeout) -> None:
    """Wait for every worker; the first to fail (or the timeout) kills
    the others and raises with its log."""
    t0 = time.time()
    while any(p.poll() is None for p in procs):
        bad = [i for i, p in enumerate(procs)
               if p.poll() not in (None, 0)]
        if bad or time.time() - t0 > timeout:
            for p in procs:
                p.kill()
            i = bad[0] if bad else 0
            raise AssertionError(
                f"phase 17 worker {i} "
                + ("failed" if bad else f"timed out after {timeout} s")
                + f":\n{Path(logs[i]).read_text()[-6000:]}")
        time.sleep(0.2)
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"phase 17 worker {i} failed:\n"
                                 f"{Path(logs[i]).read_text()[-6000:]}")


def _mp_same(label, got, ref, again) -> dict:
    """`got` (a worker's run) against the one-process `ref`: losses and
    every leaf's sha1 equal. If they differ, `again()` reruns the
    one-process run: a run that differs from itself sets the spread the
    worker's losses are held within (printed)."""
    if got["losses"] == ref["losses"] and got["sha1"] == ref["sha1"]:
        return {"bit_for_bit": True}
    second = again()
    spread = max(abs(float(a) - float(b)) for a, b in
                 zip(second["losses"], ref["losses"]))
    gap = max(abs(float(a) - float(b)) for a, b in
              zip(got["losses"], ref["losses"]))
    leaves = sum(a != b for a, b in zip(got["sha1"], ref["sha1"]))
    out = {"bit_for_bit": False, "one_process_spread": spread,
           "loss_gap": gap, "differing_leaves": leaves,
           "one_process_runs_equal": second["losses"] == ref["losses"]
           and second["sha1"] == ref["sha1"]}
    print(f"mp {label}: the two-process run differs from one process: "
          f"{json.dumps(out)}", flush=True)
    if out["one_process_runs_equal"] or gap > spread:
        raise AssertionError(f"mp {label}: {json.dumps(out)}")
    return out


def run_multiprocess(dev, cfg, np_params, card) -> dict:
    """Phase 17 (see the module docstring). Returns the per-process K1-K3
    launches of (a) and (b) (`mp_launches`)."""
    import shutil
    import tempfile

    import torch

    from shallowspeed_tpu_torch import checkpoint

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mp_"))
    try:
        npm = {**np_params, "blocks": np_params["blocks"][:MP_LAYERS]}
        checkpoint.save_pytree(work / "params.npz", npm)
        (work / "cfg.json").write_text(json.dumps(_mp_describe(cfg)))
        port = str(_free_port())
        logs = [work / f"log{pid}" for pid in range(2)]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("JAX_")}
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--phase17-worker", str(pid), port, str(work), str(dev)],
            stdout=open(logs[pid], "w"), stderr=subprocess.STDOUT, env=env)
            for pid in range(2)]
        try:
            tok, tgt = _train_batch(cfg)
            # the one-process runs, while the workers start up
            ref = _mp_runs(dev, cfg, npm, tok, tgt)
            (work / "go").touch()
            _mp_wait(procs, logs, MP_TIMEOUT)
        finally:
            for p in procs:
                p.kill()
        outs = [json.loads((work / f"out{p}.json").read_text())
                for p in range(2)]
        result = {"card": card, "backend": outs[0]["backend"],
                  "workers_wall_s": [o["wall_s"] for o in outs]}
        launches = {}
        for key in [f"a-{s}" for s in MP_SCHEDULES] + ["b"]:
            def again(key=key):
                return _mp_runs(dev, cfg, npm, tok, tgt)[key]

            if outs[0][key]["losses"] != outs[1][key]["losses"] or \
                    outs[0][key]["sha1"] != outs[1][key]["sha1"]:
                raise AssertionError(f"mp {key}: the two processes differ")
            same = _mp_same(key, outs[0][key], ref[key], again)
            if key == "b":
                per = {k: MP_STEPS * cp_launches_per_step(
                    "flash", 1, 1, 1, MP_SMALL_LAYERS)
                       for k in ("flash_fwd_tc", "flash_dq_tc",
                                 "flash_dkv_tc")}
                one = {k: 2 * v for k, v in per.items()}
            else:
                sched = key[2:]
                per = {k: MP_STEPS * v for k, v in pp_launches_per_step(
                    sched, 1, 1, PP_N_MU, MP_LAYERS // 2).items()}
                one = {k: MP_STEPS * v for k, v in pp_launches_per_step(
                    sched, 1, 1, PP_N_MU, MP_LAYERS).items()}
            for o in outs:
                got = {k: v for k, v in o[key]["launches"].items() if v}
                if dev.type == "cuda" and got != per:
                    raise AssertionError(f"mp {key} process {o['pid']}: "
                                         f"launches {got}, want {per}")
                for k, v in got.items():
                    launches.setdefault(k, [0, 0])[o["pid"]] += v
            got = {k: v for k, v in ref[key]["launches"].items() if v}
            if dev.type == "cuda" and got != one:
                raise AssertionError(f"mp {key} one process: launches "
                                     f"{got}, want {one}")
            fields = ("step_ms_p50", "peak_mem_gb", "send_mb_per_step",
                      "sum_mb_per_step", "transfer_share", "staged_share",
                      "launches")
            result[key] = {
                "losses": [float(x) for x in ref[key]["losses"]], **same,
                "one_process": {k: ref[key][k] for k in fields},
                **{f"process_{o['pid']}": {k: o[key][k] for k in fields}
                   for o in outs}}
            print(f"mp {key}: " + json.dumps(result[key]) + f"  [{card}]",
                  flush=True)
        # (c): the two-process save restores here with the same eval_loss
        c = outs[0]["c"]
        if not all(o["c"]["async_failure_raised"] for o in outs):
            raise AssertionError(f"mp (c): the injected AsyncSaver failure "
                                 f"did not raise on both processes: "
                                 f"{[o['c'] for o in outs]}")
        if any(o["c"][k] != c[k] for o in outs
               for k in ("eval_loss", "next_loss", "next_sha1")):
            raise AssertionError("mp (c): the processes differ")
        eng = _mp_pipeline(dev, cfg, npm, MP_SMALL_LAYERS, "gpipe")
        stats = {}
        step = checkpoint.restore(eng, checkpoint.latest(work / "ck"), stats)
        ev = repr(eng.eval_loss(tok, tgt))
        nxt = repr(eng.train_batch(tok, tgt))
        same_leaves = _leaf_sha1s(eng.get_canonical_params()) == c["next_sha1"]
        del eng
        result["c"] = {"eval_loss_two_processes": c["eval_loss"],
                       "eval_loss_restored": ev, "restored_step": step,
                       "next_loss_two_processes": c["next_loss"],
                       "next_loss_restored": nxt,
                       "next_leaves_equal": same_leaves,
                       "save": c["save"], "restore": stats,
                       "async_failure_raised": [o["c"]["async_failure_raised"]
                                                for o in outs]}
        print("mp (c): " + json.dumps(result["c"]) + f"  [{card}]",
              flush=True)
        if not (step == 1 and ev == c["eval_loss"]
                and nxt == c["next_loss"] and same_leaves):
            raise AssertionError(f"mp (c): {json.dumps(result['c'])}")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        result["d"] = _mp_driver(dev, cfg, work)
        print("mp (d): " + json.dumps(result["d"]) + f"  [{card}]",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"result": result, "launches": launches}


def _mp_driver(dev, cfg, work) -> dict:
    """(d): `train_lm --pp 2 --attn flash` at MP_SMALL_LAYERS layers for
    MP_STEPS steps launched as two processes (the reference's three
    variables) and run in this process: process 0's JSONL losses and
    printed step lines equal the one-process run's; process 1 prints no
    step line."""
    import contextlib
    import io

    from shallowspeed_tpu_torch import train_lm

    flags = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
             "--n-heads", str(cfg.n_heads), "--n-layers",
             str(MP_SMALL_LAYERS), "--d-ff", str(cfg.ffn_dim),
             "--seq-len", str(cfg.max_seq), "--batch-size", str(TRAIN_BATCH),
             "--rope", "--norm", cfg.norm, "--ffn", cfg.ffn, "--optimizer",
             "adamw", "--lr", "3e-4", "--grad-clip", "1.0", "--log-every",
             "1", "--attn", "flash", "--pp", "2", "--n-mubatches", "2",
             "--steps", str(MP_STEPS), "--prefetch", "0"]
    if cfg.compute_dtype is not None:
        flags.append("--bf16")
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    port = str(_free_port())
    logs = [work / f"d{pid}.out" for pid in range(2)]
    procs = []
    for pid in range(2):
        env = {**{k: v for k, v in os.environ.items()
                  if not k.startswith("JAX_")},
               "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "shallowspeed_tpu_torch.train_lm",
             *flags, "--log-file", str(work / "d2.jsonl")],
            stdout=open(logs[pid], "w"), stderr=subprocess.STDOUT, env=env,
            cwd=str(Path(__file__).resolve().parent)))
    t0 = time.time()
    try:
        _mp_wait(procs, logs, MP_TIMEOUT)
    finally:
        for p in procs:
            p.kill()
    wall2 = time.time() - t0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        train_lm.main([*flags, "--log-file", str(work / "d1.jsonl")])
    wall1 = time.time() - t0

    def steps(text):
        return [ln.split("tok/s")[0] for ln in text.splitlines()
                if ln.startswith("step ")]

    two = [e["loss"] for e in _events(work / "d2.jsonl", "step")]
    one = [e["loss"] for e in _events(work / "d1.jsonl", "step")]
    printed = [steps(Path(x).read_text()) for x in logs]
    res = {"losses_two_processes": two, "losses_one_process": one,
           "step_lines_process_0": printed[0],
           "step_lines_process_1": printed[1],
           "distributed_line": [ln for ln in Path(logs[0]).read_text()
                                .splitlines()
                                if ln.startswith("distributed:")],
           "wall_s": {"two_processes": wall2, "one_process": wall1}}
    if not (len(one) == MP_STEPS and two == one
            and printed[0] == steps(out.getvalue()) and printed[1] == []
            and all(np.isfinite(one))):
        raise AssertionError(f"mp (d): {json.dumps(res)}")
    return res


# Phase 18: the telemetry core. Depth is cut to TELE_LAYERS of 16 for
# the script's time (width never); the driver runs share one draw.
TELE_LAYERS = 4
TELE_STEPS = 6
TELE_PROFILE_STEPS = 2
TELE_HZ = 100
TELE_SERVE_LAYERS = 2
# (d)'s traffic runs: pp 2 at 2 layers and dp 2 at 1 (4 and 2 before
# phase 21 came, cut for the script's time; the counted bytes do not
# depend on depth)
TELE_PP_LAYERS = 2
TELE_DP_LAYERS = 1
# kernel-name pieces of the libraries' attention kernels (cuDNN, the
# SDPA flash and memory-efficient kernels); none may run in phase 18 (b)
LIBRARY_ATTENTION = ("cudnn", "fmha", "flash_attn", "pytorch_flash",
                     "efficient_attention", "mem_eff", "sdpa")
TELE_KERNELS = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                "flash_dkv_tc_kernel")


@contextlib.contextmanager
def _cached_draw():
    """`transformer.init_numpy` memoized by (config, seed) while a
    phase's driver runs build their engines (phases 12d, 13c, 14g, 15f,
    16e, 18 and 19): the draw is a pure function of both (the same
    weights), and each draw at full width takes seconds."""
    from shallowspeed_tpu_torch.models import transformer as T

    real, cache = T.init_numpy, {}

    def init_numpy(cfg, seed=0):
        key = (repr(cfg), seed)
        if key not in cache:
            cache[key] = real(cfg, seed)
        return cache[key]

    T.init_numpy = init_numpy
    try:
        yield
    finally:
        T.init_numpy = real


def _lm_flags(cfg, n_layers: int, dev) -> list:
    flags = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
             "--n-heads", str(cfg.n_heads), "--n-layers", str(n_layers),
             "--d-ff", str(cfg.ffn_dim), "--seq-len", str(cfg.max_seq),
             "--batch-size", str(TRAIN_BATCH), "--rope", "--norm", cfg.norm,
             "--ffn", cfg.ffn, "--optimizer", "adamw", "--lr", "3e-4",
             "--grad-clip", "1.0", "--attn", "flash", "--log-every", "1"]
    if cfg.compute_dtype is not None:
        flags.append("--bf16")
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    return flags


def _p50(xs):
    return float(np.median(xs)) if xs else None


def _tele_drive(dev, flags, root, tag, *extra) -> dict:
    """One `train_lm.main` run of phase 18 with K1-K3's counts zeroed
    just before it and read just after, the fences counted, the peak
    memory reset before it: its losses, step lines, launches, fences,
    the driver's window of each step (s), the run's peak."""
    import torch

    from shallowspeed_tpu_torch import train_lm
    from shallowspeed_tpu_torch.telemetry import trace as TR

    counters = _all_train_counters()
    for c in counters:
        c.launches = 0
    fences = [0]
    block = TR._block

    def counted(arrays):
        fences[0] += 1
        block(arrays)

    TR._block = counted
    log = root / f"{tag}.jsonl"
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        train_lm.main([*flags, *extra, "--log-file", str(log)])
    finally:
        TR._block = block
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    steps = _events(log, "step")
    tokens = TRAIN_BATCH * int(flags[flags.index("--seq-len") + 1])
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": [e["loss"] for e in steps], "lines": steps,
            "launches": {c.__name__.lstrip("_"): c.launches
                         for c in counters if c.launches},
            "fences": fences[0], "peak": peak, "log": log,
            "windows": [tokens / e["tokens_per_sec"] for e in steps]}


def _tele_levels(dev, cfg, root) -> dict:
    """Phase 18 (a): the levels, and the sampler on the `spans` run."""
    from shallowspeed_tpu_torch.telemetry import __main__ as tcli

    n = TELE_LAYERS
    flags = [*_lm_flags(cfg, n, dev), "--steps", str(TELE_STEPS), "--zero1"]
    runs = {}
    for level in ("off", "steps", "spans", "spans+host"):
        extra = ["--telemetry", level.split("+")[0]]
        if level != "off":
            extra += ["--trace-dir", str(root / level)]
        if level == "spans+host":
            extra += ["--profile", "host", "--profile-hz", str(TELE_HZ)]
        runs[level] = _tele_drive(dev, flags, root, level, *extra)
    want = dict.fromkeys(("flash_fwd_tc", "flash_dq_tc", "flash_dkv_tc"),
                         n * TELE_STEPS)
    for level, r in runs.items():
        if r["losses"] != runs["off"]["losses"] or len(r["losses"]) != \
                TELE_STEPS or not all(np.isfinite(r["losses"])):
            raise AssertionError(f"tele (a): {level} losses {r['losses']} "
                                 f"are not off's {runs['off']['losses']}")
        if r["launches"] != want:
            raise AssertionError(f"tele (a): {level} launched "
                                 f"{r['launches']}, want {want}")
        if r["fences"] != (3 * TELE_STEPS if level.startswith("spans")
                           else 0):
            raise AssertionError(f"tele (a): {level} fenced {r['fences']} "
                                 f"times in {TELE_STEPS} steps")
    sp = runs["spans"]
    spans = [json.loads(x) for x in
             (root / "spans" / "spans.jsonl").read_text().splitlines()]
    step_spans = [e for e in spans if e["name"] == "step"]
    if len(step_spans) != TELE_STEPS:
        raise AssertionError(f"tele (a): {len(step_spans)} step spans")
    for e, window in zip(step_spans, sp["windows"]):
        inner = [x for x in spans if x["name"] in ("grads", "update")
                 and x["args"]["step"] == e["args"]["step"]]
        if sorted(x["name"] for x in inner) != ["grads", "update"] or any(
                x["ts"] < e["ts"] or x["ts"] + x["dur"] > e["ts"] + e["dur"]
                for x in inner):
            raise AssertionError(f"tele (a): step {e['args']} does not "
                                 f"hold its grads and update spans")
        if e["dur"] > window * 1e6 * 1.001:
            raise AssertionError(f"tele (a): the fenced step span "
                                 f"{e['dur']} us exceeds the driver's "
                                 f"window {window * 1e6:.1f} us")
    last = sp["lines"][-1]
    summ = json.loads((root / "spans" / "telemetry.json").read_text())
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.weights import leaves

    param_bytes = sum(t.numel() * t.element_size() for t in leaves(
        T.param_shapes(dataclasses.replace(cfg, n_layers=n))))
    owned = summ["hbm_owners"]["owners"]["train.params"]
    if owned != param_bytes:
        raise AssertionError(f"tele (a): train.params owns {owned} bytes, "
                             f"the tree holds {param_bytes}")
    if dev.type == "cuda" and last["hbm_alloc_peak_mib"] != round(
            sp["peak"] / 2**20, 2):
        raise AssertionError(f"tele (a): hbm_alloc_peak_mib "
                             f"{last['hbm_alloc_peak_mib']} vs "
                             f"max_memory_allocated {sp['peak'] / 2**20}")
    import io
    from contextlib import redirect_stdout

    with redirect_stdout(io.StringIO()):
        valid = tcli.main(["--validate", str(root / "spans" /
                                             "spans.jsonl")])
    if valid != 0:
        raise AssertionError("tele (a): spans.jsonl fails --validate")
    prof = _events(runs["spans+host"]["log"], "profile")[-1]
    tags = {k: round(v / max(prof["samples"], 1), 4)
            for k, v in sorted(prof["phases"].items())}
    if not prof["samples"] or not set(tags) & {"step", "grads", "update"}:
        raise AssertionError(f"tele (a): the sampler tagged {tags}")
    out = {"step_ms_p50": {lv: _p50([1e3 * w for w in r["windows"][1:]])
                           for lv, r in runs.items()},
           "fences_a_step": {lv: r["fences"] / TELE_STEPS
                             for lv, r in runs.items()},
           "launches_a_step": {k: v / TELE_STEPS for k, v in
                               sp["launches"].items()},
           "step_span_ms_p50": _p50([e["dur"] / 1e3
                                     for e in step_spans[1:]]),
           "hbm_live_mib": last["hbm_live_mib"],
           "hbm_alloc_peak_mib": last.get("hbm_alloc_peak_mib"),
           "hbm_owned_mib": last["hbm_owned_mib"],
           "hbm_untracked_mib": last["hbm_untracked_mib"],
           "host_rss_mib": last["host_rss_mib"],
           "param_bytes": param_bytes,
           "sampler": {"hz": TELE_HZ, "samples": prof["samples"],
                       "step_samples": prof["step_samples"],
                       "share_by_tag": tags,
                       "max_gap_ms": prof["max_gap_ms"]}}
    print("tele (a): " + json.dumps(out), flush=True)
    return {"launches": sp["launches"], "flags": flags, "spans_last": last,
            "roofline": summ["roofline"]}


def _tele_profile_dir(dev, flags, root) -> dict:
    """Phase 18 (b): the `--profile-dir` capture names K1-K3 as often as
    the counters counted them, and no library attention kernel."""
    base = list(flags)
    base[base.index("--steps") + 1] = str(TELE_PROFILE_STEPS)
    r = _tele_drive(dev, base, root, "profile-dir",
                    "--profile-dir", str(root / "prof"))
    trace = json.loads((root / "prof" / "trace_p0.json").read_text())
    kernels = [e for e in trace["traceEvents"]
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    found = {k: [0, 0.0] for k in TELE_KERNELS}
    library = sorted({e["name"][:80] for e in kernels
                      if any(m in e["name"].lower()
                             for m in LIBRARY_ATTENTION)})
    for e in kernels:
        for k in TELE_KERNELS:
            if k in e["name"]:
                found[k][0] += 1
                found[k][1] += e.get("dur", 0.0) / 1e3
    counts = {k: found[k][0] for k in TELE_KERNELS}
    # the launcher `_flash_fwd_tc` launches `flash_fwd_tc_kernel`, ...
    want = {k: r["launches"].get(k[:-len("_kernel")], 0)
            for k in TELE_KERNELS}
    out = {"kernels": {k: {"count": found[k][0],
                           "device_ms": round(found[k][1], 4)}
                       for k in TELE_KERNELS},
           "launch_counters": want, "device_kernels": len(kernels),
           "library_attention": library,
           "trace_mb": round((root / "prof" / "trace_p0.json").stat().st_size
                             / 1e6, 2)}
    print("tele (b): " + json.dumps(out), flush=True)
    if dev.type == "cuda" and (counts != want or library
                               or min(want.values()) == 0):
        raise AssertionError(f"tele (b): the trace's kernels {counts} vs "
                             f"the counters {want}; library attention "
                             f"kernels {library}")
    return out


def _tele_serve(dev, cfg, root) -> dict:
    """Phase 18 (c): `serve --profile host` against the same run
    without it."""
    import io
    from contextlib import redirect_stdout

    from shallowspeed_tpu_torch import serve as sdriver
    from shallowspeed_tpu_torch.ops.flash_attention import paged_flash_decode

    reqs = root / "requests.jsonl"
    reqs.write_text("\n".join(json.dumps(
        {"id": rid, "prompt": p.tolist(), "max_new": MAX_NEW})
        for rid, p in _random_prompts(cfg.vocab).items()))
    n = TELE_SERVE_LAYERS
    argv = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
            "--n-heads", str(cfg.n_heads), "--n-layers", str(n),
            "--max-seq", str(cfg.max_seq), "--rope", "--slots",
            str(SLICE["slots"]), "--n-blocks", str(N_BLOCKS),
            "--block-size", str(SLICE["block_size"]), "--prefill-chunk",
            str(PREFILL_CHUNK), "--requests", str(reqs)]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    runs = {}
    for tag, extra in (("off", []), ("host", [
            "--profile", "host", "--profile-hz", str(TELE_HZ),
            "--log-file", str(root / "serve.jsonl")])):
        paged_flash_decode.launches = 0
        buf = io.StringIO()
        t0 = time.time()
        with redirect_stdout(buf):
            sdriver.main([*argv, *extra])
        lines = [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]
        runs[tag] = {"streams": {e["id"]: e["tokens"] for e in lines
                                 if e["event"] == "result"},
                     "summary": next(e for e in lines
                                     if e["event"] == "summary"),
                     "launches": paged_flash_decode.launches,
                     "wall_s": time.time() - t0}
    prof = _events(root / "serve.jsonl", "profile")[-1]
    tick = sum(v for k, v in prof["folded"].items()
               if "engine:step" in k)
    h = runs["host"]
    out = {"streams_equal": h["streams"] == runs["off"]["streams"],
           "requests": len(h["streams"]), "ticks": h["summary"]["ticks"],
           "k4_launches": h["launches"], "samples": prof["samples"],
           "tick_side_samples": tick,
           "tok_per_sec": {t: r["summary"]["tok_per_sec"]
                           for t, r in runs.items()},
           "wall_s": {t: round(r["wall_s"], 2) for t, r in runs.items()}}
    print("tele (c): " + json.dumps(out), flush=True)
    want_k4 = n * h["summary"]["ticks"] if dev.type == "cuda" else 0
    if not out["streams_equal"] or len(h["streams"]) != N_REQUESTS \
            or h["launches"] != want_k4 or not tick:
        raise AssertionError(f"tele (c): {out}")
    return {**out, "streams": runs["off"]["streams"]}


def _tele_traffic(dev, cfg, np_params) -> dict:
    """Phase 18 (d): the counted bytes of a step against the analytic
    ones, pp 2 gpipe and dp 2 (the first layers of `np_params`)."""
    import torch

    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    from shallowspeed_tpu_torch.parallel.mesh import (make_context_mesh,
                                                      make_pipeline_mesh)
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    rng = np.random.default_rng(0)
    b, t = TRAIN_BATCH, cfg.max_seq
    tok = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    out = {}
    pcfg = dataclasses.replace(cfg, n_layers=TELE_PP_LAYERS)
    eng = PipelineLMEngine(pcfg, O.AdamW(3e-4), make_pipeline_mesh(
        1, 2, 1, dev), n_mubatches=4, schedule="gpipe", attn="flash",
        params=_first_layers(np_params, TELE_PP_LAYERS))
    eng.train_batch(tok, tgt)
    hop = (b // 4) * t * cfg.d_model * (2 if cfg.compute_dtype else 4)
    out["pp2_gpipe"] = {"counted": eng.telemetry_traffic(),
                        "analytic": {"pp": 2 * 4 * hop}}
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dcfg = dataclasses.replace(cfg, n_layers=TELE_DP_LAYERS)
    eng = ContextParallelEngine(dcfg, O.AdamW(3e-4), attn="flash",
                                mesh=make_context_mesh(2, 1, dev),
                                params=_first_layers(np_params,
                                                     TELE_DP_LAYERS))
    eng.train_batch(tok, tgt)
    out["dp2"] = {"counted": eng.telemetry_traffic(),
                  "analytic": {"dp": _tensor_bytes(eng.params)}}
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print("tele (d): " + json.dumps(out), flush=True)
    for name, r in out.items():
        got = {ax: v["bytes"] for ax, v in r["counted"]["per_axis"].items()}
        if got != r["analytic"]:
            raise AssertionError(f"tele (d): {name} counted {got}, the "
                                 f"analytic bytes are {r['analytic']}")
    return out


def run_telemetry(dev, cfg, card, np_params) -> dict:
    """Phase 18 (module docstring): (a)-(d), in a temporary directory
    removed at the end, the driver runs sharing one draw."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tele_"))
    print(f"tele: {card}", flush=True)
    try:
        with _cached_draw():
            levels = _tele_levels(dev, cfg, root)
            _tele_profile_dir(dev, levels["flags"], root)
            served = _tele_serve(dev, cfg, root)
            _tele_traffic(dev, cfg, np_params)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": levels["launches"], "roofline": levels["roofline"],
            "spans_last": levels["spans_last"],
            "serve_streams": served["streams"]}


# Phase 19: monitor and accounting. Depth is cut to MON_LAYERS of 16 for
# the script's time (width never); (b) reads phase 18 (a)'s `spans` run
# (the one-device flash step under ZeRO-1 at TELE_LAYERS), (d) compares
# with phase 18 (c)'s streams. 4 layers before phase 20 came.
MON_LAYERS = 2
MON_STEPS = 6
MON_N_MU = 4
MON_SERVE_LAYERS = TELE_SERVE_LAYERS
MON_TWIN_STEPS = 3
MON_MLP_BATCHES = 8
MON_FLAGS = ["--monitor-port", "0", "--slo", "step_p95_ms<1",
             "--flight-recorder", "64"]


@contextlib.contextmanager
def _polled_monitors(got: list):
    """Every monitor endpoint a driver starts (`monitor.from_args`, which
    `train_lm`, `train` and `serve` call), polled from a thread while
    the run is live, as an operator would: each answered GET of
    /status.json and /metrics lands in `got` as (path, body). The
    poller stops before the endpoint closes."""
    import threading
    import urllib.request

    from shallowspeed_tpu_torch.telemetry import monitor as MON

    real_from, real_close = MON.from_args, MON.close_monitor
    pollers = {}

    def poll(srv, halt):
        while not halt.is_set():
            try:
                for path in ("/status.json", "/metrics"):
                    with urllib.request.urlopen(srv.url(path),
                                                timeout=10) as r:
                        got.append((path, r.read().decode()))
            except OSError:
                pass
            halt.wait(0.05)

    def from_args(*a, **kw):
        mon, srv = real_from(*a, **kw)
        if srv is not None:
            halt = threading.Event()
            th = threading.Thread(target=poll, args=(srv, halt),
                                  daemon=True)
            th.start()
            pollers[id(srv)] = (halt, th)
        return mon, srv

    def close_monitor(mon, srv):
        halt, th = pollers.pop(id(srv), (None, None))
        if halt is not None:
            halt.set()
            th.join(timeout=30)
        real_close(mon, srv)

    MON.from_args, MON.close_monitor = from_args, close_monitor
    try:
        yield
    finally:
        MON.from_args, MON.close_monitor = real_from, real_close
        for halt, th in pollers.values():
            halt.set()
            th.join(timeout=30)


@contextlib.contextmanager
def _recorded_rates(rec: dict):
    """`train_lm`'s `StepRates` with its start, the end of its last
    window and the pause seconds booked after that end recorded in
    `rec` (what (c)'s window-sum check reads against the log)."""
    from shallowspeed_tpu_torch import train_lm

    real = train_lm.StepRates

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["t0"] = self._t0
            rec["rates"] = self

    train_lm.StepRates = Recorded
    try:
        yield
    finally:
        train_lm.StepRates = real
        r = rec.pop("rates", None)
        if r is not None:
            rec["last_end"] = r._win_t
            rec["after_end"] = r._pause - r._win_pause


def _sketch_summary(log) -> dict:
    """The quantiles of a log's last "monitor" snapshot."""
    from shallowspeed_tpu_torch.telemetry.sketch import MetricSketches

    snap = _events(log, "monitor")[-1]
    return MetricSketches(rel_err=snap["rel_err"]).merge_dict(
        snap["sketches"]).summary()


def _two_point(dev, cfg, tok, tgt, np_params) -> dict:
    """`two_point_bubble` of pp 2 gpipe at MON_N_MU microbatches: fenced
    steps of the engine against its calibration twin at twice the
    microbatches on twice the rows."""
    import torch

    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine
    from shallowspeed_tpu_torch.telemetry.bubble import two_point_bubble

    pcfg = dataclasses.replace(cfg, n_layers=MON_LAYERS)
    eng = PipelineLMEngine(pcfg, O.AdamW(3e-4), make_pipeline_mesh(
        1, 2, 1, dev), n_mubatches=MON_N_MU, schedule="gpipe", attn="flash",
        params=_first_layers(np_params, MON_LAYERS))
    twin = eng.make_calibration_twin()
    times = {}
    for name, e, (t, g) in (("n_mu", eng, (tok, tgt)),
                            ("2n_mu", twin, (np.concatenate([tok, tok]),
                                             np.concatenate([tgt, tgt])))):
        e.train_batch(t, g)                       # warm-up
        ts = []
        for _ in range(MON_TWIN_STEPS):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            e.train_batch(t, g)                   # ends in float(loss)
            ts.append(time.perf_counter() - t0)
        times[name] = float(np.median(ts))
    del eng, twin
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return two_point_bubble(times["n_mu"], times["2n_mu"])


def _mon_pipeline(dev, cfg, root, got, np_params) -> dict:
    """Phase 19 (a) and (c): `train_lm --pp 2` gpipe and 1f1b under the
    monitor against the same runs without its flags, the endpoint polled
    while they run; the calibrated bubble, the two-point bubble; then
    `--goodput` of the gpipe run and its window-sum check."""
    from shallowspeed_tpu_torch.ops import _build
    from shallowspeed_tpu_torch.telemetry import goodput as G
    from shallowspeed_tpu_torch.telemetry.bubble import static_bubble

    flags = [*_lm_flags(cfg, MON_LAYERS, dev), "--steps", str(MON_STEPS),
             "--pp", "2", "--n-mubatches", str(MON_N_MU), "--telemetry",
             "spans"]
    out, launches, rec = {}, {}, {}
    for sched in ("gpipe", "1f1b"):
        f = [*flags, "--pp-schedule", sched]
        off = _tele_drive(dev, f, root, f"{sched}-off")
        n_polls, n_dumps = len(got), len(list(root.glob("flightrec_*")))
        with _recorded_rates(rec if sched == "gpipe" else {}):
            on = _tele_drive(dev, f, root, f"{sched}-mon", *MON_FLAGS)
        polls = got[n_polls:]
        bub = _events(on["log"], "bubble")
        alerts = _events(on["log"], "alert")
        res = {"losses_equal": on["losses"] == off["losses"],
               "launches_equal": on["launches"] == off["launches"],
               "launches": on["launches"],
               "bubble_static": bub[-1]["bubble_static"] if bub else None,
               "bubble_measured": bub[-1]["bubble_measured"] if bub else None,
               "bubble_detail": {k: bub[-1][k] for k in
                                 ("t_step", "t_eval", "c_f", "c_b")}
               if bub else None,
               "step_ms": _sketch_summary(on["log"]).get("step_ms"),
               "alerts": [(a["slo"], a["state"]) for a in alerts],
               "flight_dumps": len(list(root.glob("flightrec_*")))
               - n_dumps,
               "polls": {p: sum(1 for q, _ in polls if q == p)
                         for p in ("/status.json", "/metrics")},
               "step_ms_p50_off_on": [
                   _p50([1e3 * w for w in r["windows"][1:]])
                   for r in (off, on)]}
        out[sched] = res
        launches[sched] = on["launches"]
        static = static_bubble(sched, MON_N_MU, 2)["bubble_fraction"]
        bad = (not res["losses_equal"] or not res["launches_equal"]
               or len(on["losses"]) != MON_STEPS
               or not all(np.isfinite(on["losses"]))
               or res["bubble_static"] != static
               or res["bubble_measured"] is None
               or not res["alerts"] or res["alerts"][0][1] != "firing"
               or res["flight_dumps"] < 1
               or min(res["polls"].values()) < 1)
        if sched == "gpipe" and res["bubble_measured"] is not None:
            # the replay is F:B-invariant for gpipe
            bad = bad or round(res["bubble_measured"], 3) != round(
                static, 3)
        if bad:
            raise AssertionError(f"mon (a) {sched}: {json.dumps(res)}")
        if sched == "gpipe":
            gpipe_log = on["log"]
            tokens = TRAIN_BATCH * cfg.max_seq
            windows = [tokens / e["tokens_per_sec"] for e in on["lines"]]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (TRAIN_BATCH, cfg.max_seq)).astype(
        np.int32)
    out["two_point"] = _two_point(dev, cfg, tok, np.roll(tok, -1, axis=1),
                                  np_params)
    print("mon (a): " + json.dumps(out), flush=True)

    # (c) the goodput ledger of the monitored gpipe run
    rep = G.run_goodput(gpipe_log)
    excluded = sum(e["seconds"] for e in _events(gpipe_log, "ledger")
                   if e["kind"] in G.EXCLUDED_KINDS
                   and e["kind"] not in ("init", "restore")
                   and "seconds" in e)
    wall = rec["last_end"] - rec["t0"] + rec["after_end"]
    gap = sum(windows) + excluded - wall
    first_window_s = windows[0]
    res = {"goodput": rep["goodput"], "losses": rep["losses"],
           "counts": {k: v for k, v in rep["counts"].items() if v},
           "per_step_s": rep["per_step_s"],
           "accounted_frac": rep["accounted_frac"],
           "compile_s": rep["losses"].get("compile", 0.0),
           "first_window_s": round(first_window_s, 4),
           "kernels_built_before": sorted(_build.build_logs),
           "window_sum_s": round(sum(windows), 6),
           "excluded_ledger_s": round(excluded, 6),
           "wall_s": round(wall, 6), "gap_ms": round(gap * 1e3, 4)}
    print("mon (c): " + json.dumps(res), flush=True)
    if abs(gap) > 1e-3 or rep["goodput"] is None \
            or rep["accounted_frac"] < 0.95:
        raise AssertionError(f"mon (c): {json.dumps(res)}")
    return {"launches": launches, "a": out, "c": res}


def _mon_waterfall(dev, cfg, tele18) -> dict:
    """Phase 19 (b): phase 18 (a)'s `spans` run (the one-device flash
    step under ZeRO-1 at TELE_LAYERS): the counted roofline of its
    first step, its last step line's waterfall, and K1-K3's
    self-reported FLOPs against their analytic causal counts."""
    roof, last = tele18["roofline"], tele18["spans_last"]
    n, b, t, h, d = (TELE_LAYERS, TRAIN_BATCH, cfg.max_seq, cfg.n_heads,
                     cfg.head_dim)
    pairs = b * h * t * (t + 1) // 2
    analytic = {"flash_fwd": 4 * d * pairs * n, "flash_dq": 6 * d * pairs * n,
                "flash_dkv": 8 * d * pairs * n}
    dm, ff, tokens = cfg.d_model, cfg.ffn_dim, b * t
    dense = 3 * tokens * (n * (2 * dm * (h * d + 2 * cfg.kv_heads * d)
                               + 2 * dm * dm + 3 * 2 * dm * ff)
                          + 2 * dm * cfg.vocab)
    keys = ("attrib_t_step_ms", "attrib_compute_frac", "attrib_mxu_frac",
            "attrib_hbm_frac", "attrib_comm_exposed_frac",
            "attrib_bubble_frac", "attrib_host_frac",
            "attrib_unexplained_frac", "attrib_rates_source", "attrib_wire",
            "attrib_compute_scale")
    res = {"flops": roof["flops_shard"], "dot_bytes": roof["dot_bytes_shard"],
           "bytes": roof["bytes_shard"],
           "executed_flops_analytic": dense + sum(analytic.values()),
           "kernels": {k: {"reported": roof["kernels"][k]["flops"],
                           "analytic": v,
                           "calls": roof["kernels"][k]["calls"],
                           "bytes": roof["kernels"][k]["bytes"]}
                       for k, v in analytic.items()},
           "approximate": roof["approximate"],
           "waterfall": {k: last.get(k) for k in keys}}
    print("mon (b): " + json.dumps(res), flush=True)
    bad = (any(v["reported"] != v["analytic"] or v["calls"] != n
               for v in res["kernels"].values())
           or roof["flops_shard"] != res["executed_flops_analytic"]
           or last.get("attrib_unexplained_frac") is None)
    if dev.type == "cuda":
        bad = bad or last.get("attrib_rates_source") != "table"
    if bad:
        raise AssertionError(f"mon (b): {json.dumps(res)}")
    return res


def _mon_serve(dev, cfg, root, off_streams, got) -> dict:
    """Phase 19 (d): `serve` under the monitor with a 1 ms TTFT SLO
    (which must fire) against phase 18 (c)'s streams without it."""
    import io
    from contextlib import redirect_stdout

    from shallowspeed_tpu_torch import serve as sdriver
    from shallowspeed_tpu_torch.ops.flash_attention import paged_flash_decode
    from shallowspeed_tpu_torch.telemetry import goodput as G

    reqs = root / "requests.jsonl"
    n = MON_SERVE_LAYERS
    log = root / "serve-mon.jsonl"
    argv = ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
            "--n-heads", str(cfg.n_heads), "--n-layers", str(n),
            "--max-seq", str(cfg.max_seq), "--rope", "--slots",
            str(SLICE["slots"]), "--n-blocks", str(N_BLOCKS),
            "--block-size", str(SLICE["block_size"]), "--prefill-chunk",
            str(PREFILL_CHUNK), "--requests", str(reqs), "--monitor-port",
            "0", "--slo", "ttft_p95_ms<1", "--flight-recorder", "64",
            "--log-file", str(log)]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    n_polls, n_dumps = len(got), len(list(root.glob("flightrec_*")))
    paged_flash_decode.launches = 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        sdriver.main(argv)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    streams = {e["id"]: e["tokens"] for e in lines if e["event"] == "result"}
    summary = next(e for e in lines if e["event"] == "summary")
    mon = G.run_goodput(log)["monitor"]
    res = {"streams_equal": streams == off_streams,
           "requests": len(streams), "ticks": summary["ticks"],
           "k4_launches": paged_flash_decode.launches,
           "alerts": [(a["slo"], a["state"], a.get("severity"))
                      for a in _events(log, "alert")],
           "flight_dumps": len(list(root.glob("flightrec_*"))) - n_dumps,
           "polls": sum(1 for q, _ in got[n_polls:] if q == "/status.json"),
           "parity": mon["parity"], "rel_err": mon["rel_err"]}
    print("mon (d): " + json.dumps(res), flush=True)
    want_k4 = n * summary["ticks"] if dev.type == "cuda" else 0
    if (not res["streams_equal"] or len(streams) != N_REQUESTS
            or res["k4_launches"] != want_k4 or not res["alerts"]
            or res["alerts"][0][1] != "firing" or res["flight_dumps"] < 1
            or not all(v["within_bound"] for v in mon["parity"].values())):
        raise AssertionError(f"mon (d): {json.dumps(res)}")
    return {"launches": res["k4_launches"], **res}


def _mon_vm(dev, root) -> dict:
    """Phase 19 (e): the MLP driver's instruction VM at pp 2 gpipe at
    `spans`: the measured bubble replayed from its fenced Forward /
    Backward spans against the static one."""
    import io
    from contextlib import redirect_stdout

    from shallowspeed_tpu_torch import train as mdriver
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    data_dir = str(prepare_mnist(root / "mnist", synthetic=True,
                                 n_samples=4096))
    log = root / "vm.jsonl"
    argv = ["--engine", "vm", "--pp", "2", "--schedule", "gpipe",
            "--telemetry", "spans", "--epochs", "1", "--max-batches",
            str(MON_MLP_BATCHES), "--data-dir", data_dir, "--log-file",
            str(log)]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        mdriver.main(argv)
    tel = _events(log, "telemetry")[-1]
    res = {"bubble_static": tel.get("bubble_static"),
           "bubble_measured": tel.get("bubble_measured"),
           "printed": [x for x in buf.getvalue().splitlines()
                       if "bubble measured" in x]}
    print("mon (e): " + json.dumps(res), flush=True)
    if res["bubble_static"] != 0.2 or res["bubble_measured"] is None \
            or not 0.0 <= res["bubble_measured"] < 1.0:
        raise AssertionError(f"mon (e): {json.dumps(res)}")
    return res


def run_monitor(dev, cfg, card, tele18, np_params) -> dict:
    """Phase 19 (module docstring): (a)-(e), in a temporary directory
    removed at the end, the driver runs sharing one draw."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mon_"))
    print(f"mon: {card}", flush=True)
    got = []
    t0 = time.time()
    try:
        with _cached_draw(), _polled_monitors(got):
            pipe = _mon_pipeline(dev, cfg, root, got, np_params)
            _mon_waterfall(dev, cfg, tele18)
            reqs = root / "requests.jsonl"
            reqs.write_text("\n".join(json.dumps(
                {"id": rid, "prompt": p.tolist(), "max_new": MAX_NEW})
                for rid, p in _random_prompts(cfg.vocab).items()))
            served = _mon_serve(dev, cfg, root, tele18["serve_streams"],
                                got)
            _mon_vm(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {}
    for counts in pipe["launches"].values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    launches["paged_flash_decode"] = served["launches"]
    print(f"mon: phase 19 {time.time() - t0:.1f} s on {card}", flush=True)
    return {"launches": launches}


_T0 = [0.0]


# ---------------------------------------------------------------- phase 21

# (a): phase 3's 12 greedy requests and FLEET_SAMPLED sampled ones
# (temperatures 0.7-1.0, distinct seeds), first in f32 at
# FLEET_F32_LAYERS layers (the gate: every stream the solo engine's),
# then in bf16 at full depth on phase 3's weights
FLEET_SAMPLED = 4
FLEET_F32_LAYERS = 2
# (b): the router driver over `serve --serve` children at full width
# and FLEET_CLI_LAYERS layer (the serve CLI computes in f32)
FLEET_CLI_LAYERS = 1
FLEET_CLI_REQUESTS = 8
FLEET_CLI_NEW = 16
FLEET_CHAOS = "r0=kill@6;r1=stall@4:0.5"
FLEET_CLI_LIMIT_S = 150


def _fleet_requests(vocab) -> dict:
    """{rid: (prompt, temperature, seed)}: phase 3's greedy requests,
    then FLEET_SAMPLED sampled ones (128-512 tokens, numpy seed 21)."""
    reqs = {rid: (p, 0.0, 0) for rid, p in _random_prompts(vocab).items()}
    rng = np.random.default_rng(21)
    for i in range(FLEET_SAMPLED):
        reqs[f"s{i}"] = (rng.integers(0, vocab, int(rng.integers(128, 513)))
                         .astype(np.int32), 0.7 + 0.1 * i, 100 + i)
    return reqs


def _fleet_engine(dev, cfg, params, made=None):
    from shallowspeed_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(params, cfg, n_blocks=N_BLOCKS,
                        block_size=SLICE["block_size"],
                        max_slots=SLICE["slots"],
                        prefill_chunk=PREFILL_CHUNK, attn_impl="flash",
                        device=dev)
    if made is not None:
        made.append(eng)
    return eng


def _fleet_drill(dev, cfg, params, reqs, root, label) -> dict:
    """Phase 21 (a) at one config: `Router` over two `InProcessReplica`s
    of `ServingEngine(attn_impl="flash")` on the one params tree, every
    request submitted, r0 killed once a request is mid-stream on it, the
    router run to the end and then until r0 is back (its breaker closed).
    Checks: every request completes, a failover, the breaker's open /
    half_open / closed, r0's restart_downtime of class crash, the router
    log valid, every live allocator balanced, K4 launched n_layers x the
    ticks of every engine the drill built (the killed one's included)
    and its int8 build never."""
    import torch

    from shallowspeed_tpu_torch.metrics import MetricsLogger
    from shallowspeed_tpu_torch.ops.flash_attention import (
        _paged_flash_decode_int8, paged_flash_decode)
    from shallowspeed_tpu_torch.serving.router import (InProcessReplica,
                                                       Router)
    from shallowspeed_tpu_torch.telemetry.schema import validate_file

    made = []
    log = root / f"router_{label}.jsonl"
    metrics = MetricsLogger(log, kind="router")
    router = Router(lambda name: InProcessReplica(
        name, lambda n: _fleet_engine(dev, cfg, params, made)),
        n_replicas=2, metrics=metrics, request_timeout=None,
        breaker_kw=dict(cooldown=0.05, jitter=0.0),
        policy_kw=dict(backoff=0.01, jitter=0.0))
    for k in (paged_flash_decode, _paged_flash_decode_int8):
        k.launches = 0
    t0 = time.time()
    for rid, (p, temp, seed) in reqs.items():
        router.submit(p, MAX_NEW, temperature=temp, seed=seed, rid=rid)
    for _ in range(10_000):
        router.step()
        mid = [r.rid for r in router.inflight.values()
               if r.replica == "r0" and 1 <= len(r.tokens) < r.max_new]
        if mid:
            break
    else:
        raise AssertionError(f"fleet {label}: no request mid-stream on r0")
    router._replicas["r0"]["handle"].kill()
    results = router.run(max_wall=300)
    served_s = time.time() - t0
    t1 = time.monotonic()
    while time.monotonic() - t1 < 30 and not (
            router.counters["respawns"] >= 1
            and router._breakers["r0"].state == "closed"):
        router.step()
        time.sleep(0.005)
    torch.cuda.synchronize()
    metrics.close()
    ticks = [e.counters["ticks"] for e in made]
    launches = paged_flash_decode.launches
    led = [e for e in router.events if e["event"] == "ledger"]
    states = [e["state"] for e in led if e.get("kind") == "breaker"]
    downs = [(e["replica"], e["fail_class"]) for e in led
             if e.get("kind") == "restart_downtime"]
    live = [e["handle"].engine for e in router._replicas.values()]
    unbalanced = [(e.alloc.n_free, e.alloc.n_cold, e.alloc.n_live)
                  for e in live if e.alloc.n_live
                  or e.alloc.n_free + e.alloc.n_cold != e.alloc.n_usable]
    bad = [rid for rid in reqs if rid not in results
           or results[rid].shape != (MAX_NEW,)
           or results[rid].min() < 0 or results[rid].max() >= cfg.vocab]
    out = {"layers": cfg.n_layers, "compute": str(cfg.act_dtype)[6:],
           "requests": len(reqs), "killed_mid_stream": sorted(mid),
           "failovers": router.counters["failovers"],
           "breaker": states, "restart_downtime": downs,
           "engines": len(made), "ticks": ticks, "k4_launches": launches,
           "served_s": served_s,
           "fleet_ttft_ms_p50": _p50([r["ttft_ms"] for r in router.records
                                      if "ttft_ms" in r])}
    problems = []
    if bad:
        problems.append(f"bad or missing streams {bad}")
    if router.counters["failovers"] < 1:
        problems.append("no failover")
    if states != ["open", "half_open", "closed"]:
        problems.append(f"breaker states {states}")
    if ("r0", "crash") not in downs:
        problems.append(f"restart_downtime {downs}")
    if validate_file(log):
        problems.append(f"router log: {validate_file(log)[:3]}")
    if unbalanced:
        problems.append(f"allocators unbalanced at drain {unbalanced}")
    if launches != cfg.n_layers * sum(ticks) or not sum(ticks) \
            or _paged_flash_decode_int8.launches:
        problems.append(f"K4 launched {launches} (int8 "
                        f"{_paged_flash_decode_int8.launches}) times over "
                        f"ticks {ticks} of {cfg.n_layers} layers")
    out["results"] = results
    out["problems"] = problems
    return out


def run_fleet_inprocess(dev, cfg32, params, phase3, root) -> dict:
    """Phase 21 (a): the drill in f32 at FLEET_F32_LAYERS layers, every
    stream held token for token to one solo engine's over the same
    requests; then in bf16 at full depth on phase 3's weights, every
    request complete and K4's count held, the greedy streams counted
    against phase 3's (`phase3`; a bf16 re-prefill may flip a near-tied
    argmax, so the count is printed, not gated)."""
    import torch

    reqs = _fleet_requests(cfg32.vocab)
    cfg2 = dataclasses.replace(cfg32, n_layers=FLEET_F32_LAYERS)
    params2 = dict(params, blocks=params["blocks"][:FLEET_F32_LAYERS])
    solo = _fleet_engine(dev, cfg2, params2)
    for rid, (p, temp, seed) in reqs.items():
        solo.submit(p, MAX_NEW, temperature=temp, seed=seed, rid=rid)
    oracle = solo.run()
    del solo
    f32 = _fleet_drill(dev, cfg2, params2, reqs, root, "f32")
    same = [rid for rid in reqs
            if np.array_equal(f32["results"].get(rid), oracle[rid])]
    f32["streams_equal_solo"] = f"{len(same)}/{len(reqs)}"
    if len(same) != len(reqs):
        f32["problems"].append(f"streams differ from the solo engine's: "
                               f"{sorted(set(reqs) - set(same))}")
    del f32["results"]
    print("fleet (a) f32: " + json.dumps(f32), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg32, compute_dtype=torch.bfloat16)
    bf16 = _fleet_drill(dev, cfg, params, reqs, root, "bf16")
    greedy = [rid for rid in phase3
              if np.array_equal(bf16["results"].get(rid), phase3[rid])]
    bf16["greedy_equal_phase3"] = f"{len(greedy)}/{len(phase3)}"
    del bf16["results"]
    print("fleet (a) bf16: " + json.dumps(bf16), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    problems = ([f"f32: {p}" for p in f32["problems"]]
                + [f"bf16: {p}" for p in bf16["problems"]])
    if problems:
        raise AssertionError("fleet (a): " + "; ".join(problems))
    return {"f32": f32, "bf16": bf16,
            "launches": [f32["k4_launches"], bf16["k4_launches"]]}


def _fleet_cli_flags(cfg) -> list:
    return ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
            "--n-heads", str(cfg.n_heads), "--n-layers",
            str(FLEET_CLI_LAYERS), "--max-seq", str(cfg.max_seq), "--rope",
            "--n-blocks", "256", "--block-size", str(SLICE["block_size"]),
            "--slots", str(SLICE["slots"]), "--prefill-chunk",
            str(PREFILL_CHUNK)]


def _fleet_cli_start(cfg, root, dev):
    """Phase 21 (b)'s router driver, started before (a) so that its
    children start up while (a) runs: `python -m
    shallowspeed_tpu_torch.router --replicas 2` on the card under
    FLEET_CHAOS, its stdout into root/router.out. A session of its own,
    so that the whole tree can be stopped."""
    reqs = root / "reqs.jsonl"
    reqs.write_text("".join(json.dumps(
        {"id": f"c{i}", "prompt_len": 96 + 32 * i, "prompt_seed": 40 + i,
         "max_new": FLEET_CLI_NEW,
         **({"temperature": 0.8, "seed": 7 + i} if i % 2 else {})}) + "\n"
        for i in range(FLEET_CLI_REQUESTS)))
    out = open(root / "router.out", "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "shallowspeed_tpu_torch.router",
             "--replicas", "2", *_fleet_cli_flags(cfg), "--device", dev.type,
             "--requests", str(reqs), "--log-file",
             str(root / "run" / "router.jsonl"), "--chaos-fleet",
             FLEET_CHAOS, "--chaos-state", str(root / "chaos"),
             "--backoff", "0.2", "--term-grace", "3",
             "--await-replicas", "120", "--settle", "60"],
            cwd=Path(__file__).resolve().parent, stdout=out,
            stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            start_new_session=True)
    finally:
        out.close()
    return proc, reqs


def _fleet_stop(proc) -> None:
    """SIGTERM to the router's session (the router's own teardown stops
    its replicas), then SIGKILL to whatever is left."""
    import signal

    for sig, wait in ((signal.SIGTERM, 10), (signal.SIGKILL, 10)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=wait)
        except subprocess.TimeoutExpired:
            continue
        try:                 # the replicas share the session
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return


def _fleet_lines(path) -> list:
    lines = []
    for x in Path(path).read_text().splitlines():
        try:
            rec = json.loads(x)
        except ValueError:
            continue
        if isinstance(rec, dict):
            lines.append(rec)
    return lines


def run_fleet_cli(dev, cfg, proc, reqs, root) -> dict:
    """Phase 21 (b): while the router runs, the plain `serve` over the
    same flags and requests in this process (the oracle); once every
    request has a result, `--fleet --once` over the replicas the
    router's endpoint lists; then the router's end. Every stream must
    equal the plain run's, with a failover, r0 respawned, and
    `--goodput` over the router log giving r0's MTTR and the fleet's
    availability."""
    import io
    import urllib.request

    from shallowspeed_tpu_torch import serve as sdriver
    from shallowspeed_tpu_torch.telemetry.fleet import fleet_main
    from shallowspeed_tpu_torch.telemetry.goodput import (format_report,
                                                          run_goodput)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sdriver.main([*_fleet_cli_flags(cfg), "--device", dev.type,
                      "--requests", str(reqs)])
    plain = {r["id"]: r["tokens"] for r in map(json.loads,
                                               buf.getvalue().splitlines())
             if r.get("event") == "result"}
    out_path = root / "router.out"
    t0 = time.time()
    table = None
    while proc.poll() is None and time.time() - t0 < FLEET_CLI_LIMIT_S:
        lines = _fleet_lines(out_path)
        done = [r for r in lines if r.get("event") == "result"]
        if table is None and len(done) == FLEET_CLI_REQUESTS:
            url = next(r["url"] for r in lines
                       if r.get("event") == "fleet_listening")
            with urllib.request.urlopen(url, timeout=10) as r:
                view = json.loads(r.read())
            urls = [rep["source"] for rep in view["replicas"].values()
                    if str(rep.get("source", "")).startswith("http")]
            got = []
            if fleet_main(urls, once=True, out=got.append) != 0:
                raise AssertionError(f"fleet (b): --fleet --once {got}")
            table = "\n".join(got)
            print("fleet (b) --fleet --once:\n" + table, flush=True)
        time.sleep(0.1)
    if proc.poll() is None:
        raise AssertionError(f"fleet (b): the router ran past "
                             f"{FLEET_CLI_LIMIT_S} s:\n"
                             + out_path.read_text()[-4000:])
    lines = _fleet_lines(out_path)
    res = {r["id"]: r.get("tokens") for r in lines
           if r.get("event") == "result"}
    summ = next((r for r in lines if r.get("event") == "summary"), {})
    ready = [(r["replica"], r["start_s"]) for r in lines
             if r.get("event") == "replica_ready"]
    log = root / "run" / "router.jsonl"
    rep = run_goodput(log)
    fl = rep.get("fleet") or {}
    same = [k for k, v in plain.items() if res.get(k) == v]
    out = {"rc": proc.returncode, "requests": FLEET_CLI_REQUESTS,
           "streams_equal_plain": f"{len(same)}/{len(plain)}",
           "replica_start_s": ready,
           "fleet_ttft_ms_p50": summ.get("ttft_ms_p50"),
           "fleet_ttft_ms_p95": summ.get("ttft_ms_p95"),
           "counters": summ.get("counters"), "wall_s": summ.get("wall_s"),
           "mttr": fl.get("mttr"),
           "fleet_availability": fl.get("fleet_availability")}
    print("fleet (b): " + json.dumps(out), flush=True)
    print("\n".join("  " + x for x in format_report(rep).splitlines()
                    if "fleet" in x or "mttr" in x), flush=True)
    problems = []
    if proc.returncode != 0:
        problems.append(f"router exit {proc.returncode}")
    if len(plain) != FLEET_CLI_REQUESTS or res != plain:
        problems.append(f"streams {out['streams_equal_plain']}")
    if not (summ.get("counters") or {}).get("failovers"):
        problems.append("no failover")
    if [n for n, _ in ready].count("r0") < 2:
        problems.append(f"r0 not respawned: {ready}")
    if "r0" not in (fl.get("mttr") or {}) \
            or fl.get("fleet_availability") is None:
        problems.append(f"--goodput fleet block {fl}")
    if table is None:
        problems.append("no --fleet --once view")
    if problems:
        raise AssertionError("fleet (b): " + "; ".join(problems) + "\n"
                             + out_path.read_text()[-4000:])
    return out


def run_fleet(dev, cfg32, params, phase3, card) -> dict:
    """Phase 21: (b)'s router started first, (a) in this process while
    its children start, then (b)'s oracle and checks; the router's
    whole session stopped on the way out, the directory removed."""
    import shutil
    import tempfile

    t0 = time.time()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    proc = None
    try:
        proc, reqs = _fleet_cli_start(cfg32, root, dev)
        a = run_fleet_inprocess(dev, cfg32, params, phase3, root)
        b = run_fleet_cli(dev, cfg32, proc, reqs, root)
    finally:
        if proc is not None:
            _fleet_stop(proc)
        shutil.rmtree(root, ignore_errors=True)
    print(f"fleet: phase 21 {time.time() - t0:.1f} s on {card}", flush=True)
    return {"a": a, "b": b, "launches": a["launches"]}


def _clock(phase: str) -> None:
    """Print the seconds since the script's start at the end of a phase
    (where the script's time goes)."""
    print(f"clock: phase {phase} done at {time.time() - _T0[0]:.1f} s",
          flush=True)


def main() -> int:
    import torch

    _T0[0] = time.time()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from shallowspeed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}",
          flush=True)

    t0 = time.time()
    _build.build(["paged_decode", "flash_fwd", "flash_bwd", "blocked_matmul"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        print(f"nvcc {name}:", flush=True)
        for line in _ptxas_lines(log):
            print("  " + line, flush=True)
    check_tc_builds(_build.build_logs)
    check_decode_builds(_build.build_logs, dev)

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.weights import leaves, params_from_numpy

    errs = check_kernels(dev)
    errs.update(check_train_kernels(dev))
    errs["dequant_matmul_tc"] = check_dequant_matmul(dev)
    errs["blocked_matmul_tc"] = check_blocked_matmul(dev)
    probe = run_probe()
    _clock("2b")
    cfg = slice_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype=None)
    t0 = time.time()
    np_params = T.init_numpy(cfg, seed=0)
    params = params_from_numpy(np_params, dev)     # f32 masters, shared
    print(f"init: {sum(a.size for a in leaves(np_params)) / 1e9:.3f}B "
          f"params in {time.time() - t0:.1f} s", flush=True)

    def served(**quant):
        run = serve(dev, cfg, params, **quant)
        out = (run["stats"], run["prompts"], run["eng"].results)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        return out

    stats, prompts, results = served()
    phase3 = dict(results)          # phase 21 (a) counts its bf16 streams
    check_logits(dev, cfg, params, prompts, results, LOGITS_TOL_BF16)
    check_logits(dev, cfg32, params, prompts, results, LOGITS_TOL_F32)
    check_f32_bound_catches_a_slip(dev, cfg32, params, prompts, results)
    timing = time_kernels(dev, stats)
    timing["blocked_matmul_tc"] = time_blocked_matmul(dev)
    timing["dequant_matmul_tc"] = time_dequant_matmul(dev)["head"]
    launches = {"paged_flash_decode": stats["launches"],
                "blocked_matmul_tc": probe["launches"]}
    runs = {"bf16": stats}

    runs["kv-int8"], _, results = served(kv_quant="int8")
    launches["paged_flash_decode_int8"] = runs["kv-int8"]["launches"]
    check_int8_logits(dev, cfg32, params, prompts, results)
    for mode in ("int8", "fp8"):
        runs[f"weight-{mode}"], _, results = served(weight_quant=mode)
        check_quant_weight_logits(dev, cfg, params, prompts, results, mode,
                                  LOGITS_TOL_BF16)
    launches["dequant_matmul_tc"] = \
        runs["weight-int8"]["dequant_matmul_tc_launches"]
    check_quant_weight_logits(dev, cfg32, params, prompts, results, "int8",
                              LOGITS_TOL_F32)
    keys = ("tick_ms_p50", "tick_ms_synthetic", "tick_device_busy_ms",
            "tick_idle_share", "tok_per_s", "ttft_ms_p50", "tpot_ms_p50",
            "peak_mem_gb")
    print("serve compare: " + json.dumps(
        {name: {k: r[k] for k in keys} for name, r in runs.items()}),
        flush=True)
    # the quantized-weight ticks against the bf16-weight tick (ROADMAP's
    # gate for dequant_matmul: at or under it), device busy ms
    busy = {name: r["tick_device_busy_ms"] for name, r in runs.items()}
    if all(v is not None for v in busy.values()):
        print("serve gate: " + json.dumps({
            f"weight-{m}": {"busy_ms": busy[f"weight-{m}"],
                            "bf16_busy_ms": busy["bf16"],
                            "at_or_under_bf16": busy[f"weight-{m}"]
                            <= busy["bf16"]}
            for m in ("int8", "fp8")}), flush=True)
    run_prefix(dev, cfg, cfg32, params)
    gc.collect()
    torch.cuda.empty_cache()
    run_spec(dev, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    run_generate(dev, cfg, params)
    _clock("5b")
    fleet = run_fleet(dev, cfg32, params, phase3, card)
    _clock("21")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    trained = train(dev, cfg, np_params)
    launches.update(trained["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    ckpt6b = run_data_ckpt(dev, dataclasses.replace(cfg, n_layers=CKPT_LAYERS))
    _clock("6b")
    check_training_parity(dev, cfg, np_params)
    gc.collect()
    torch.cuda.empty_cache()
    timing.update(time_train_kernels(dev))
    gc.collect()
    torch.cuda.empty_cache()
    run_mlp(dev, card)
    _clock("9")
    gc.collect()
    torch.cuda.empty_cache()

    recipe = run_recipe(dev, cfg, np_params, trained["peak_mem_gb"])
    _clock("10a")
    gc.collect()
    torch.cuda.empty_cache()
    fp8 = check_fp8_matmul(dev, card)
    errs.update(fp8["errs"])
    timing.update(fp8["timing"])
    fp8_lm = run_fp8_lm(dev, cfg, np_params, trained["losses"][0], card)
    gc.collect()
    torch.cuda.empty_cache()
    fp8_mlp = run_fp8_mlp(dev, cfg, np_params, card)
    launches["fp8_matmul_tc"] = fp8_lm["launches"]["fp8_matmul_tc"]
    launches["fp8_matmul_fma"] = fp8_mlp["launches"]["fp8_matmul_fma"]
    gc.collect()
    torch.cuda.empty_cache()
    errs["flash_fwd_tc_f32o"], timing["flash_fwd_tc_f32o"] = \
        check_ring_chunk(dev)
    check_ring_whole(dev)
    gc.collect()
    torch.cuda.empty_cache()
    cp = run_context_parallel(dev, cfg, np_params, card)
    launches["flash_fwd_tc_f32o"] = cp["launches"]["flash_fwd_tc_f32o"]
    # each driver phase's runs draw one (config, seed): draw it once
    with _cached_draw():
        run_cp_driver(dev, cfg)
    _clock("12")
    gc.collect()
    torch.cuda.empty_cache()
    run_feature_matrix(dev, cfg, np_params)
    gc.collect()
    torch.cuda.empty_cache()
    run_moe(dev, cfg)
    _clock("10c")
    gc.collect()
    torch.cuda.empty_cache()
    run_gspmd(dev, cfg, card, np_params)
    with _cached_draw():
        run_gspmd_driver(dev, cfg)
    _clock("13")
    gc.collect()
    torch.cuda.empty_cache()
    pp = run_pipeline(dev, cfg, np_params, trained["losses"][0], card)
    gc.collect()
    torch.cuda.empty_cache()
    with _cached_draw():
        run_pp_driver(dev, cfg)
    _clock("14")
    pp15 = run_pipeline(dev, cfg, np_params, trained["losses"][0], card,
                        PP15_LAYOUTS, PP15_PROFILED, ("b-",), pp.pop("refs"),
                        "pp15")
    del pp15["refs"]
    gc.collect()
    torch.cuda.empty_cache()
    with _cached_draw():
        run_pp_driver(dev, cfg, "15")
    _clock("15")
    ov = run_overlap(dev, dataclasses.replace(cfg, n_layers=OV_LAYERS),
                     {**np_params, "blocks": np_params["blocks"][:OV_LAYERS]},
                     card)
    # the overlapped runs' launches: (a)'s on-4mb steps and (b)'s on steps
    ov_launches = dict(ov["launches"])
    for k, v in run_overlap_zero2(dev, cfg, np_params,
                                  card)["on"]["launches"].items():
        ov_launches[k] = ov_launches.get(k, 0) + v
    run_overlap_fsdp(dev, cfg, np_params, card)
    gc.collect()
    torch.cuda.empty_cache()
    run_overlap_mlp(dev, card)
    with _cached_draw():
        run_overlap_driver(dev, cfg, card)
    _clock("16")
    mp = run_multiprocess(dev, cfg, np_params, card)
    _clock("17")
    gc.collect()
    torch.cuda.empty_cache()
    tele = run_telemetry(dev, cfg, card, np_params)
    _clock("18")
    mon = run_monitor(dev, cfg, card, tele, np_params)
    _clock("19")
    del np_params

    src = "shallowspeed_tpu_torch/csrc/"
    fa = "shallowspeed_tpu/ops/flash_attention.py:"
    mm = "shallowspeed_tpu/ops/matmul.py:"
    where = {"paged_flash_decode": ("paged_decode.cu", fa + "947"),
             "paged_flash_decode_int8": ("paged_decode.cu", fa + "947"),
             "flash_fwd_tc": ("flash_fwd.cu", fa + "487"),
             "flash_fwd_tc_f32o": ("flash_fwd.cu", fa + "487"),
             "flash_dq_tc": ("flash_bwd.cu", fa + "552"),
             "flash_dkv_tc": ("flash_bwd.cu", fa + "597"),
             "blocked_matmul_tc": ("blocked_matmul.cu", mm + "87"),
             "dequant_matmul_tc": ("blocked_matmul.cu", mm + "58"),
             "fp8_matmul_tc": ("blocked_matmul.cu", mm + "202"),
             "fp8_matmul_fma": ("blocked_matmul.cu", mm + "202")}
    kernels = [{
        "name": name, "route": "cuda", "source": src + cu,
        "replaces": ref, "launches": launches[name],
        "max_abs_err": errs[name], "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
        "device_ms": timing[name].get("device_ms"),
        "library_device_ms": timing[name].get("library_device_ms"),
        **({"recipe_launches": recipe["launches"][name]}
           if name in recipe["launches"] else {}),
        **({"cp_launches": cp["launches"][name]}
           if cp["launches"].get(name) else {}),
        **({"pp_launches": pp["launches"][name]}
           if pp["launches"].get(name) else {}),
        **({"pp15_launches": pp15["launches"][name]}
           if pp15["launches"].get(name) else {}),
        **({"ov_launches": ov_launches[name]}
           if ov_launches.get(name) else {}),
        **({"mp_launches": mp["launches"][name]}
           if mp["launches"].get(name) else {}),
        **({"tele_launches": tele["launches"][name]}
           if tele["launches"].get(name) else {}),
        **({"mon_launches": mon["launches"][name]}
           if mon["launches"].get(name) else {}),
        **({"drill_launches": ckpt6b["drill_launches"][name]}
           if name in ckpt6b["drill_launches"] else {}),
        **({"fleet_launches": fleet["launches"]}
           if name == "paged_flash_decode" else {}),
    } for name, (cu, ref) in where.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase17-worker"]:
        sys.exit(mp_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--phase20-child"]:
        sys.exit(drill_child(*sys.argv[2:]))
    sys.exit(main())
