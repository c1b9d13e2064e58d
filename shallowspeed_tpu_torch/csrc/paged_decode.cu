// Paged flash decode: one query token per slot attends over its KV cache
// through a block table. The row's live table columns are split over
// thread blocks, each of which streams its columns through a cp.async
// ring and keeps an online softmax per warp; a second kernel merges the
// splits' partial results.
//
// Replaces the TPU kernel `_paged_decode_kernel`, launched by
// `paged_flash_decode` in shallowspeed_tpu/ops/flash_attention.py
// (kernel :947-1016, pallas_call :1082, grid (s, hkv, w) at :1069-1081),
// both of its branches. Computes the same function:
//   out[s, h] = softmax_j(scale * q[s, h] . K[j]) V[j]
// over the cache positions j in [0, pos[s]] (and > pos[s] - window when
// window > 0), where position j lives at pool block bt[s, j / bs],
// offset j % bs, kv head h / G (GQA groups of G query heads per kv head).
//
// Float pools (`paged_decode`): K and V in q's dtype (f32 or bf16).
// int8 pools (`paged_decode_int8`, the TPU kernel's `quant` branch):
// K and V are int8 with one f32 scale per (block, kv head, position) in
// planes of shape (N, Hkv, bs, 1), so the bs scales of one (block, head)
// are contiguous at (blk * Hkv + head) * bs. The scales stay outside the
// dot products, as in the TPU kernel: K's multiplies the score row
// (s = (q . K_int8) * k_s * scale), V's folds into the probability row
// after the normaliser l has summed the UNSCALED probabilities
// (acc += (p * v_s) . V_int8). int8 values convert to f32 exactly.
// Scores, the running max m, the normaliser l and the accumulators are
// f32 (full f32 FMA; no tensor cores: at G = 1 each product is a dot
// product and the bound is bytes); masked positions get no probability;
// l is guarded by max(l, 1e-30); the output is written in q's dtype.
//
// Bound on the H100: HBM bytes. A call must read the live K/V blocks
// once, sum over rows of live_blocks * 2 * Hkv * bs * hd * itemsize
// (+ 2 * Hkv * bs * 4 scale bytes for int8 pools), and does ~4 flops per
// byte read (~8 with int8), two orders of magnitude under the card's
// ~295 flops/byte ridge in bf16. At the serving shape (8 slots x 16 kv
// heads, hd 128, bs 16, positions 128-1040) that is 0.0097 ms of bytes
// for bf16 pools and 0.0050 ms for int8 pools at 3.35 TB/s.
//
// What held the first design (one 128-thread block per (slot, kv head),
// walking its columns in order) at 20-49x that bound, and what this one
// does about each:
// - Too little parallelism: 128 blocks at the serving shape, four warps
//   an SM, one 16-position tile in flight per block (~8 KB an SM, where
//   3.35 TB/s needs tens of KB in flight an SM). Now the grid is
//   (split, kv head x row chunk, slot): each (slot, kv head) row's live
//   columns are cut into `splits` contiguous ranges, the split count
//   chosen on the host from shapes only (`decode_splits` in
//   ops/flash_attention.py), the range computed here from pos and
//   window, so long and short rows both spread over the SMs and no host
//   code reads pos. Each block keeps all but one tile of its cp.async
//   ring of 16-position tiles in flight (about 24 KB: 3 tiles of 8 KB
//   for bf16 K+V at hd 128, 5 of 4.2 KB for int8), several blocks an SM.
// - A serial chain on every column (f32 staging, four barriers, a
//   one-thread softmax per query row, a per-element PV loop, no load
//   overlapping any arithmetic). Now K and V land in shared memory in
//   the pools' own dtype and are converted in registers; q is converted
//   once and held in registers; warps own positions and lanes split hd
//   in groups (16 lanes x 8 dims at hd 128 when a warp holds at most two
//   query rows, so a warp step scores two positions), each dot product
//   is reduced by shuffles inside its lane group, and each lane group
//   keeps its own online softmax over batches of two steps, so the only
//   barrier a tile is the ring's one. The lane groups and then the warps
//   merge once at the end (shuffles, shared memory) and write f32
//   partials (m, l, unnormalised acc); an empty split writes m = -1e30,
//   l = 0, acc = 0. `paged_decode_combine_kernel` then rescales the
//   splits by exp(m_i - m) and writes sum(acc_i a_i) / max(sum(l_i a_i),
//   1e-30).
// - int8 converted at quarter rate (static_cast): now byte permutes and
//   one f32 subtraction (v + 128 in the low byte of 2^23, minus
//   2^23 + 128), as csrc/blocked_matmul.cu does; the scale rows of a
//   tile ride in its stage, read once per tile.
// A kv head's G query rows share every K/V load: rows are split over the
// warps when G >= 2 (row groups of 1, 2 or 4 warps' positions), up to 32
// rows a block; G > 32 takes a block per 32 rows ("row chunks").
// Everything the launch needs is fixed by the shapes (grid, scratch,
// shared memory, set once per kernel build), so a CUDA graph can capture
// it; nothing reads device data on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRingBytes = 24 * 1024;  // a block's cp.async ring, about
constexpr int kTile = 16;      // positions a tile holds (of one pool block)
constexpr int kBatch = 2;      // steps a warp scores before its update
constexpr int kMaxRows = 32;   // query rows a block holds

// What both kernels take; pointers to the dtypes the template says.
struct Args {
  const void* q;       // (S, H, hd) T
  const void* k;       // (N, Hkv, bs, hd) KV
  const float* ks;     // (N, Hkv, bs, 1) int8 pools only
  const void* v;
  const float* vs;
  const int* bt;       // (S, W)
  const int* pos;      // (S,)
  void* out;           // (S, H, hd) T
  float* pacc;         // (S, H, splits, hd) partial accumulators
  float* pml;          // (S, H, splits, 2) partial m, l
  int heads, kv_heads, block_size, width, window, splits;
  float scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N (2, 4 or 8) consecutive values at p as f32; p is aligned to their
// size (at most 16 bytes)
template <int N>
__device__ __forceinline__ void to_f32(const float* p, float* o) {
  if constexpr (N == 8) {
    to_f32<4>(p, o);
    to_f32<4>(p + 4, o + 4);
  } else if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  }
}

// bf16 -> f32 is a 16-bit shift; element 0 is the low half of a word
__device__ __forceinline__ void bf16x2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void to_f32(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    bf16x2(x.x, o);
    bf16x2(x.y, o + 2);
    bf16x2(x.z, o + 4);
    bf16x2(x.w, o + 6);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    bf16x2(x.x, o);
    bf16x2(x.y, o + 2);
  } else {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), o);
  }
}

// int8 v without int-to-float conversions (quarter rate): v + 128 goes
// into the low mantissa byte of 2^23, and one subtraction of 2^23 + 128
// gives v exactly
__device__ __forceinline__ void i8x4(uint32_t u, float* o, int n) {
  u ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n)
      o[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
             8388736.f;
}

template <int N>
__device__ __forceinline__ void to_f32(const int8_t* p, float* o) {
  if constexpr (N == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    i8x4(x.x, o, 4);
    i8x4(x.y, o + 4, 4);
  } else if constexpr (N == 4) {
    i8x4(*reinterpret_cast<const uint32_t*>(p), o, 4);
  } else {
    i8x4(*reinterpret_cast<const uint16_t*>(p), o, 2);
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);  // round to nearest even
}

// Shared memory of one block: the ring of tiles (K, V and, for int8
// pools, their two scale rows), 2 to 8 of them in about kRingBytes, then
// each warp's rows for the merge.
template <typename KV, int HD>
struct Ring {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kKV = kTile * HD * static_cast<int>(sizeof(KV));
  static constexpr int kStage = 2 * kKV + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kFit = kRingBytes / kStage;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  static constexpr int kBytes = kStages * kStage;
};

template <typename KV, int HD, int GMAX>
constexpr int smem_bytes() {
  return Ring<KV, HD>::kBytes + kWarps * GMAX * (HD + 2) * 4;
}

// Row groups of a block holding `rows` query rows: the warps split the
// rows (1, 2 or 4 ways) and each group's warps split the positions.
__host__ __device__ __forceinline__ int row_groups(int rows) {
  return rows >= 4 ? 4 : (rows >= 2 ? 2 : 1);
}

// The split pass. Block (split, kv head x row chunk, slot) takes columns
// [cb, ce) of its row's live ones and writes f32 partials for its rows.
// Lanes form groups of kLanes, each group scores one position a step
// (kDims dims a lane), so a warp step scores 32 / kLanes positions.
template <typename T, typename KV, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel(const Args a) {
  using R = Ring<KV, HD>;
  constexpr bool kQuant = R::kQuant;
  constexpr int kStages = R::kStages;
  constexpr int kDims = GMAX <= 2 ? 8 : 4;  // dims a lane owns
  constexpr int kLanes = HD / kDims;        // lanes a position takes
  constexpr int kPer = 32 / kLanes;         // positions a warp step scores
  extern __shared__ __align__(16) unsigned char smem[];
  float* merge = reinterpret_cast<float*>(smem + R::kBytes);

  const int groups = a.heads / a.kv_heads;
  const int chunks = (groups + kMaxRows - 1) / kMaxRows;
  const int split = blockIdx.x;
  const int head = blockIdx.y / chunks;
  const int row0 = (blockIdx.y % chunks) * kMaxRows;
  const int nrows = min(kMaxRows, groups - row0);
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane / kLanes;             // this lane's position a step
  const int dim0 = (lane % kLanes) * kDims;  // this lane's first dim
  const int bs = a.block_size;
  const int window = a.window;
  const int splits = a.splits;

  // this row's live columns, and the block's share of them
  const int p = a.pos[slot];
  int c_lo = 0;
  if (window > 0 && p - window + 1 > 0) c_lo = (p - window + 1) / bs;
  const int c_hi = min(a.width - 1, p / bs);
  const int live = max(0, c_hi - c_lo + 1);
  const int cb = c_lo + live * split / splits;
  const int ce = c_lo + live * (split + 1) / splits;
  // partial row of chunk row g: ((slot * H + head * G + row0 + g) * splits
  // + split)
  const size_t prow0 =
      (static_cast<size_t>(slot) * a.heads + head * groups + row0) * splits +
      split;

  if (cb >= ce) {  // nothing to read: the merge's identity
    for (int e = tid; e < nrows * HD; e += kThreads)
      a.pacc[(prow0 + static_cast<size_t>(e / HD) * splits) * HD + e % HD] =
          0.f;
    for (int g = tid; g < nrows; g += kThreads) {
      a.pml[2 * (prow0 + static_cast<size_t>(g) * splits)] = kNeg;
      a.pml[2 * (prow0 + static_cast<size_t>(g) * splits) + 1] = 0.f;
    }
    return;
  }

  // warp -> (row group rg, position way pw); its rows row0 + rg + r * n_rg
  const int n_rg = row_groups(nrows);
  const int n_pw = kWarps / n_rg;
  const int rg = warp / n_pw;
  const int pw = warp % n_pw;
  const int nr = (nrows - rg + n_rg - 1) / n_rg;  // this warp's rows

  const T* q = static_cast<const T*>(a.q);
  float qr[GMAX][kDims], acc[GMAX][kDims], m[GMAX], l[GMAX];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[r][e] = qr[r][e] = 0.f;
    if (r < nr) {
      const size_t row = static_cast<size_t>(slot) * a.heads +
                         head * groups + row0 + rg + r * n_rg;
      to_f32<kDims>(q + row * HD + dim0, qr[r]);
    }
  }

  // the ring: tile i is positions [o, o + len) of column cb + i / nch
  const KV* kp = static_cast<const KV*>(a.k);
  const KV* vp = static_cast<const KV*>(a.v);
  const int* brow = a.bt + static_cast<size_t>(slot) * a.width;
  const int nch = (bs + kTile - 1) / kTile;
  const int n = (ce - cb) * nch;
  auto block_of = [&](int i) { return i < n ? brow[cb + i / nch] : 0; };
  auto issue = [&](int i, int blk) {
    if (i < n) {
      const int o = (i % nch) * kTile;
      const int len = min(kTile, bs - o);
      const size_t plane = static_cast<size_t>(blk) * a.kv_heads + head;
      const size_t off = (plane * bs + o) * HD;
      unsigned char* st = smem + (i % kStages) * R::kStage;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kp + off);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vp + off);
      const int bytes = len * HD * static_cast<int>(sizeof(KV));
      for (int b = tid * 16; b < bytes; b += kThreads * 16) {
        cp_async16(st + b, ksrc + b);
        cp_async16(st + R::kKV + b, vsrc + b);
      }
      if constexpr (kQuant) {
        float* sc = reinterpret_cast<float*>(st + 2 * R::kKV);
        if (tid < len) {
          cp_async4(sc + tid, a.ks + plane * bs + o + tid);
          cp_async4(sc + kTile + tid, a.vs + plane * bs + o + tid);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, block_of(i));
  // the table entry of the next tile to issue is read a tile ahead, so
  // its load is not on the issue's path
  int next = block_of(kStages - 1);

  // a warp step covers positions t0 + [0, kPer) of a tile, one per lane
  // group; the warps of a row group interleave their steps
  const int stride = n_pw * kPer;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    issue(i + kStages - 1, next);  // into tile i - 1's stage
    next = block_of(i + kStages);
    const unsigned char* st = smem + (i % kStages) * R::kStage;
    const KV* kt = reinterpret_cast<const KV*>(st) + dim0;
    const KV* vt = reinterpret_cast<const KV*>(st + R::kKV) + dim0;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * R::kKV);
    const float* vsc = ksc + kTile;
    const int o = (i % nch) * kTile;
    const int len = min(kTile, bs - o);
    const int j0 = (cb + i / nch) * bs + o;

    for (int t0 = pw * kPer; t0 < len; t0 += kBatch * stride) {
      float s[GMAX][kBatch], vf[kBatch][kDims];
      bool ok[kBatch];
      int tt[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int t = t0 + b * stride + sub;
        const int j = j0 + t;
        ok[b] = t < len && j <= p && (window <= 0 || j > p - window);
        tt[b] = min(t, kTile - 1);  // stays inside the stage
        float kf[kDims];
        to_f32<kDims>(kt + tt[b] * HD, kf);
        to_f32<kDims>(vt + tt[b] * HD, vf[b]);
#pragma unroll
        for (int r = 0; r < GMAX; ++r) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kDims; ++e) d = fmaf(qr[r][e], kf[e], d);
          s[r][b] = d;
        }
      }
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        if (r >= nr) break;  // warp-uniform
#pragma unroll
        for (int x = kLanes / 2; x > 0; x >>= 1)
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
            s[r][b] += __shfl_xor_sync(0xffffffffu, s[r][b], x);
        // the lanes of a group hold the same sums: their branches agree
        float mx = m[r];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (!ok[b]) continue;
          float sc = s[r][b];
          if constexpr (kQuant) sc *= ksc[tt[b]];  // K's scale
          s[r][b] = sc * a.scale;
          mx = fmaxf(mx, s[r][b]);
        }
        if (mx > m[r]) {
          const float alpha = expf(m[r] - mx);
          l[r] *= alpha;
#pragma unroll
          for (int e = 0; e < kDims; ++e) acc[r][e] *= alpha;
          m[r] = mx;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (!ok[b]) continue;
          float pr = expf(s[r][b] - m[r]);
          l[r] += pr;  // l sums the unscaled probabilities
          if constexpr (kQuant) pr *= vsc[tt[b]];  // V's scale
#pragma unroll
          for (int e = 0; e < kDims; ++e)
            acc[r][e] = fmaf(pr, vf[b][e], acc[r][e]);
        }
      }
    }
  }

  // merge the warp's lane groups (butterfly over the group index), then
  // the warps that share rows, through shared memory
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r >= nr) break;
#pragma unroll
    for (int x = kLanes; x < 32; x <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], x);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], x);
      const float mx = fmaxf(m[r], mo);
      const float a0 = expf(m[r] - mx);
      const float a1 = expf(mo - mx);
      l[r] = l[r] * a0 + lo * a1;
#pragma unroll
      for (int e = 0; e < kDims; ++e)
        acc[r][e] = acc[r][e] * a0 +
                    __shfl_xor_sync(0xffffffffu, acc[r][e], x) * a1;
      m[r] = mx;
    }
  }
  constexpr int kWarpFloats = GMAX * (HD + 2);
  float* mine = merge + warp * kWarpFloats;
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r >= nr) break;
    if (sub == 0) {
#pragma unroll
      for (int e = 0; e < kDims; ++e) mine[r * HD + dim0 + e] = acc[r][e];
    }
    if (lane == 0) {
      mine[GMAX * HD + r] = m[r];
      mine[GMAX * HD + GMAX + r] = l[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    const float* w0 = merge + (g % n_rg) * n_pw * kWarpFloats;
    const int r = g / n_rg;
    float mx = kNeg;
    for (int w = 0; w < n_pw; ++w)
      mx = fmaxf(mx, w0[w * kWarpFloats + GMAX * HD + r]);
    float sum = 0.f, norm = 0.f;
    for (int w = 0; w < n_pw; ++w) {
      const float* ws = w0 + w * kWarpFloats;
      const float alpha = expf(ws[GMAX * HD + r] - mx);
      sum = fmaf(ws[r * HD + d], alpha, sum);
      norm = fmaf(ws[GMAX * HD + GMAX + r], alpha, norm);
    }
    const size_t prow = prow0 + static_cast<size_t>(g) * splits;
    a.pacc[prow * HD + d] = sum;
    if (d == 0) {
      a.pml[2 * prow] = mx;
      a.pml[2 * prow + 1] = norm;
    }
  }
}

// The merge pass: one warp per (slot, query head) row rescales its
// splits' partials to their common max and normalises. The lanes read
// the splits' (m, l) 32 at a time; the accumulators are read with
// several loads in flight.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(const Args a, int rows) {
  constexpr int kDims = HD / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int splits = a.splits;
  const float* ml = a.pml + static_cast<size_t>(row) * splits * 2;
  const float* pa =
      a.pacc + static_cast<size_t>(row) * splits * HD + lane * kDims;
  float mx = kNeg;
  for (int i = lane; i < splits; i += 32) mx = fmaxf(mx, ml[2 * i]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  float norm = 0.f, acc[kDims] = {};
  for (int i0 = 0; i0 < splits; i0 += 32) {
    const int i = i0 + lane;
    const float alpha = i < splits ? expf(ml[2 * i] - mx) : 0.f;
    if (i < splits) norm = fmaf(ml[2 * i + 1], alpha, norm);
    const int cnt = min(32, splits - i0);
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float ak = __shfl_sync(0xffffffffu, alpha, k);
      float x[kDims];
      to_f32<kDims>(pa + static_cast<size_t>(i0 + k) * HD, x);
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[e] = fmaf(x[e], ak, acc[e]);
    }
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    norm += __shfl_xor_sync(0xffffffffu, norm, x);
  const float den = fmaxf(norm, 1e-30f);
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(row) * HD +
           lane * kDims;
#pragma unroll
  for (int e = 0; e < kDims; ++e) store(out + e, acc[e] / den);
}

// rows a warp holds for a group of `groups` query rows: 1, 2, 4 or 8
int rows_per_warp(int groups) {
  const int rows = groups < kMaxRows ? groups : kMaxRows;
  const int per = (rows + row_groups(rows) - 1) / row_groups(rows);
  return per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : 8;
}

// Both passes on `stream`; the split kernel's shared memory above 48 KB
// is allowed once per build of the instance.
template <typename T, typename KV, int HD, int GMAX>
int launch_gmax(const Args& a, int slots, cudaStream_t stream) {
  constexpr int smem = smem_bytes<KV, HD, GMAX>();
  void (*kernel)(const Args) = paged_decode_kernel<T, KV, HD, GMAX>;
  static const cudaError_t allowed =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem)
          : cudaSuccess;
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const int groups = a.heads / a.kv_heads;
  const int chunks = (groups + kMaxRows - 1) / kMaxRows;
  kernel<<<dim3(a.splits, a.kv_heads * chunks, slots), kThreads, smem,
           stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = slots * a.heads;
  paged_decode_combine_kernel<T, HD>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int HD>
int launch_hd(const Args& a, int slots, cudaStream_t stream) {
  switch (rows_per_warp(a.heads / a.kv_heads)) {
    case 1: return launch_gmax<T, KV, HD, 1>(a, slots, stream);
    case 2: return launch_gmax<T, KV, HD, 2>(a, slots, stream);
    case 4: return launch_gmax<T, KV, HD, 4>(a, slots, stream);
    default: return launch_gmax<T, KV, HD, 8>(a, slots, stream);
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q's and out's; the pools' too unless
// int8); head_dim 64 or 128
template <bool kQuant>
int launch(const Args& a, int slots, int head_dim, int dtype,
           cudaStream_t stream) {
  if (dtype == 0) {
    using KV = std::conditional_t<kQuant, int8_t, float>;
    if (head_dim == 64) return launch_hd<float, KV, 64>(a, slots, stream);
    if (head_dim == 128) return launch_hd<float, KV, 128>(a, slots, stream);
  }
  if (dtype == 1) {
    using KV = std::conditional_t<kQuant, int8_t, __nv_bfloat16>;
    if (head_dim == 64)
      return launch_hd<__nv_bfloat16, KV, 64>(a, slots, stream);
    if (head_dim == 128)
      return launch_hd<__nv_bfloat16, KV, 128>(a, slots, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* ks, const void* v,
               const void* vs, const void* bt, const void* pos, void* out,
               void* part, int slots, int heads, int kv_heads, int head_dim,
               int block_size, int width, int window, int splits) {
  float* pacc = static_cast<float*>(part);
  return Args{q, k, static_cast<const float*>(ks), v,
              static_cast<const float*>(vs), static_cast<const int*>(bt),
              static_cast<const int*>(pos), out, pacc,
              pacc + static_cast<size_t>(slots) * heads * splits * head_dim,
              heads, kv_heads, block_size, width, window, splits,
              1.0f / sqrtf(static_cast<float>(head_dim))};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out). head_dim: 64
// or 128. `part` is f32 scratch of slots * heads * splits * (head_dim +
// 2) floats. Launches the split pass and the merge pass; returns the
// first failing launch's cudaGetLastError() (0 = success). Shapes are
// checked by the Python wrapper before the call.
int paged_decode(const void* q, const void* k, const void* v, const void* bt,
                 const void* pos, void* out, void* part, int slots, int heads,
                 int kv_heads, int head_dim, int block_size, int width,
                 int window, int splits, int dtype, void* stream) {
  const Args a = make_args(q, k, nullptr, v, nullptr, bt, pos, out, part,
                           slots, heads, kv_heads, head_dim, block_size,
                           width, window, splits);
  return launch<false>(a, slots, head_dim, dtype,
                       static_cast<cudaStream_t>(stream));
}

// int8 pools k, v with f32 scale planes ks, vs (N, Hkv, bs, 1); dtype
// (0 = float32, 1 = bfloat16) is q's and out's. Otherwise as
// `paged_decode`.
int paged_decode_int8(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* bt,
                      const void* pos, void* out, void* part, int slots,
                      int heads, int kv_heads, int head_dim, int block_size,
                      int width, int window, int splits, int dtype,
                      void* stream) {
  const Args a = make_args(q, k, ks, v, vs, bt, pos, out, part, slots, heads,
                           kv_heads, head_dim, block_size, width, window,
                           splits);
  return launch<true>(a, slots, head_dim, dtype,
                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the split kernel for `groups` query rows per
// kv head; pools: 0 = float32, 1 = bfloat16, 2 = int8. -1 if not built.
int paged_decode_smem(int groups, int head_dim, int pools) {
  const int g = rows_per_warp(groups);
  auto pick = [g](auto kv, auto hd) {
    using KV = decltype(kv);
    constexpr int HD = decltype(hd)::value;
    return g == 1   ? smem_bytes<KV, HD, 1>()
           : g == 2 ? smem_bytes<KV, HD, 2>()
           : g == 4 ? smem_bytes<KV, HD, 4>()
                    : smem_bytes<KV, HD, 8>();
  };
  using H64 = std::integral_constant<int, 64>;
  using H128 = std::integral_constant<int, 128>;
  if (head_dim != 64 && head_dim != 128) return -1;
  const bool wide = head_dim == 128;
  if (pools == 0) return wide ? pick(0.f, H128{}) : pick(0.f, H64{});
  if (pools == 1)
    return wide ? pick(__nv_bfloat16{}, H128{}) : pick(__nv_bfloat16{}, H64{});
  if (pools == 2)
    return wide ? pick(int8_t{}, H128{}) : pick(int8_t{}, H64{});
  return -1;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
