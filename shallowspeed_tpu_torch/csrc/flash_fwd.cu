// Flash-attention forward (K1): O = softmax(scale * Q K^T + mask) V and
// the f32 row log-sum-exp, in one pass with an online softmax.
//
// Replaces the TPU kernels `_fwd_kernel_resident` and `_fwd_kernel`,
// launched by `_chunk_fwd` in shallowspeed_tpu/ops/flash_attention.py
// (kernels :146 and :191, pallas_call :510 and :530). Same function:
// query row i (global position rel + i) attends to key column j when
// rel + i >= j (causal) and j > rel + i - window (window > 0); masked
// scores are -1e30 and their probabilities exactly 0; l is guarded by
// max(l, 1e-30), so a row that sees nothing comes out 0 with lse -1e30.
// GQA: query head h reads kv head h / (H / Hkv); K/V are never repeated.
//
// Bound on the H100: operations. At the training shape (B 4, H 16,
// T 2048, hd 128, causal) it does 4 * hd flops per live (row, column)
// pair, ~69 GFLOP, against ~50 MB of q, k, v and o: over 1,000 flops a
// byte, far past the card's ridge. Only the tensor cores (989 TFLOP/s in
// bf16, against 67 for f32 FMA) can bring it near that bound.
//
// Two builds, chosen by dtype in the C entry:
// - bf16, the main path's (training, generate()'s prefill):
//   `flash_fwd_tc_kernel`, every product on the tensor cores. One
//   warpgroup per 64-row query tile; TMA streams the K/V tiles through
//   two stages of 128B-swizzled shared memory, the next tile's load in
//   flight under this one's math; S = Q K^T and O += P V are wgmma
//   (m64n64k16 from shared memory; m64n{64,128}k16 with P, rounded to
//   bf16 in registers, as the A operand and V read transposed). The
//   online softmax runs on the accumulator fragment in registers, so P
//   never touches shared memory; l sums the unrounded P in f32. Two
//   blocks an SM (83 KB of shared memory at hd 128), so one block's
//   softmax overlaps the other's products. Its epilogue writes o as bf16
//   or, for ring attention's chunks (`out_dtype` float32 in the wrapper,
//   `_chunk_fwd(out_dtype=jnp.float32)` in the reference), as f32 from
//   the same f32 accumulator, so the log-sum-exp merge of the hops sees
//   each chunk's output unrounded.
// - f32: `flash_fwd_kernel`, full f32 FMA on the CUDA cores (no TF32,
//   which would break the f32 parity bounds): tiles staged in shared
//   memory as f32, 256 threads, each owning 4 rows of the (m, l, acc)
//   carry in registers.
// Both: one block per (64-row query tile, query head, batch row), query
// tiles issued last-first so the long causal rows start early; the TPU's
// sequential K/V grid axis becomes a loop inside the block over the live
// K/V tiles only (bounds from causal, window and rel, as `_kblock_bounds`
// sets them): dead tiles are never loaded. Inputs are read through their
// strides (the model's q, k, v are slices of one fused projection), so
// the wrapper copies nothing. Rows past T and columns past Tk are
// masked, so T need not be a multiple of the tile.

#include "flash_common.cuh"
#include "flash_tc.cuh"

#include <cmath>

namespace {

using flash::Dims;
using flash::kNeg;
using flash::kScoreStride;
using flash::kThreads;
using flash::kTile;
using flash::Layout;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
                     Layout lo, int heads, int kv_heads, int tq, int tk,
                     int causal, int window, int rel, float scale) {
  constexpr int kCols = Dims<D>::kCols;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + Dims<D>::kTileFloats;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* p_s = v_s + Dims<D>::kTileFloats;   // (64, kScoreStride)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  flash::load_tile<T, D>(q, lq, b, h, q0, tq, q_s);

  // live K/V tiles for rows [q0, q0 + 64) at global rel + row
  const int nkb = (tk + kTile - 1) / kTile;
  const int q_first = rel + q0;
  const int q_last = rel + min(q0 + kTile, tq) - 1;
  int kt_lo = 0, kt_hi = nkb;
  if (causal) kt_hi = q_last < 0 ? 0 : min(nkb, q_last / kTile + 1);
  if (window > 0) kt_lo = min(nkb, max(0, q_first - window + 1) / kTile);

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with k, v, p
    flash::load_tile<T, D>(k, lk, b, hk, k0, tk, k_s);
    flash::load_tile<T, D>(v, lv, b, hk, k0, tk, v_s);
    __syncthreads();

    float s[4][4];
    flash::dot_tile<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int grow = rel + q0 + ty + 16 * i;
      bool ok[4];
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < tk && flash::visible(grow, col, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], flash::half_warp_max(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kScoreStride + tx + 16 * j] = p;
        row_sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + flash::half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    flash::accumulate_pv<D>(p_s, v_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const float lg = fmaxf(l[i], 1e-30f);
    T* dst = o + b * lo.b + row * lo.t + h * lo.h;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      flash::store4(dst + 4 * tx + 64 * jj,
                    make_float4(acc[i][4 * jj] / lg, acc[i][4 * jj + 1] / lg,
                                acc[i][4 * jj + 2] / lg,
                                acc[i][4 * jj + 3] / lg));
    }
    if (tx == 0)
      lse[(static_cast<long long>(b) * heads + h) * tq + row] = m[i] + logf(lg);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           Layout lq, Layout lk, Layout lv, Layout lo, int batch, int heads,
           int kv_heads, int tq, int tk, int causal, int window, int rel,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * Dims<D>::kTileFloats +
                                       kTile * kScoreStride);
  auto kernel = flash_fwd_kernel<T, D>;
  const int e = flash::set_smem(kernel, smem);
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((tq + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      lq, lk, lv, lo, heads, kv_heads, tq, tk, causal, window, rel, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- the bf16 build: wgmma

namespace tc = flash_tc;

// One warpgroup per (64-row query tile, query head, batch row). Query
// tiles are issued last-first. Thread 0 loads the Q tile once and streams
// the live K/V tiles through two stages of shared memory by TMA, the next
// tile's load in flight while this one's math runs. Per K/V tile:
// S = Q K^T (wgmma, both from shared memory), the online softmax on the
// f32 accumulator in registers (rows reduced over the quad, the mask
// tested only on tiles that cross the diagonal, the window edge or Tk),
// l summed from the unrounded probabilities, then O += P V with P
// rounded to bf16 as the register A operand and V read transposed.
template <int D, bool kF32Out>
__global__ void __launch_bounds__(tc::kThreads, 2)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        void* __restrict__ o_raw,
                        float* __restrict__ lse, Layout lo, int heads,
                        int kv_heads, int tq, int tk, int causal, int window,
                        int rel, float scale_log2) {
  constexpr int kTile = tc::Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                   // then stage s: K, V
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 5 * kTile);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = 16 * (tid / 32) + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);

  // live K/V tiles for rows [q0, q0 + 64) at global rel + row
  const int nkb = (tk + tc::kRows - 1) / tc::kRows;
  const int q_first = rel + q0;
  const int q_last = rel + min(q0 + tc::kRows, tq) - 1;
  int kt_lo = 0, kt_hi = nkb;
  if (causal) kt_hi = q_last < 0 ? 0 : min(nkb, q_last / tc::kRows + 1);
  if (window > 0) kt_lo = min(nkb, max(0, q_first - window + 1) / tc::kRows);
  const int n = max(0, kt_hi - kt_lo);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tc::bar_init(&bars[i]);
    tc::fence_bar_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    tc::bar_expect(&bars[0], kTile);
    tc::load_tile<D>(q_s, &mq, &bars[0], q0, h, b);
    tc::bar_expect(&bars[1], 2 * kTile);
    tc::load_tile<D>(base + kTile, &mk, &bars[1], kt_lo * tc::kRows, hk, b);
    tc::load_tile<D>(base + 2 * kTile, &mv, &bars[1], kt_lo * tc::kRows, hk,
                     b);
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg};   // running max, log2 units
  float l[2] = {0.f, 0.f};     // this thread's part of the row sums
  const uint32_t q_addr = tc::smem_u32(q_s);
  if (n > 0) tc::bar_wait(&bars[0], 0);

  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const int k0 = (kt_lo + i) * tc::kRows;
    if (i + 1 < n) {
      __syncthreads();   // every warp is done with stage s ^ 1
      if (tid == 0) {
        uint8_t* next = base + (1 + 2 * (s ^ 1)) * kTile;
        tc::bar_expect(&bars[1 + (s ^ 1)], 2 * kTile);
        tc::load_tile<D>(next, &mk, &bars[1 + (s ^ 1)], k0 + tc::kRows, hk,
                         b);
        tc::load_tile<D>(next + kTile, &mv, &bars[1 + (s ^ 1)],
                         k0 + tc::kRows, hk, b);
      }
    }
    tc::bar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint32_t k_addr = tc::smem_u32(base + (1 + 2 * s) * kTile);
    const uint32_t v_addr = k_addr + kTile;

    float sc[32];
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(sc, tc::desc_k(q_addr, ks), tc::desc_k(k_addr, ks),
                       ks > 0);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(sc);

    // the whole tile is visible unless it crosses Tk, the diagonal or
    // the window's edge (rows past Tq are never stored)
    const bool edge = k0 + tc::kRows > tk ||
                      (causal && rel + q0 < k0 + tc::kRows - 1) ||
                      (window > 0 && k0 <= rel + q0 + tc::kRows - 1 - window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int grow = rel + q0 + row0 + 8 * ((e >> 1) & 1);
        const int col = k0 + 8 * (e >> 2) + col0 + (e & 1);
        if (!(col < tk && tc::visible(grow, col, causal, window)))
          sc[e] = -INFINITY;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      // masked scores are -inf: exp2 gives exactly 0, and m stays finite
      const float m_new = fmaxf(m[r], tc::quad_max(mx) * scale_log2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * r + e];
          x = exp2f(fmaf(x, scale_log2, -m_new));
          sum += x;
        }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::p_frag(sc, kk, pf[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<D>(acc, pf[kk], tc::desc_mn(v_addr, kk));
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const float lg = fmaxf(tc::quad_sum(l[r]), 1e-30f);
    if (row >= tq) continue;
    const float inv = 1.f / lg;
    const long long at = b * lo.b + row * lo.t + h * lo.h + col0;
    if constexpr (kF32Out) {
      float* dst = static_cast<float*>(o_raw) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(o_raw) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * heads + h) * tq + row] =
          m[r] <= kNeg ? kNeg : m[r] * tc::kLn2 + logf(lg);
  }
}

template <int D>
constexpr int tc_smem() {
  return 5 * tc::Tile<D>::kBytes + 3 * 8 + 1024;
}

template <int D, bool kF32Out>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, Layout lq, Layout lk, Layout lv, Layout lo,
              int batch, int heads, int kv_heads, int tq, int tk, int causal,
              int window, int rel, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e = tc::tile_map(&mq, q, lq, batch, tq, heads, D);
  if (e == 0) e = tc::tile_map(&mk, k, lk, batch, tk, kv_heads, D);
  if (e == 0) e = tc::tile_map(&mv, v, lv, batch, tk, kv_heads, D);
  if (e != 0) return e;
  auto kernel = flash_fwd_tc_kernel<D, kF32Out>;
  e = tc::set_smem(reinterpret_cast<const void*>(kernel), tc_smem<D>());
  if (e != 0) return e;
  const float scale_log2 = tc::kLog2e / sqrtf(static_cast<float>(D));
  const dim3 grid((tq + tc::kRows - 1) / tc::kRows, heads, batch);
  kernel<<<grid, tc::kThreads, tc_smem<D>(), stream>>>(
      mq, mk, mv, o, static_cast<float*>(lse), lo, heads, kv_heads, tq, tk, causal, window, rel, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of q, k, v; out_dtype that of o:
// q's, or float32 for bfloat16 q (the tensor-core build's f32 epilogue).
// head_dim 64 or 128. Strides are in elements, (batch, seq, head) for
// each of q, k, v, o; head_dim is contiguous. lse is (batch, heads, tq)
// f32, contiguous. Returns the launch's cudaGetLastError() (0 =
// success); the Python wrapper checks shapes, types and alignment
// before the call.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              long long qb, long long qt, long long qh, long long kb,
              long long kt, long long kh, long long vb, long long vt,
              long long vh, long long ob, long long ot, long long oh,
              int batch, int heads, int kv_heads, int tq, int tk,
              int head_dim, int causal, int window, int rel, int dtype,
              int out_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lq{qb, qt, qh}, lk{kb, kt, kh}, lv{vb, vt, vh}, lo{ob, ot, oh};
#define FLASH_FWD(T, D)                                                     \
  return launch<T, D>(q, k, v, o, lse, lq, lk, lv, lo, batch, heads,       \
                      kv_heads, tq, tk, causal, window, rel, s)
  if (dtype == 0 && out_dtype == 0 && head_dim == 64) FLASH_FWD(float, 64);
  if (dtype == 0 && out_dtype == 0 && head_dim == 128) FLASH_FWD(float, 128);
#undef FLASH_FWD
#define FLASH_FWD_TC(D, F32)                                               \
  return launch_tc<D, F32>(q, k, v, o, lse, lq, lk, lv, lo, batch, heads,  \
                           kv_heads, tq, tk, causal, window, rel, s)
  if (dtype == 1 && out_dtype == 1 && head_dim == 64) FLASH_FWD_TC(64, false);
  if (dtype == 1 && out_dtype == 1 && head_dim == 128)
    FLASH_FWD_TC(128, false);
  if (dtype == 1 && out_dtype == 0 && head_dim == 64) FLASH_FWD_TC(64, true);
  if (dtype == 1 && out_dtype == 0 && head_dim == 128) FLASH_FWD_TC(128, true);
#undef FLASH_FWD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the bf16 (tensor-core) kernel, in bytes.
int flash_fwd_tc_smem(int head_dim) {
  return head_dim == 64 ? tc_smem<64>() : tc_smem<128>();
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
