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
// byte, far past the card's ridge.
//
// Design (simple and right first; wgmma, TMA and warp specialisation
// are later work):
// - One thread block per (64-row query tile, query head, batch row). The
//   TPU's sequential K/V grid axis becomes a loop inside the block, and
//   the (m, l, acc) carry lives in registers: each thread owns 4 rows of
//   the tile, so m and l are per-thread and acc is 4 x D/16 floats.
// - The loop runs over the live K/V tiles only (bounds from causal,
//   window and rel, as `_kblock_bounds` sets them): dead tiles are never
//   loaded. Query tiles are issued last-first, so the long causal rows
//   start early.
// - Tiles are staged in shared memory as f32 (bf16 converted on load)
//   and multiplied with f32 FMA: the f32 build is full f32 (no TF32),
//   the bf16 build accumulates in f32 and rounds O once.
// - Inputs are read through their strides (the model's q, k, v are
//   slices of one fused projection), so the wrapper copies nothing.
// - Rows past T and columns past Tk are masked, so T need not be a
//   multiple of the tile.

#include "flash_common.cuh"

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Strides are in
// elements, (batch, seq, head) for each of q, k, v, o; head_dim is
// contiguous. lse is (batch, heads, tq) f32, contiguous. Returns the
// launch's cudaGetLastError() (0 = success); the Python wrapper checks
// shapes, types and alignment before the call.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              long long qb, long long qt, long long qh, long long kb,
              long long kt, long long kh, long long vb, long long vt,
              long long vh, long long ob, long long ot, long long oh,
              int batch, int heads, int kv_heads, int tq, int tk,
              int head_dim, int causal, int window, int rel, int dtype,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lq{qb, qt, qh}, lk{kb, kt, kh}, lv{vb, vt, vh}, lo{ob, ot, oh};
#define FLASH_FWD(T, D)                                                     \
  return launch<T, D>(q, k, v, o, lse, lq, lk, lv, lo, batch, heads,       \
                      kv_heads, tq, tk, causal, window, rel, s)
  if (dtype == 0 && head_dim == 64) FLASH_FWD(float, 64);
  if (dtype == 0 && head_dim == 128) FLASH_FWD(float, 128);
  if (dtype == 1 && head_dim == 64) FLASH_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FLASH_FWD(__nv_bfloat16, 128);
#undef FLASH_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
