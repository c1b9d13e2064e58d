// Flash-attention backward: dQ (K2) and dK, dV (K3), each recomputing
// the probabilities from the forward's row log-sum-exp.
//
// Replaces the TPU kernels launched by `_chunk_dq` and `_chunk_dkv` in
// shallowspeed_tpu/ops/flash_attention.py: `_dq_kernel_resident` :250 /
// `_dq_kernel` :352 (pallas_call :562, :580) and `_dkv_kernel_resident`
// :287 / `_dkv_kernel` :390 (pallas_call :617, :638). Same functions:
//   P  = exp(scale * Q K^T - lse) on visible (row, column) pairs, else 0
//   dS = P * (dO V^T - delta) * scale,      delta = rowsum(dO * O)
//   dQ = dS K,   dK = sum over the G query heads of a kv head of dS^T Q,
//   dV = sum over the same heads of P^T dO,
// with the causal / window / rel visibility of the forward (flash_fwd.cu)
// and every sum in f32. dQ, dK and dV are written as f32.
//
// Bound on the H100: operations. At the training shape (B 4, H 16,
// T 2048, hd 128, causal) dQ does 6 * hd flops per live pair (~103
// GFLOP) and dK/dV 8 * hd (~137 GFLOP), against well under 100 MB of
// operands: far past the card's ridge.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
// - K2: one thread block per (64-row query tile, query head, batch row),
//   looping over that tile's live K/V tiles (the forward's bounds) with
//   dQ in registers. Query tiles are issued last-first.
// - K3: one thread block per (64-row key tile, kv head, batch row),
//   looping over the G query heads of the kv head and, for each, over
//   the query tiles that can see the key tile (bounds from causal,
//   window and rel, as `_dkv_kernel_resident` sets them). dK and dV stay
//   in registers for the whole loop, so the GQA sum over the group needs
//   no atomics and no second pass, and the result is deterministic. (The
//   TPU streaming form carries the same sum on its innermost grid axis.)
// - K3 computes the transposed score tile (key rows x query columns)
//   directly, so P^T and dS^T land in shared memory already in the
//   layout the dV and dK products read.
// - Tiles are staged in shared memory as f32 and multiplied with f32 FMA
//   (the f32 build is full f32, no TF32); inputs are read through their
//   strides; rows past T and columns past Tk are masked.

#include "flash_common.cuh"

#include <cmath>

namespace {

using flash::Dims;
using flash::kScoreStride;
using flash::kThreads;
using flash::kTile;
using flash::Layout;

// lse and delta of rows [t0, t0 + 64) of head h into shared memory;
// rows past tq read 0 (their probabilities are masked to 0 anyway).
__device__ __forceinline__ void load_stats(const float* lse,
                                           const float* delta, int b, int h,
                                           int heads, int tq, int t0,
                                           float* lse_s, float* dl_s) {
  if (threadIdx.x < kTile) {
    const int r = t0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * heads + h) * tq + r;
    lse_s[threadIdx.x] = r < tq ? lse[at] : 0.f;
    dl_s[threadIdx.x] = r < tq ? delta[at] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* base, Layout l, int b,
                                           int h, int t0, int t_end, int ty,
                                           int tx,
                                           const float acc[4][4 * Dims<D>::kCols]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty + 16 * i;
    if (row >= t_end) continue;
    float* dst = base + b * l.b + row * l.t + h * l.h;
#pragma unroll
    for (int jj = 0; jj < Dims<D>::kCols; ++jj)
      flash::store4(dst + 4 * tx + 64 * jj,
                    make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                                acc[i][4 * jj + 2], acc[i][4 * jj + 3]));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                    int heads, int kv_heads, int tq, int tk, int causal,
                    int window, int rel, float scale) {
  constexpr int kCols = Dims<D>::kCols;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + Dims<D>::kTileFloats;
  float* k_s = do_s + Dims<D>::kTileFloats;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* ds_s = v_s + Dims<D>::kTileFloats;   // (64, kScoreStride)
  float* lse_s = ds_s + kTile * kScoreStride;
  float* dl_s = lse_s + kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  flash::load_tile<T, D>(q, lq, b, h, q0, tq, q_s);
  flash::load_tile<T, D>(dout, ldo, b, h, q0, tq, do_s);
  load_stats(lse, delta, b, h, heads, tq, q0, lse_s, dl_s);

  const int nkb = (tk + kTile - 1) / kTile;
  const int q_first = rel + q0;
  const int q_last = rel + min(q0 + kTile, tq) - 1;
  int kt_lo = 0, kt_hi = nkb;
  if (causal) kt_hi = q_last < 0 ? 0 : min(nkb, q_last / kTile + 1);
  if (window > 0) kt_lo = min(nkb, max(0, q_first - window + 1) / kTile);

  float acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with k, v, ds
    flash::load_tile<T, D>(k, lk, b, hk, k0, tk, k_s);
    flash::load_tile<T, D>(v, lv, b, hk, k0, tk, v_s);
    __syncthreads();

    float s[4][4], dp[4][4];
    flash::dot_tile<D>(q_s, k_s, ty, tx, s);
    flash::dot_tile<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int grow = rel + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < tk && flash::visible(grow, col, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * kScoreStride + tx + 16 * j] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    flash::accumulate_pv<D>(ds_s, k_s, ty, tx, acc);
  }
  store_rows<D>(dq, ldq, b, h, q0, tq, ty, tx, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                     Layout ldo, Layout ldk, int heads, int kv_heads, int tq,
                     int tk, int causal, int window, int rel, float scale) {
  constexpr int kCols = Dims<D>::kCols;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* q_s = v_s + Dims<D>::kTileFloats;
  float* do_s = q_s + Dims<D>::kTileFloats;
  float* pt_s = do_s + Dims<D>::kTileFloats;   // (64 keys, kScoreStride)
  float* dst_s = pt_s + kTile * kScoreStride;  // (64 keys, kScoreStride)
  float* lse_s = dst_s + kTile * kScoreStride;
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = heads / kv_heads;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  flash::load_tile<T, D>(k, lk, b, hk, k0, tk, k_s);
  flash::load_tile<T, D>(v, lv, b, hk, k0, tk, v_s);

  // query tiles that can see a column of [k0, k_last]: causal needs
  // rel + row >= k0, the window needs rel + row < k_last + window
  const int nqb = (tq + kTile - 1) / kTile;
  const int k_last = min(k0 + kTile, tk) - 1;
  int qt_lo = 0, qt_hi = nqb;
  if (causal) qt_lo = min(nqb, max(0, flash::floor_div(k0 - rel, kTile)));
  if (window > 0)
    qt_hi = min(nqb,
                max(0, flash::floor_div(k_last + window - 1 - rel, kTile) + 1));

  float dk_acc[4][4 * kCols], dv_acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done with q, do, p
      flash::load_tile<T, D>(q, lq, b, h, q0, tq, q_s);
      flash::load_tile<T, D>(dout, ldo, b, h, q0, tq, do_s);
      load_stats(lse, delta, b, h, heads, tq, q0, lse_s, dl_s);
      __syncthreads();

      // transposed tiles: rows are keys (ty + 16 i), columns queries
      float st[4][4], dpt[4][4];
      flash::dot_tile<D>(k_s, q_s, ty, tx, st);
      flash::dot_tile<D>(v_s, do_s, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int col = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int row = q0 + c;
          const bool ok = col < tk && row < tq &&
                          flash::visible(rel + row, col, causal, window);
          const float p = ok ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
          pt_s[r * kScoreStride + c] = p;
          dst_s[r * kScoreStride + c] = p * (dpt[i][j] - dl_s[c]) * scale;
        }
      }
      __syncthreads();
      flash::accumulate_pv<D>(pt_s, do_s, ty, tx, dv_acc);
      flash::accumulate_pv<D>(dst_s, q_s, ty, tx, dk_acc);
    }
  }
  store_rows<D>(dk, ldk, b, hk, k0, tk, ty, tx, dk_acc);
  store_rows<D>(dv, ldk, b, hk, k0, tk, ty, tx, dv_acc);
}

template <int D>
size_t dq_smem() {
  return sizeof(float) * (4 * Dims<D>::kTileFloats + kTile * kScoreStride +
                          2 * kTile);
}

template <int D>
size_t dkv_smem() {
  return sizeof(float) * (4 * Dims<D>::kTileFloats +
                          2 * kTile * kScoreStride + 2 * kTile);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, Layout lq,
              Layout lk, Layout lv, Layout ldo, Layout ldq, int batch,
              int heads, int kv_heads, int tq, int tk, int causal, int window,
              int rel, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<T, D>;
  const int e = flash::set_smem(kernel, dq_smem<D>());
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((tq + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), lq, lk, lv, ldo, ldq, heads, kv_heads, tq, tk,
      causal, window, rel, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldk,
               int batch, int heads, int kv_heads, int tq, int tk, int causal,
               int window, int rel, cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<T, D>;
  const int e = flash::set_smem(kernel, dkv_smem<D>());
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((tk + kTile - 1) / kTile, kv_heads, batch);
  kernel<<<grid, kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), lq, lk, lv, ldo, ldk,
      heads, kv_heads, tq, tk, causal, window, rel, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Strides are in
// elements, (batch, seq, head) per tensor, head_dim contiguous; lse and
// delta are (batch, heads, tq) f32, contiguous. dq is f32 with q's
// shape; dk and dv are f32 with k's shape and share one layout. Each
// returns the launch's cudaGetLastError() (0 = success); the Python
// wrapper checks shapes, types and alignment before the call.
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, long long qb,
             long long qt, long long qh, long long kb, long long kt,
             long long kh, long long vb, long long vt, long long vh,
             long long dob, long long dot, long long doh, long long dqb,
             long long dqt, long long dqh, int batch, int heads, int kv_heads,
             int tq, int tk, int head_dim, int causal, int window, int rel,
             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lq{qb, qt, qh}, lk{kb, kt, kh}, lv{vb, vt, vh},
      ldo{dob, dot, doh}, ldq{dqb, dqt, dqh};
#define FLASH_DQ(T, D)                                                     \
  return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, lq, lk, lv, ldo,  \
                         ldq, batch, heads, kv_heads, tq, tk, causal,      \
                         window, rel, s)
  if (dtype == 0 && head_dim == 64) FLASH_DQ(float, 64);
  if (dtype == 0 && head_dim == 128) FLASH_DQ(float, 128);
  if (dtype == 1 && head_dim == 64) FLASH_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FLASH_DQ(__nv_bfloat16, 128);
#undef FLASH_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              long long qb, long long qt, long long qh, long long kb,
              long long kt, long long kh, long long vb, long long vt,
              long long vh, long long dob, long long dot, long long doh,
              long long dkb, long long dkt, long long dkh, int batch,
              int heads, int kv_heads, int tq, int tk, int head_dim,
              int causal, int window, int rel, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lq{qb, qt, qh}, lk{kb, kt, kh}, lv{vb, vt, vh},
      ldo{dob, dot, doh}, ldk{dkb, dkt, dkh};
#define FLASH_DKV(T, D)                                                     \
  return launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, lq, lk, lv,   \
                          ldo, ldk, batch, heads, kv_heads, tq, tk, causal, \
                          window, rel, s)
  if (dtype == 0 && head_dim == 64) FLASH_DKV(float, 64);
  if (dtype == 0 && head_dim == 128) FLASH_DKV(float, 128);
  if (dtype == 1 && head_dim == 64) FLASH_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FLASH_DKV(__nv_bfloat16, 128);
#undef FLASH_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
