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
// operands: far past the card's ridge, so only the tensor cores can
// bring them near it.
//
// Each kernel has two builds, chosen by dtype in the C entry:
// - bf16, the main path's (training): every product on the tensor cores
//   (`flash_tc.cuh`). One warpgroup per 64-row tile; the tile it owns
//   stays in 128B-swizzled shared memory, TMA streams the other side's
//   tiles through two stages, the next tile's load in flight under this
//   one's math; the two score products are wgmma from shared memory,
//   P and dS are computed on the accumulator fragments in f32 registers
//   and feed the second products as bf16 register A operands with the
//   streamed (or resident) tile read transposed: neither touches shared
//   memory. Two blocks an SM.
//   - K2, `flash_dq_tc_kernel`: one block per (64-row query tile, query
//     head, batch row), query tiles issued last-first; Q and dO
//     resident, K and V streamed over the tile's live key tiles (the
//     forward's bounds); lse and delta of the thread's two rows in
//     registers; S = Q K^T, dP = dO V^T, then dQ += dS K with K read
//     MN-major. dQ (64 f32 a thread at hd 128) stays in registers.
//   - K3, `flash_dkv_tc_kernel`: one block per (64-row key tile, kv
//     head, batch row), looping over the G query heads of the kv head
//     and, for each, over the query tiles that can see the key tile
//     (bounds from causal, window and rel, as `_dkv_kernel_resident`
//     sets them); K and V resident, Q and dO streamed (lse and delta
//     ride beside them by cp.async); S^T = K Q^T, dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q with dO and Q read transposed. dK
//     and dV stay in registers for the whole loop (128 of the 224
//     registers a thread at hd 128, no spills), so the GQA sum over the
//     group needs no atomics and no second pass, and the result is
//     deterministic. (The TPU streaming form carries the same sum on its
//     innermost grid axis.)
// - f32: full f32 FMA on the CUDA cores (no TF32, which would break the
//   f32 parity bounds), the same blocks and loops with tiles, P and dS
//   staged in shared memory as f32: `flash_dq_kernel`, `flash_dkv_kernel`.
// Inputs are read through their strides; rows past T and columns past
// Tk are masked.

#include "flash_common.cuh"
#include "flash_tc.cuh"

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

// ---------------------------------------- K3's bf16 build: wgmma

namespace tc = flash_tc;

// One warpgroup per (64-row key tile, kv head, batch row); key tiles in
// order, so the longest causal loops start first. Its K and V tiles stay
// in shared memory; it loops over the G query heads and, for each, over
// the query tiles that can see the key tile. Thread 0 streams the Q and
// dO tiles of the next (head, query tile) by TMA into the other of two
// stages while this one's math runs; lse and delta ride beside them by
// cp.async. Per query tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both
// from shared memory), P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - delta) scale in f32 registers (the mask tested only
// on tiles that cross the diagonal, the window's edge, Tq or Tk), then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as the
// register A operands and dO, Q read transposed. dK and dV stay in
// registers for the whole loop: the sum over the group is the block's
// own, deterministic, with no atomics.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, 2)
    flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        Layout ldk, int heads, int kv_heads, int tq, int tk,
                        int causal, int window, int rel, float scale,
                        float scale_log2) {
  constexpr int kTile = tc::Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  // K, V, then stage s: Q, dO; then stage s: lse, delta; then barriers
  float* stats = reinterpret_cast<float*>(base + 6 * kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 4 * tc::kRows);

  const int k0 = blockIdx.x * tc::kRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = heads / kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = 16 * (tid / 32) + lane / 4;   // key rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);

  // query tiles that can see a column of [k0, k_last]
  const int nqb = (tq + tc::kRows - 1) / tc::kRows;
  const int k_last = min(k0 + tc::kRows, tk) - 1;
  int qt_lo = 0, qt_hi = nqb;
  if (causal) qt_lo = min(nqb, max(0, flash::floor_div(k0 - rel, tc::kRows)));
  if (window > 0)
    qt_hi = min(nqb, max(0, flash::floor_div(k_last + window - 1 - rel,
                                             tc::kRows) + 1));
  const int nq = max(0, qt_hi - qt_lo);
  const int n = groups * nq;

  // the (query head, first row) of step i, and its loads into stage s
  auto step = [&](int i, int& h, int& q0) {
    h = hk * groups + i / nq;
    q0 = (qt_lo + i % nq) * tc::kRows;
  };
  auto issue = [&](int i, int s) {
    int h, q0;
    step(i, h, q0);
    if (tid == 0) {
      uint8_t* st = base + (2 + 2 * s) * kTile;
      tc::bar_expect(&bars[1 + s], 2 * kTile);
      tc::load_tile<D>(st, &mq, &bars[1 + s], q0, h, b);
      tc::load_tile<D>(st + kTile, &mdo, &bars[1 + s], q0, h, b);
    }
    const int r = tid % tc::kRows;
    const float* src = tid < tc::kRows ? lse : delta;
    const long long at =
        (static_cast<long long>(b) * heads + h) * tq + q0 + r;
    tc::cp_async4(stats + (2 * s + tid / tc::kRows) * tc::kRows + r,
                  q0 + r < tq ? src + at : src, q0 + r < tq);
    tc::cp_async_commit();
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tc::bar_init(&bars[i]);
    tc::fence_bar_init();
  }
  __syncthreads();
  if (n > 0) {
    if (tid == 0) {
      tc::bar_expect(&bars[0], 2 * kTile);
      tc::load_tile<D>(base, &mk, &bars[0], k0, hk, b);
      tc::load_tile<D>(base + kTile, &mv, &bars[0], k0, hk, b);
    }
    issue(0, 0);
  }

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const uint32_t k_addr = tc::smem_u32(base);
  const uint32_t v_addr = k_addr + kTile;
  if (n > 0) tc::bar_wait(&bars[0], 0);

  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    int h, q0;
    step(i, h, q0);
    tc::cp_async_wait_all();   // this thread's lse / delta of step i
    __syncthreads();           // everyone's; and stage s ^ 1 is free
    if (i + 1 < n) issue(i + 1, s ^ 1);
    tc::bar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint32_t q_addr = tc::smem_u32(base + (2 + 2 * s) * kTile);
    const uint32_t do_addr = q_addr + kTile;
    const float* lse_s = stats + 2 * s * tc::kRows;
    const float* dl_s = lse_s + tc::kRows;

    float st[32], dpt[32];   // rows: keys; columns: queries
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(st, tc::desc_k(k_addr, ks), tc::desc_k(q_addr, ks),
                       ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(dpt, tc::desc_k(v_addr, ks), tc::desc_k(do_addr, ks),
                       ks > 0);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(st);
    tc::fence_regs(dpt);

    const bool edge = k0 + tc::kRows > tk || q0 + tc::kRows > tq ||
                      (causal && rel + q0 < k0 + tc::kRows - 1) ||
                      (window > 0 && k0 <= rel + q0 + tc::kRows - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + col0 + e;
        const float lse2 = lse_s[c] * tc::kLog2e;
        const float dl = dl_s[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          float p = exp2f(fmaf(st[x], scale_log2, -lse2));
          if (edge) {
            const int key = k0 + row0 + 8 * r;
            const int row = q0 + c;
            if (!(key < tk && row < tq &&
                  tc::visible(rel + row, key, causal, window)))
              p = 0.f;
          }
          st[x] = p;
          dpt[x] = p * (dpt[x] - dl) * scale;
        }
      }

    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::p_frag(st, kk, pf[kk]);
      tc::p_frag(dpt, kk, dsf[kk]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<D>(dv_acc, pf[kk], tc::desc_mn(do_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<D>(dk_acc, dsf[kk], tc::desc_mn(q_addr, kk));
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(dv_acc);
    tc::fence_regs(dk_acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    if (key >= tk) continue;
    const long long at = b * ldk.b + key * ldk.t + hk * ldk.h + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
constexpr int dkv_tc_smem() {
  return 6 * tc::Tile<D>::kBytes + 4 * tc::kRows * 4 + 3 * 8 + 1024;
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, Layout lq, Layout lk, Layout lv,
                  Layout ldo, Layout ldk, int batch, int heads, int kv_heads,
                  int tq, int tk, int causal, int window, int rel,
                  cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int e = tc::tile_map(&mq, q, lq, batch, tq, heads, D);
  if (e == 0) e = tc::tile_map(&mk, k, lk, batch, tk, kv_heads, D);
  if (e == 0) e = tc::tile_map(&mv, v, lv, batch, tk, kv_heads, D);
  if (e == 0) e = tc::tile_map(&mdo, dout, ldo, batch, tq, heads, D);
  if (e != 0) return e;
  auto kernel = flash_dkv_tc_kernel<D>;
  e = tc::set_smem(reinterpret_cast<const void*>(kernel), dkv_tc_smem<D>());
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((tk + tc::kRows - 1) / tc::kRows, kv_heads, batch);
  kernel<<<grid, tc::kThreads, dkv_tc_smem<D>(), stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), ldk, heads, kv_heads, tq, tk, causal, window,
      rel, scale, scale * tc::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------- K2's bf16 build: wgmma

// One warpgroup per (64-row query tile, query head, batch row); query
// tiles issued last-first, so the longest causal loops start first. Its
// Q and dO tiles stay in shared memory; thread 0 streams the live K/V
// tiles through two stages by TMA, the next tile's load in flight while
// this one's math runs. Per key tile: S = Q K^T and dP = dO V^T (wgmma,
// both from shared memory), P = exp(S scale - lse) and
// dS = P (dP - delta) scale in f32 registers (the mask tested only on
// tiles that cross the diagonal, the window's edge, Tq or Tk), then
// dQ += dS K with dS rounded to bf16 as the register A operand and K
// read transposed. Each thread keeps lse and delta of its two rows in
// registers.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, 2)
    flash_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, Layout ldq, int heads,
                       int kv_heads, int tq, int tk, int causal, int window,
                       int rel, float scale, float scale_log2) {
  constexpr int kTile = tc::Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  // Q, dO, then stage s: K, V; then the barriers
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 6 * kTile);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = 16 * (tid / 32) + lane / 4;   // query rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);

  // live K/V tiles for rows [q0, q0 + 64) at global rel + row
  const int nkb = (tk + tc::kRows - 1) / tc::kRows;
  const int q_first = rel + q0;
  const int q_last = rel + min(q0 + tc::kRows, tq) - 1;
  int kt_lo = 0, kt_hi = nkb;
  if (causal) kt_hi = q_last < 0 ? 0 : min(nkb, q_last / tc::kRows + 1);
  if (window > 0) kt_lo = min(nkb, max(0, q_first - window + 1) / tc::kRows);
  const int n = max(0, kt_hi - kt_lo);

  // this thread's rows' lse (log2 units) and delta; rows past tq read 0
  // (their tiles are edge tiles, where every pair past tq is masked)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const long long at = (static_cast<long long>(b) * heads + h) * tq + row;
    lse2[r] = row < tq ? lse[at] * tc::kLog2e : 0.f;
    dl[r] = row < tq ? delta[at] : 0.f;
  }

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tc::bar_init(&bars[i]);
    tc::fence_bar_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    tc::bar_expect(&bars[0], 2 * kTile);
    tc::load_tile<D>(base, &mq, &bars[0], q0, h, b);
    tc::load_tile<D>(base + kTile, &mdo, &bars[0], q0, h, b);
    tc::bar_expect(&bars[1], 2 * kTile);
    tc::load_tile<D>(base + 2 * kTile, &mk, &bars[1], kt_lo * tc::kRows, hk,
                     b);
    tc::load_tile<D>(base + 3 * kTile, &mv, &bars[1], kt_lo * tc::kRows, hk,
                     b);
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t q_addr = tc::smem_u32(base);
  const uint32_t do_addr = q_addr + kTile;
  if (n > 0) tc::bar_wait(&bars[0], 0);

  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const int k0 = (kt_lo + i) * tc::kRows;
    if (i + 1 < n) {
      __syncthreads();   // every warp is done with stage s ^ 1
      if (tid == 0) {
        uint8_t* next = base + (2 + 2 * (s ^ 1)) * kTile;
        tc::bar_expect(&bars[1 + (s ^ 1)], 2 * kTile);
        tc::load_tile<D>(next, &mk, &bars[1 + (s ^ 1)], k0 + tc::kRows, hk,
                         b);
        tc::load_tile<D>(next + kTile, &mv, &bars[1 + (s ^ 1)],
                         k0 + tc::kRows, hk, b);
      }
    }
    tc::bar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint32_t k_addr = tc::smem_u32(base + (2 + 2 * s) * kTile);
    const uint32_t v_addr = k_addr + kTile;

    float sc[32], dp[32];   // rows: queries; columns: keys
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(sc, tc::desc_k(q_addr, ks), tc::desc_k(k_addr, ks),
                       ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(dp, tc::desc_k(do_addr, ks), tc::desc_k(v_addr, ks),
                       ks > 0);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(sc);
    tc::fence_regs(dp);

    const bool edge = k0 + tc::kRows > tk || q0 + tc::kRows > tq ||
                      (causal && rel + q0 < k0 + tc::kRows - 1) ||
                      (window > 0 && k0 <= rel + q0 + tc::kRows - 1 - window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float p = exp2f(fmaf(sc[e], scale_log2, -lse2[r]));
      if (edge) {
        const int row = q0 + row0 + 8 * r;
        const int key = k0 + 8 * (e >> 2) + col0 + (e & 1);
        if (!(key < tk && row < tq &&
              tc::visible(rel + row, key, causal, window)))
          p = 0.f;
      }
      dp[e] = p * (dp[e] - dl[r]) * scale;
    }

    uint32_t dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::p_frag(dp, kk, dsf[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<D>(dq_acc, dsf[kk], tc::desc_mn(k_addr, kk));
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(dq_acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= tq) continue;
    const long long at = b * ldq.b + row * ldq.t + h * ldq.h + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dq + at + 8 * j) =
          make_float2(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
constexpr int dq_tc_smem() {
  return 6 * tc::Tile<D>::kBytes + 3 * 8 + 1024;
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, Layout lq, Layout lk, Layout lv, Layout ldo,
                 Layout ldq, int batch, int heads, int kv_heads, int tq,
                 int tk, int causal, int window, int rel,
                 cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int e = tc::tile_map(&mq, q, lq, batch, tq, heads, D);
  if (e == 0) e = tc::tile_map(&mk, k, lk, batch, tk, kv_heads, D);
  if (e == 0) e = tc::tile_map(&mv, v, lv, batch, tk, kv_heads, D);
  if (e == 0) e = tc::tile_map(&mdo, dout, ldo, batch, tq, heads, D);
  if (e != 0) return e;
  auto kernel = flash_dq_tc_kernel<D>;
  e = tc::set_smem(reinterpret_cast<const void*>(kernel), dq_tc_smem<D>());
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((tq + tc::kRows - 1) / tc::kRows, heads, batch);
  kernel<<<grid, tc::kThreads, dq_tc_smem<D>(), stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), ldq, heads,
      kv_heads, tq, tk, causal, window, rel, scale, scale * tc::kLog2e);
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
#undef FLASH_DQ
#define FLASH_DQ_TC(D)                                                      \
  return launch_dq_tc<D>(q, k, v, dout, lse, delta, dq, lq, lk, lv, ldo,  \
                         ldq, batch, heads, kv_heads, tq, tk, causal,      \
                         window, rel, s)
  if (dtype == 1 && head_dim == 64) FLASH_DQ_TC(64);
  if (dtype == 1 && head_dim == 128) FLASH_DQ_TC(128);
#undef FLASH_DQ_TC
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
#undef FLASH_DKV
#define FLASH_DKV_TC(D)                                                     \
  return launch_dkv_tc<D>(q, k, v, dout, lse, delta, dk, dv, lq, lk, lv,   \
                          ldo, ldk, batch, heads, kv_heads, tq, tk, causal, \
                          window, rel, s)
  if (dtype == 1 && head_dim == 64) FLASH_DKV_TC(64);
  if (dtype == 1 && head_dim == 128) FLASH_DKV_TC(128);
#undef FLASH_DKV_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of K2's and K3's bf16 (tensor-core) kernels, in
// bytes.
int flash_dq_tc_smem(int head_dim) {
  return head_dim == 64 ? dq_tc_smem<64>() : dq_tc_smem<128>();
}

int flash_dkv_tc_smem(int head_dim) {
  return head_dim == 64 ? dkv_tc_smem<64>() : dkv_tc_smem<128>();
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
