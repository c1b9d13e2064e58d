// Pieces shared by the f32-FMA flash-attention kernels: the f32 builds
// of K1 (flash_fwd.cu), K2 and K3 (flash_bwd.cu). The bf16 builds run on
// the tensor cores, from flash_tc.cuh, which takes Layout, visible and
// floor_div from here.
//
// Every kernel here works on 64-row tiles held in shared memory as f32,
// row major with a padded row stride, computed on by 256 threads
// arranged 16 x 16 (ty, tx):
// - a score tile (64 x 64) gives thread (ty, tx) rows ty + 16 i and
//   columns tx + 16 j, i, j < 4;
// - an output tile (64 x D) gives it rows ty + 16 i and the float4
//   column groups 4 tx + 64 jj, jj < D / 64.
// With a row stride of D + 4 floats, the eight threads of a quarter warp
// read eight different rows at the same column as eight different
// 16-byte bank groups, so the dot-product loads below are free of bank
// conflicts; the row a quarter warp shares is a broadcast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kTile = 64;                  // rows of a q or k tile
constexpr int kThreads = 256;              // 16 x 16
constexpr int kScoreStride = kTile + 16;   // floats per score-tile row

template <int D>
struct Dims {
  static constexpr int kRow = D + 4;            // floats per tile row
  static constexpr int kTileFloats = kTile * kRow;
  static constexpr int kCols = D / 64;          // float4 groups a thread owns
};

// Element strides of a (B, T, H, D) tensor; D's stride is 1.
struct Layout {
  long long b, t, h;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// 16 bytes of global memory -> 4 floats in shared memory
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// four floats -> global memory
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// Rows [t0, t0 + 64) of head h of batch row b, as f32 into `dst`
// (stride Dims<D>::kRow); rows at or past `t_end` are zero. Consecutive
// threads read consecutive 16-byte pieces of a row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, Layout l, int b,
                                          int h, int t0, int t_end,
                                          float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  const T* src = base + b * l.b + h * l.h;
  for (int e = threadIdx.x; e < kTile * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kVec;
    float* d = dst + r * Dims<D>::kRow + c;
    if (t0 + r < t_end) {
      load16(src + static_cast<long long>(t0 + r) * l.t + c, d);
    } else {
#pragma unroll
      for (int u = 0; u < kVec; u += 4)
        *reinterpret_cast<float4*>(d + u) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], in d order.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int ty, int tx, float acc[4][4]) {
  constexpr int kRow = Dims<D>::kRow;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kRow + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kRow + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// out[i][4 jj + e] += sum_t P[ty + 16 i][t] * V[t][4 tx + 64 jj + e] over
// the 64 columns of the score tile P (stride kScoreStride) and the 64
// rows of V (stride Dims<D>::kRow), in t order.
template <int D>
__device__ __forceinline__ void accumulate_pv(const float* P, const float* V,
                                              int ty, int tx,
                                              float out[4][4 * Dims<D>::kCols]) {
  constexpr int kRow = Dims<D>::kRow;
  constexpr int kCols = Dims<D>::kCols;
#pragma unroll 2
  for (int t = 0; t < kTile; t += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kScoreStride + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float4 v = *reinterpret_cast<const float4*>(
            V + (t + u) * kRow + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
          out[i][4 * jj + 0] = fmaf(pv, v.x, out[i][4 * jj + 0]);
          out[i][4 * jj + 1] = fmaf(pv, v.y, out[i][4 * jj + 1]);
          out[i][4 * jj + 2] = fmaf(pv, v.z, out[i][4 * jj + 2]);
          out[i][4 * jj + 3] = fmaf(pv, v.w, out[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Whether query row `grow` (global position) may see key column `col`.
__device__ __forceinline__ bool visible(int grow, int col, int causal,
                                        int window) {
  return (!causal || grow >= col) && (window <= 0 || col > grow - window);
}

// Sum / max over the 16 threads of a half warp (the threads sharing ty).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace flash
