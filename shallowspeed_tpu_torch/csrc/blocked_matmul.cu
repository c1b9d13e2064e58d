// Blocked matmul (K5): out = x @ y, x (M, K), y (K, N), both row major,
// summed in f32 and rounded once to the output dtype.
//
// Replaces the TPU kernel `_mm_kernel`, launched by `blocked_matmul` in
// shallowspeed_tpu/ops/matmul.py (kernel :27, pallas_call :108). Same
// function: an f32 accumulator over the whole of K, written once in the
// output dtype (f32 or bf16) for f32 or bf16 inputs.
//
// Bound on the H100: 2 M N K operations at 989 TFLOP/s for bf16 inputs
// (tensor cores), or at 67 TFLOP/s for f32 inputs (TF32 is off, so an
// f32 product runs on the CUDA cores); bytes: x and y read once, out
// written once, at 3.35 TB/s. At the probe's narrow-K shape, (16384,
// 1024) @ (1024, 4096) in bf16, the operations take 0.139 ms and the
// bytes 0.053 ms: bound by operations.
//
// Design (simple and right first). This kernel multiplies with f32 FMA
// on the CUDA cores, so bf16 inputs run at most at the f32 rate, ~15x
// under their tensor-core bound; mma.sync, then wgmma with TMA and warp
// specialisation, are later work.
// - The TPU grid runs K as its sequential third axis and carries the sum
//   in VMEM scratch from one grid step to the next. Blocks here run in no
//   order, so the TPU grid is not carried over: one block owns one
//   128 x 128 output tile and loops over all of K itself, its f32
//   accumulator in registers (256 threads, 8 x 8 outputs each). The
//   wrapper's (bm, bk, bn) are the interface's blocks, checked as the
//   reference checks them; they do not tile this kernel.
// - Each step of the K loop stages a 128 x 16 slice of x (transposed, so
//   a thread's rows are contiguous) and a 16 x 128 slice of y in shared
//   memory as f32, read from global memory in 16-byte vectors (8 bf16 or
//   4 f32). The next slice is loaded into registers while the current one
//   is multiplied, into the other of two shared buffers: one barrier per
//   step.
// - Thread (ty, tx) owns rows {4 ty + i, 64 + 4 ty + i} and columns
//   {4 tx + j, 64 + 4 tx + j}, i, j < 4, so the threads of a quarter warp
//   read neighbouring float4s of a shared row: no bank conflicts.
// - Ragged edges are masked: rows past M, columns past N and k past K
//   load zeros and are never stored, and a vector that would cross an edge
//   or sit off a 16-byte boundary is read element by element. So the
//   kernel takes any M, N, K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;   // output rows of a block
constexpr int kBN = 128;   // output columns of a block
constexpr int kBK = 16;    // k of one staged slice
constexpr int kThreads = 256;
constexpr int kPad = 4;    // keeps shared rows 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The 16 / sizeof(T) elements row[col ...] as floats, zero past `limit`;
// one 16-byte load when the whole vector is in range and `aligned`.
template <typename T>
__device__ __forceinline__ void load_vec(const T* row, long long col,
                                         long long limit, bool aligned,
                                         float* dst) {
  constexpr int n = 16 / sizeof(T);
  if (aligned && col + n <= limit) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + col);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i)
      dst[i] = col + i < limit ? to_f32(row[col + i]) : 0.f;
  }
}

// Four outputs row[col ...], those past `limit` dropped; one vector store
// when all four are in range and `aligned`.
__device__ __forceinline__ void store4(float* row, long long col,
                                       long long limit, bool aligned,
                                       const float* v) {
  if (aligned && col + 4 <= limit) {
    *reinterpret_cast<float4*>(row + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4; ++j)
      if (col + j < limit) put(row + col + j, v[j]);
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, long long col,
                                       long long limit, bool aligned,
                                       const float* v) {
  if (aligned && col + 4 <= limit) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const unsigned int*>(&lo);
    w.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(row + col) = w;
  } else {
    for (int j = 0; j < 4; ++j)
      if (col + j < limit) put(row + col + j, v[j]);
  }
}

template <typename T>
struct Slices {
  static constexpr int kVec = 16 / sizeof(T);
  // 16-byte vectors a thread loads per slice, of x and of y
  static constexpr int kA = kBM * kBK / kVec / kThreads;
  static constexpr int kB = kBK * kBN / kVec / kThreads;
};

// The x slice rows [m0, m0 + 128) x k [k0, k0 + 16) and the y slice
// k [k0, k0 + 16) x columns [n0, n0 + 128), as this thread's share of
// floats.
template <typename T>
__device__ __forceinline__ void load_slices(const T* x, const T* y, int m,
                                            int n, int k, int m0, int n0,
                                            int k0, bool a_vec, bool b_vec,
                                            float* ra, float* rb) {
  constexpr int kVec = Slices<T>::kVec;
#pragma unroll
  for (int r = 0; r < Slices<T>::kA; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int row = v / (kBK / kVec);
    const int kc = (v % (kBK / kVec)) * kVec;
    const int gm = m0 + row;
    const T* src = x + static_cast<long long>(gm) * k;
    load_vec(src, k0 + kc, gm < m ? k : 0, a_vec, ra + r * kVec);
  }
#pragma unroll
  for (int r = 0; r < Slices<T>::kB; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int kr = v / (kBN / kVec);
    const int col = (v % (kBN / kVec)) * kVec;
    const int gk = k0 + kr;
    const T* src = y + static_cast<long long>(gk) * n;
    load_vec(src, n0 + col, gk < k ? n : 0, b_vec, rb + r * kVec);
  }
}

template <typename T>
__device__ __forceinline__ void stage(const float* ra, const float* rb,
                                      float (*as)[kBM + kPad],
                                      float (*bs)[kBN + kPad]) {
  constexpr int kVec = Slices<T>::kVec;
#pragma unroll
  for (int r = 0; r < Slices<T>::kA; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int row = v / (kBK / kVec);
    const int kc = (v % (kBK / kVec)) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) as[kc + i][row] = ra[r * kVec + i];
  }
#pragma unroll
  for (int r = 0; r < Slices<T>::kB; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int kr = v / (kBN / kVec);
    const int col = (v % (kBN / kVec)) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(&bs[kr][col + i]) =
          make_float4(rb[r * kVec + i], rb[r * kVec + i + 1],
                      rb[r * kVec + i + 2], rb[r * kVec + i + 3]);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    blocked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          O* __restrict__ out, int m, int n, int k,
                          bool a_vec, bool b_vec, bool o_vec) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPad];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPad];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[Slices<T>::kA * Slices<T>::kVec];
  float rb[Slices<T>::kB * Slices<T>::kVec];
  const int nk = (k + kBK - 1) / kBK;
  load_slices(x, y, m, n, k, m0, n0, 0, a_vec, b_vec, ra, rb);
  stage<T>(ra, rb, as[0], bs[0]);
  __syncthreads();

  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk)
      load_slices(x, y, m, n, k, m0, n0, (t + 1) * kBK, a_vec, b_vec, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&as[cur][kk][4 * ty]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&as[cur][kk][64 + 4 * ty]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&bs[cur][kk][4 * tx]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer's readers finished at the previous step's barrier
    if (t + 1 < nk) stage<T>(ra, rb, as[cur ^ 1], bs[cur ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
    O* dst = out + static_cast<long long>(row) * n;
    store4(dst, n0 + 4 * tx, n, o_vec, acc[i]);
    store4(dst, n0 + 64 + 4 * tx, n, o_vec, acc[i] + 4);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, typename O>
int launch(const void* x, const void* y, void* out, int m, int n, int k,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // a row's vectors stay on 16-byte boundaries when the row length is a
  // multiple of the vector and the base is aligned
  const bool a_vec = k % kVec == 0 && aligned16(x);
  const bool b_vec = n % kVec == 0 && aligned16(y);
  const auto out_addr = reinterpret_cast<std::uintptr_t>(out);
  const bool o_vec = n % 4 == 0 && out_addr % (4 * sizeof(O)) == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  blocked_matmul_kernel<T, O><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<O*>(out),
      m, n, k, a_vec, b_vec, o_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (m, k) and y (k, n) row major, contiguous, of one dtype; out (m, n)
// row major. in_dtype, out_dtype: 0 = float32, 1 = bfloat16. m, n, k > 0
// and m at most 65535 * 128 (the grid's y extent).
// Returns the launch's cudaGetLastError() (0 = success); the Python
// wrapper checks shapes, types and devices before the call.
int blocked_matmul(const void* x, const void* y, void* out, int m, int n,
                   int k, int in_dtype, int out_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define BLOCKED_MATMUL(I, O, T, U)         \
  if (in_dtype == I && out_dtype == O) \
  return launch<T, U>(x, y, out, m, n, k, s)
  BLOCKED_MATMUL(0, 0, float, float);
  BLOCKED_MATMUL(0, 1, float, __nv_bfloat16);
  BLOCKED_MATMUL(1, 0, __nv_bfloat16, float);
  BLOCKED_MATMUL(1, 1, __nv_bfloat16, __nv_bfloat16);
#undef BLOCKED_MATMUL
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* blocked_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
