// Paged flash decode: one query token per slot attends over its KV cache
// through a block table, in one pass with an online softmax.
//
// Replaces the TPU kernel `_paged_decode_kernel`, launched by
// `paged_flash_decode` in shallowspeed_tpu/ops/flash_attention.py
// (kernel :947-1016, pallas_call :1082). Computes the same function:
//   out[s, h] = softmax_j(scale * q[s, h] . K[j]) V[j]
// over the cache positions j in [0, pos[s]] (and > pos[s] - window when
// window > 0), where position j lives at pool block bt[s, j / bs],
// offset j % bs, kv head h / G (GQA groups of G query heads per kv head).
//
// Bound on the H100: HBM bytes. Per layer it must read the live K/V
// blocks once, sum over rows of live_blocks * 2 * Hkv * bs * hd *
// itemsize, and does ~4 flops per byte read — two orders of magnitude
// under the card's ~295 flops/byte ridge in bf16.
//
// Design (simple and right first; split-K, cp.async/TMA pipelining and
// warp specialisation are later work):
// - One thread block per (slot, kv head). It holds that head's G query
//   rows, so a K/V block is read once for all G heads that share it.
// - The TPU's sequential table-column grid axis becomes a loop inside
//   the block, and the loop visits only live columns: those wholly past
//   pos or wholly before the window are never loaded (the TPU grid still
//   DMAs them).
// - Each K/V block (bs x hd) is staged in shared memory with 16-byte
//   loads, converted to f32.
// - Scores, the running max m, the normaliser l and the accumulator stay
//   in f32; masked scores are -1e30 and their probabilities exactly 0;
//   l is guarded by max(l, 1e-30); the output is written in q's dtype.
//   Rows steered to scratch (pos 0, table all block 0) read block 0 and
//   come out finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// 16 bytes of global memory -> 16/sizeof(T) floats in shared memory
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ bool is_valid(int col, int p, int window) {
  return col <= p && (window <= 0 || col > p - window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, const int* __restrict__ bt,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int hkv, int groups, int bs, int width, int window,
                        float scale) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* q_s = smem;                  // (groups, HD)
  float* k_s = q_s + groups * HD;     // (bs, HD)
  float* v_s = k_s + bs * HD;         // (bs, HD)
  float* acc = v_s + bs * HD;         // (groups, HD)
  float* sc = acc + groups * HD;      // (groups, bs) scores, then probs
  float* m_s = sc + groups * bs;      // (groups,) running max
  float* l_s = m_s + groups;          // (groups,) running normaliser
  float* a_s = l_s + groups;          // (groups,) this column's rescale

  const int slot = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = pos[slot];
  const size_t row0 = (static_cast<size_t>(slot) * hkv + head) * groups * HD;

  for (int e = tid * kVec; e < groups * HD; e += kThreads * kVec)
    load16(q + row0 + e, q_s + e);
  for (int e = tid; e < groups * HD; e += kThreads) acc[e] = 0.f;
  if (tid < groups) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  int c_lo = 0;
  if (window > 0 && p - window + 1 > 0) c_lo = (p - window + 1) / bs;
  const int c_hi = min(width - 1, p / bs);
  const size_t tile = static_cast<size_t>(bs) * HD;
  __syncthreads();

  for (int c = c_lo; c <= c_hi; ++c) {
    const int blk = bt[static_cast<size_t>(slot) * width + c];
    const size_t off = (static_cast<size_t>(blk) * hkv + head) * tile;
    for (int e = tid * kVec; e < bs * HD; e += kThreads * kVec) {
      load16(kp + off + e, k_s + e);
      load16(vp + off + e, v_s + e);
    }
    __syncthreads();

    const int base = c * bs;
    // scores: one warp per (query row, position), lanes split hd
    for (int r = warp; r < groups * bs; r += kWarps) {
      const int g = r / bs;
      const int t = r - g * bs;
      float part = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) part += q_s[g * HD + d] * k_s[t * HD + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sc[r] = is_valid(base + t, p, window) ? part * scale : kNeg;
    }
    __syncthreads();

    // online softmax statistics: one thread per query row
    if (tid < groups) {
      float* row = sc + tid * bs;
      const float m_old = m_s[tid];
      float m_new = m_old;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, row[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float pr = is_valid(base + t, p, window) ? expf(row[t] - m_new) : 0.f;
        row[t] = pr;
        sum += pr;
      }
      const float alpha = expf(m_old - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    for (int e = tid; e < groups * HD; e += kThreads) {
      const int g = e / HD;
      const int d = e - g * HD;
      const float* prow = sc + g * bs;
      float s = 0.f;
      for (int t = 0; t < bs; ++t) s += prow[t] * v_s[t * HD + d];
      acc[e] = acc[e] * a_s[g] + s;
    }
    __syncthreads();  // the next column overwrites k_s, v_s and sc
  }

  for (int e = tid; e < groups * HD; e += kThreads) {
    const int g = e / HD;
    store(out + row0 + e, acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* pos, void* out, int slots, int heads, int kv_heads,
           int block_size, int width, int window, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(groups) * HD +
                       2 * static_cast<size_t>(block_size) * HD +
                       static_cast<size_t>(groups) * block_size + 3 * groups);
  auto kernel = paged_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  kernel<<<dim3(slots, kv_heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out), kv_heads, groups,
      block_size, width, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. Returns the
// launch's cudaGetLastError() (0 = success); shapes are checked by the
// Python wrapper before the call.
int paged_decode(const void* q, const void* k, const void* v, const void* bt,
                 const void* pos, void* out, int slots, int heads,
                 int kv_heads, int head_dim, int block_size, int width,
                 int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, bt, pos, out, slots, heads, kv_heads,
                             block_size, width, window, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, bt, pos, out, slots, heads, kv_heads,
                              block_size, width, window, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, bt, pos, out, slots, heads,
                                     kv_heads, block_size, width, window, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, bt, pos, out, slots, heads,
                                      kv_heads, block_size, width, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
