// Paged flash decode: one query token per slot attends over its KV cache
// through a block table, in one pass with an online softmax.
//
// Replaces the TPU kernel `_paged_decode_kernel`, launched by
// `paged_flash_decode` in shallowspeed_tpu/ops/flash_attention.py
// (kernel :947-1016, pallas_call :1082), both of its branches. Computes
// the same function:
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
//
// Bound on the H100: HBM bytes. Per layer it must read the live K/V
// blocks once, sum over rows of live_blocks * 2 * Hkv * bs * hd *
// itemsize (+ 2 * Hkv * bs * 4 scale bytes for int8 pools), and does
// ~4 flops per byte read (~8 with int8) — two orders of magnitude under
// the card's ~295 flops/byte ridge in bf16.
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
//   loads (8 bf16, 4 f32 or 16 int8 values), converted to f32; an int8
//   block's two scale rows are staged beside it.
// - Scores, the running max m, the normaliser l and the accumulator stay
//   in f32; masked scores are -1e30 and their probabilities exactly 0;
//   l is guarded by max(l, 1e-30); the output is written in q's dtype.
//   Rows steered to scratch (pos 0, table all block 0) read block 0 and
//   come out finite.

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

__device__ __forceinline__ void load16(const int8_t* src, float* dst) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ bool is_valid(int col, int p, int window) {
  return col <= p && (window <= 0 || col > p - window);
}

// The whole decode for one (slot, kv head) block. KV is the pools'
// element type: T for float pools, int8_t for int8 pools, which also
// read the scale planes ksp / vsp (unused, may be null, otherwise).
template <typename T, typename KV, int HD>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const float* __restrict__ ksp, const KV* __restrict__ vp,
    const float* __restrict__ vsp, const int* __restrict__ bt,
    const int* __restrict__ pos, T* __restrict__ out, int hkv, int groups,
    int bs, int width, int window, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kVecQ = 16 / sizeof(T);
  constexpr int kVecKV = 16 / sizeof(KV);
  extern __shared__ float smem[];
  float* q_s = smem;                  // (groups, HD)
  float* k_s = q_s + groups * HD;     // (bs, HD)
  float* v_s = k_s + bs * HD;         // (bs, HD)
  float* acc = v_s + bs * HD;         // (groups, HD)
  float* sc = acc + groups * HD;      // (groups, bs) scores, then probs
  float* m_s = sc + groups * bs;      // (groups,) running max
  float* l_s = m_s + groups;          // (groups,) running normaliser
  float* a_s = l_s + groups;          // (groups,) this column's rescale
  float* ksc = a_s + groups;          // (bs,) K scales (int8 pools)
  float* vsc = ksc + bs;              // (bs,) V scales (int8 pools)

  const int slot = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = pos[slot];
  const size_t row0 = (static_cast<size_t>(slot) * hkv + head) * groups * HD;

  for (int e = tid * kVecQ; e < groups * HD; e += kThreads * kVecQ)
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
    const size_t plane = static_cast<size_t>(blk) * hkv + head;
    const size_t off = plane * tile;
    for (int e = tid * kVecKV; e < bs * HD; e += kThreads * kVecKV) {
      load16(kp + off + e, k_s + e);
      load16(vp + off + e, v_s + e);
    }
    if constexpr (kQuant) {
      for (int t = tid; t < bs; t += kThreads) {
        ksc[t] = ksp[plane * bs + t];
        vsc[t] = vsp[plane * bs + t];
      }
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
      if (kQuant) part *= ksc[t];  // K's scale on the score row
      if (lane == 0) sc[r] = is_valid(base + t, p, window) ? part * scale : kNeg;
    }
    __syncthreads();

    // online softmax statistics: one thread per query row; l sums the
    // unscaled probabilities, then V's scale folds into the row
    if (tid < groups) {
      float* row = sc + tid * bs;
      const float m_old = m_s[tid];
      float m_new = m_old;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, row[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float pr = is_valid(base + t, p, window) ? expf(row[t] - m_new) : 0.f;
        sum += pr;
        row[t] = kQuant ? pr * vsc[t] : pr;
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
    __syncthreads();  // the next column overwrites k_s, v_s, sc, scales
  }

  for (int e = tid; e < groups * HD; e += kThreads) {
    const int g = e / HD;
    store(out + row0 + e, acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, const int* __restrict__ bt,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int hkv, int groups, int bs, int width, int window,
                        float scale) {
  decode_block<T, T, HD>(q, kp, nullptr, vp, nullptr, bt, pos, out, hkv,
                         groups, bs, width, window, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_int8_kernel(const T* __restrict__ q,
                             const int8_t* __restrict__ kp,
                             const float* __restrict__ ksp,
                             const int8_t* __restrict__ vp,
                             const float* __restrict__ vsp,
                             const int* __restrict__ bt,
                             const int* __restrict__ pos, T* __restrict__ out,
                             int hkv, int groups, int bs, int width,
                             int window, float scale) {
  decode_block<T, int8_t, HD>(q, kp, ksp, vp, vsp, bt, pos, out, hkv, groups,
                              bs, width, window, scale);
}

size_t smem_bytes(int groups, int block_size, int head_dim) {
  const size_t g = groups, bs = block_size, hd = head_dim;
  return sizeof(float) * (2 * g * hd + 2 * bs * hd + g * bs + 3 * g + 2 * bs);
}

// Launch `kernel` with one block per (slot, kv head); returns the
// launch's cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int slots, int kv_heads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(slots, kv_heads), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_float(const void* q, const void* k, const void* v, const void* bt,
                 const void* pos, void* out, int slots, int heads,
                 int kv_heads, int block_size, int width, int window,
                 cudaStream_t stream) {
  const int groups = heads / kv_heads;
  return launch(paged_decode_kernel<T, HD>, slots, kv_heads,
                smem_bytes(groups, block_size, HD), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const int*>(bt),
                static_cast<const int*>(pos), static_cast<T*>(out), kv_heads,
                groups, block_size, width, window,
                1.0f / sqrtf(static_cast<float>(HD)));
}

template <typename T, int HD>
int launch_int8(const void* q, const void* k, const void* ks, const void* v,
                const void* vs, const void* bt, const void* pos, void* out,
                int slots, int heads, int kv_heads, int block_size, int width,
                int window, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  return launch(paged_decode_int8_kernel<T, HD>, slots, kv_heads,
                smem_bytes(groups, block_size, HD), stream,
                static_cast<const T*>(q), static_cast<const int8_t*>(k),
                static_cast<const float*>(ks), static_cast<const int8_t*>(v),
                static_cast<const float*>(vs), static_cast<const int*>(bt),
                static_cast<const int*>(pos), static_cast<T*>(out), kv_heads,
                groups, block_size, width, window,
                1.0f / sqrtf(static_cast<float>(HD)));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out). head_dim: 64
// or 128. Returns the launch's cudaGetLastError() (0 = success); shapes
// are checked by the Python wrapper before the call.
int paged_decode(const void* q, const void* k, const void* v, const void* bt,
                 const void* pos, void* out, int slots, int heads,
                 int kv_heads, int head_dim, int block_size, int width,
                 int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_float<float, 64>(q, k, v, bt, pos, out, slots, heads,
                                   kv_heads, block_size, width, window, s);
  if (dtype == 0 && head_dim == 128)
    return launch_float<float, 128>(q, k, v, bt, pos, out, slots, heads,
                                    kv_heads, block_size, width, window, s);
  if (dtype == 1 && head_dim == 64)
    return launch_float<__nv_bfloat16, 64>(q, k, v, bt, pos, out, slots,
                                           heads, kv_heads, block_size,
                                           width, window, s);
  if (dtype == 1 && head_dim == 128)
    return launch_float<__nv_bfloat16, 128>(q, k, v, bt, pos, out, slots,
                                            heads, kv_heads, block_size,
                                            width, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools k, v with f32 scale planes ks, vs (N, Hkv, bs, 1); dtype
// (0 = float32, 1 = bfloat16) is q's and out's. Otherwise as
// `paged_decode`.
int paged_decode_int8(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* bt,
                      const void* pos, void* out, int slots, int heads,
                      int kv_heads, int head_dim, int block_size, int width,
                      int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_int8<float, 64>(q, k, ks, v, vs, bt, pos, out, slots,
                                  heads, kv_heads, block_size, width, window,
                                  s);
  if (dtype == 0 && head_dim == 128)
    return launch_int8<float, 128>(q, k, ks, v, vs, bt, pos, out, slots,
                                   heads, kv_heads, block_size, width, window,
                                   s);
  if (dtype == 1 && head_dim == 64)
    return launch_int8<__nv_bfloat16, 64>(q, k, ks, v, vs, bt, pos, out,
                                          slots, heads, kv_heads, block_size,
                                          width, window, s);
  if (dtype == 1 && head_dim == 128)
    return launch_int8<__nv_bfloat16, 128>(q, k, ks, v, vs, bt, pos, out,
                                           slots, heads, kv_heads,
                                           block_size, width, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
