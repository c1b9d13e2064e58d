// Blocked matmul (K5) and the quantized-weight matmul: out = x @ y, x
// (M, K), y (K, N), both row major, summed in f32 and rounded once to the
// output dtype; for dequant_matmul y holds 1-byte values (int8 or
// float8 e4m3) with a per-column f32 scale ws (N,) that multiplies the
// f32 sum before that one rounding.
//
// Replaces the TPU kernel `_mm_kernel`, launched by `blocked_matmul` in
// shallowspeed_tpu/ops/matmul.py (kernel :27, pallas_call :108): an f32
// accumulator over the whole of K, written once in the output dtype (f32
// or bf16) for f32 or bf16 inputs. And the reference's `dequant_matmul`
// (matmul.py:58, XLA there): wq's values cast to x's dtype inside the
// dot, f32 accumulation, the scale on the f32 sum; "no (K, N) dequantized
// buffer ever exists" and "HBM reads stay 1 byte/element".
//
// Bound on the H100. K5 at the probe's shapes: operations, 2 M N K at
// 989 TFLOP/s in bf16 (tensor cores); at (16384, 1024) @ (1024, 4096)
// 0.139 ms against 0.053 ms of bytes. f32 inputs run at 67 TFLOP/s on
// the CUDA cores (TF32 is off). dequant_matmul on the serving tick (M 8
// rows): bytes, the 1-byte weight read once at 3.35 TB/s (2048 x 32768
// for the head: 20 us); its operations are ~1/100 of that.
//
// Two builds, chosen by the Python wrappers before the launch:
// - `gemm_tc_kernel`, bf16 x with K % 8 == 0 and a bf16 B with
//   N % 8 == 0 (K5) or a 1-byte B with N % 16 == 0 (dequant_matmul):
//   wgmma on the tensor cores (flash_tc.cuh). One block owns a
//   64 WG x 128 output tile, WG = 1 or 2 warpgroups each issuing
//   m64n128k16 on its 64 rows, the f32 accumulator in registers (64 a
//   thread). K runs in steps of 64 through a ring of 3 stages. A = x
//   arrives by TMA in 128B-swizzled 64 x 64
//   boxes, read K-major (`desc_k`). A bf16 B = y arrives by TMA too,
//   N contiguous, and is read MN-major (`desc_mn`), as K1 reads V. A
//   1-byte B arrives by 16-byte cp.async into a plain staging tile;
//   the block converts it to bf16 (exact for int8 and e4m3) and writes
//   it in exactly the swizzled layout TMA writes for a bf16 tile (the
//   16-byte chunk c of row r at chunk c ^ (r % 8)), then
//   fence.proxy.async makes it visible to wgmma: one product path
//   serves both B types and the weight crosses HBM at 1 byte an
//   element. Stage i + 2 is loaded while stage i is multiplied; a
//   block of one warpgroup (M <= 64) takes 65-75 KB of shared memory,
//   so three run on an SM and hide each other's waits, two of two
//   warpgroups. The epilogue scales (dequant) and rounds once; rows
//   past M and columns past N are masked at the store, and TMA /
//   cp.async zero-fill the loads past the edges.
//   The tick's M is 8, so a 64 x 128 tile grid has too few blocks to
//   stream the weight (the qkv dense, 2048 -> 6144, gives 48, proj and
//   down, -> 2048, give 16): below a block an SM the wrapper splits K
//   over blockIdx.z, each split writes its f32 partial sums, and
//   `split_sum_kernel` adds them in split order (deterministic), scales
//   and rounds. (Adding them in the tile's last block instead, found
//   by an atomic count, measured slower: its reads serialize.)
//   At 8 rows the block's work is mostly converting the weight: int8
//   becomes bf16 by byte permutes and one f32 subtraction a value
//   (`to_bf16x8`), not by int-to-float conversions.
// - `blocked_matmul_kernel`, everything else (f32 x, unaligned shapes):
//   f32 FMA on the CUDA cores. One block owns a 128 x 128 output tile
//   and loops over all of K, its f32 accumulator in registers (256
//   threads, 8 x 8 outputs each). Each step stages a 128 x 16 slice of
//   x (transposed, so a thread's rows are contiguous) and a 16 x 128
//   slice of y in shared memory as f32, read in 16-byte vectors (8-byte
//   for a 1-byte y) while the previous slice is multiplied; ragged edges
//   are masked and misaligned vectors read element by element, so it
//   takes any M, N, K. The f32 build stays full f32 (the parity bounds
//   need it).
// - fp8_dense's forward product (the reference's `fp8_dense`,
//   matmul.py:202, an XLA dot of two e4m3 operands with f32
//   accumulation there): `gemm_tc_kernel` with an e4m3 A as well, xq
//   (M, K) e4m3 @ wq (K, N) e4m3, the f32 sum times a per-column f32
//   scale (sx * sw) in the epilogue, out f32. Both operands arrive by
//   16-byte cp.async as bytes and the block converts them to f16 (one
//   instruction a pair; every e4m3 value, NaN too, is exact in f16) in
//   the swizzled layouts above: A K-major, B MN-major. The products run
//   on m64n128k16 f16 wgmma into the f32 accumulator. Hopper's 8-bit
//   wgmma (m64nNk32 .e4m3) does twice the operations a cycle but sums
//   with about 14 bits (the DeepSeek-V3 report's reading), a different
//   result from the reference's f32 sum; the 16-bit path keeps an f32
//   sum. K % 16 == 0 and N % 16 == 0 (whole chunks); the wrapper routes
//   other shapes (the MLP's 127, 125, 123 widths and N 10) to
//   `blocked_matmul_kernel<e4m3, e4m3, float>` (exact f32 FMA) with the
//   scale as its `ws`. Bound: operations, 2 M N K at the e4m3 peak,
//   1,979 TFLOP/s (the head at the 1.21B step, 8192 x 2048 x 32768:
//   0.56 ms); the f16 peak this build can reach is half that.
// The TPU grid runs K as its sequential third axis and carries the sum
// in VMEM from one grid step to the next; blocks here run in no order,
// so the K loop lives inside the block. The wrapper's (bm, bk, bn) are
// the interface's blocks, checked as the reference checks them; they do
// not tile these kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "flash_tc.cuh"

namespace {

// dtype codes of the C entries
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;
constexpr int kE4M3 = 3;

using e4m3 = __nv_fp8_e4m3;

// ------------------------------------------------ the f32-FMA build

constexpr int kBM = 128;   // output rows of a block
constexpr int kBN = 128;   // output columns of a block
constexpr int kBK = 16;    // k of one staged slice
constexpr int kThreads = 256;
constexpr int kPad = 4;    // keeps shared rows 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(e4m3 v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The vector a thread loads at once: 16 bytes (4 f32, 8 bf16), or 8
// bytes of a 1-byte type (8 values).
template <typename T>
struct Vec {
  using Raw = uint4;
  static constexpr int n = 16 / sizeof(T);
};
template <>
struct Vec<int8_t> {
  using Raw = uint2;
  static constexpr int n = 8;
};
template <>
struct Vec<e4m3> {
  using Raw = uint2;
  static constexpr int n = 8;
};

// The Vec<T>::n elements row[col ...] as floats, zero past `limit`; one
// vector load when the whole vector is in range and `aligned`.
template <typename T>
__device__ __forceinline__ void load_vec(const T* row, long long col,
                                         long long limit, bool aligned,
                                         float* dst) {
  constexpr int n = Vec<T>::n;
  if (aligned && col + n <= limit) {
    const typename Vec<T>::Raw raw =
        *reinterpret_cast<const typename Vec<T>::Raw*>(row + col);
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

template <typename TX, typename TY>
struct Slices {
  // vectors a thread loads per slice, of x and of y
  static constexpr int kA = kBM * kBK / Vec<TX>::n / kThreads;
  static constexpr int kB = kBK * kBN / Vec<TY>::n / kThreads;
};

// The x slice rows [m0, m0 + 128) x k [k0, k0 + 16) and the y slice
// k [k0, k0 + 16) x columns [n0, n0 + 128), as this thread's share of
// floats.
template <typename TX, typename TY>
__device__ __forceinline__ void load_slices(const TX* x, const TY* y, int m,
                                            int n, int k, int m0, int n0,
                                            int k0, bool a_vec, bool b_vec,
                                            float* ra, float* rb) {
  constexpr int kVa = Vec<TX>::n;
  constexpr int kVb = Vec<TY>::n;
#pragma unroll
  for (int r = 0; r < Slices<TX, TY>::kA; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int row = v / (kBK / kVa);
    const int kc = (v % (kBK / kVa)) * kVa;
    const int gm = m0 + row;
    const TX* src = x + static_cast<long long>(gm) * k;
    load_vec(src, k0 + kc, gm < m ? k : 0, a_vec, ra + r * kVa);
  }
#pragma unroll
  for (int r = 0; r < Slices<TX, TY>::kB; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int kr = v / (kBN / kVb);
    const int col = (v % (kBN / kVb)) * kVb;
    const int gk = k0 + kr;
    const TY* src = y + static_cast<long long>(gk) * n;
    load_vec(src, n0 + col, gk < k ? n : 0, b_vec, rb + r * kVb);
  }
}

template <typename TX, typename TY>
__device__ __forceinline__ void stage(const float* ra, const float* rb,
                                      float (*as)[kBM + kPad],
                                      float (*bs)[kBN + kPad]) {
  constexpr int kVa = Vec<TX>::n;
  constexpr int kVb = Vec<TY>::n;
#pragma unroll
  for (int r = 0; r < Slices<TX, TY>::kA; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int row = v / (kBK / kVa);
    const int kc = (v % (kBK / kVa)) * kVa;
#pragma unroll
    for (int i = 0; i < kVa; ++i) as[kc + i][row] = ra[r * kVa + i];
  }
#pragma unroll
  for (int r = 0; r < Slices<TX, TY>::kB; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int kr = v / (kBN / kVb);
    const int col = (v % (kBN / kVb)) * kVb;
#pragma unroll
    for (int i = 0; i < kVb; i += 4)
      *reinterpret_cast<float4*>(&bs[kr][col + i]) =
          make_float4(rb[r * kVb + i], rb[r * kVb + i + 1],
                      rb[r * kVb + i + 2], rb[r * kVb + i + 3]);
  }
}

// `ws` (N,) f32 scales the f32 sums before the store, or nullptr.
template <typename TX, typename TY, typename O>
__global__ void __launch_bounds__(kThreads)
    blocked_matmul_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                          const float* __restrict__ ws, O* __restrict__ out,
                          int m, int n, int k, bool a_vec, bool b_vec,
                          bool o_vec) {
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

  float ra[Slices<TX, TY>::kA * Vec<TX>::n];
  float rb[Slices<TX, TY>::kB * Vec<TY>::n];
  const int nk = (k + kBK - 1) / kBK;
  load_slices(x, y, m, n, k, m0, n0, 0, a_vec, b_vec, ra, rb);
  stage<TX, TY>(ra, rb, as[0], bs[0]);
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
    if (t + 1 < nk) stage<TX, TY>(ra, rb, as[cur ^ 1], bs[cur ^ 1]);
    __syncthreads();
  }

  if (ws != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      const float sc = col < n ? ws[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] *= sc;
    }
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <typename TX, typename TY, typename O>
int launch(const void* x, const void* y, const void* ws, void* out, int m,
           int n, int k, cudaStream_t stream) {
  constexpr int kVa = Vec<TX>::n;
  constexpr int kVb = Vec<TY>::n;
  // a row's vectors stay on vector boundaries when the row length is a
  // multiple of the vector and the base is aligned
  const bool a_vec = k % kVa == 0 && aligned(x, kVa * sizeof(TX));
  const bool b_vec = n % kVb == 0 && aligned(y, kVb * sizeof(TY));
  const bool o_vec = n % 4 == 0 && aligned(out, 4 * sizeof(O));
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  blocked_matmul_kernel<TX, TY, O><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y),
      static_cast<const float*>(ws), static_cast<O*>(out), m, n, k, a_vec,
      b_vec, o_vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ the tensor-core build

namespace tc = flash_tc;

constexpr int kTcBN = 128;   // output columns of a block
constexpr int kTcBK = 64;    // k of one stage: one 128-byte bf16 box row

// The block's shared memory, per build: WG warpgroups (64 WG output
// rows), B of dtype code BT (kBF16 by TMA, kI8 / kE4M3 by cp.async), A
// of dtype code AT (kBF16 by TMA; kE4M3 by cp.async, with an e4m3 B:
// fp8_dense's build, both converted to f16).
template <int WG, int BT, int AT = kBF16>
struct Gemm {
  static_assert(AT == kBF16 || (AT == kE4M3 && BT == kE4M3),
                "an e4m3 A takes an e4m3 B");
  static constexpr bool kByte = BT != kBF16;
  static constexpr bool kAByte = AT != kBF16;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kStages = 3;
  // one warpgroup (the tick's rows) fits three blocks an SM
  static constexpr int kMinBlocks = WG == 1 ? 3 : 2;
  static constexpr int kABytes = WG * tc::kBoxBytes;   // 64 WG x 64 k bf16
  static constexpr int kBBytes = 2 * tc::kBoxBytes;    // 64 k x 128 n bf16
  static constexpr int kRawABytes = 64 * WG * kTcBK;   // 64 WG x 64 k bytes
  static constexpr int kRawBytes = kTcBK * kTcBN;      // 64 k x 128 n bytes
  // a stage: A (bf16, or the raw 1-byte tile), then B (bf16, or the raw
  // 1-byte tile); a 1-byte operand converts into one 2-byte tile after
  // the ring (A's first)
  static constexpr int kAPart = kAByte ? kRawABytes : kABytes;
  static constexpr int kStageBytes = kAPart + (kByte ? kRawBytes : kBBytes);
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kConv = (kAByte ? kABytes : 0) + (kByte ? kBBytes : 0);
  static constexpr int kSmem = kRing + kConv + kStages * 8 + 1024;
};

// Four bf16 pairs (one 16-byte chunk) from 8 one-byte values. int8 v
// without int-to-float conversions (quarter rate, and the block's
// bottleneck): v + 128 goes into the low mantissa byte of 2^23, one
// subtraction of 2^23 + 128 gives v exactly as an f32 whose low 16 bits
// are 0, and its high half is v in bf16.
__device__ __forceinline__ uint4 to_bf16x8(uint2 raw, int8_t) {
  const uint32_t u[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = u[i / 2];
    const int k = 2 * (i % 2);          // bytes k, k + 1 of the word
    const float lo =
        __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 | k)) -
        8388736.f;
    const float hi =
        __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 | (k + 1))) -
        8388736.f;
    w[i] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
  return out;
}

__device__ __forceinline__ uint4 to_bf16x8(uint2 raw, e4m3) {
  const __nv_fp8x2_storage_t* v =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(v[i], __NV_E4M3)));
    w[i] = tc::pack_bf16(f.x, f.y);
  }
  return out;
}

// Four f16 pairs from 8 e4m3 values: one conversion a pair, exact (e4m3
// lies inside f16's range and precision; NaN stays NaN).
__device__ __forceinline__ uint4 to_f16x8(uint2 raw) {
  const __nv_fp8x2_storage_t* v =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(v[i], __NV_E4M3);
    w[i] = static_cast<uint32_t>(h.x) | static_cast<uint32_t>(h.y) << 16;
  }
  return out;
}

// 8 one-byte values as 8 two-byte operands: f16 for fp8_dense's build
// (F16), else bf16.
template <typename TB, bool F16>
__device__ __forceinline__ uint4 to_operand_x8(uint2 raw) {
  if constexpr (F16)
    return to_f16x8(raw);
  else
    return to_bf16x8(raw, TB{});
}

// The raw 64 k x 128 n tile of 1-byte values (row major) as bf16 (f16
// when F16) in the layout TMA's SWIZZLE_128B writes: two boxes (n 0-63,
// 64-127) of 64 rows x 128 bytes, the 16-byte chunk c of row r at chunk
// c ^ (r % 8).
template <typename TB, bool F16>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, uint8_t* b,
                                             int tid, int threads) {
  for (int c = tid; c < kTcBK * kTcBN / 16; c += threads) {
    const int r = c / (kTcBN / 16);
    const int c16 = c % (kTcBN / 16);    // columns 16 c16 ... 16 c16 + 15
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kTcBN + 16 * c16);
    uint8_t* row = b + (c16 / 4) * tc::kBoxBytes + r * 128;
    const int ch = 2 * (c16 % 4);        // its first chunk in the box row
    *reinterpret_cast<uint4*>(row + 16 * (ch ^ (r % 8))) =
        to_operand_x8<TB, F16>(make_uint2(v.x, v.y));
    *reinterpret_cast<uint4*>(row + 16 * ((ch + 1) ^ (r % 8))) =
        to_operand_x8<TB, F16>(make_uint2(v.z, v.w));
  }
}

// The raw ROWS m x 64 k tile of e4m3 values (row major) as f16, K-major
// in the layout TMA's SWIZZLE_128B writes for a 2-byte A: ROWS / 64
// boxes of 64 rows x 128 bytes (k 0-63), the 16-byte chunk c of row r at
// chunk c ^ (r % 8).
template <int ROWS>
__device__ __forceinline__ void convert_a(const uint8_t* raw, uint8_t* a,
                                          int tid, int threads) {
  for (int c = tid; c < ROWS * kTcBK / 16; c += threads) {
    const int r = c / (kTcBK / 16);
    const int c16 = c % (kTcBK / 16);    // k 16 c16 ... 16 c16 + 15
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kTcBK + 16 * c16);
    uint8_t* row = a + (r / 64) * tc::kBoxBytes + (r % 64) * 128;
    const int ch = 2 * c16;              // its first chunk in the box row
    *reinterpret_cast<uint4*>(row + 16 * (ch ^ (r % 8))) =
        to_f16x8(make_uint2(v.x, v.y));
    *reinterpret_cast<uint4*>(row + 16 * ((ch + 1) ^ (r % 8))) =
        to_f16x8(make_uint2(v.z, v.w));
  }
}

// `tc::wgmma_ss_n128_t` with f16 operands: d (64 x 128, f32) += A B, A
// (64 x 16 f16) K-major, B (16 x 128 f16) MN-major, both in shared
// memory.
__device__ __forceinline__ void wgmma_ss_n128_t_f16(float (&d)[64],
                                                    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// One block: output rows [m0, m0 + 64 WG) x columns [n0, n0 + 128),
// over the k tiles [kt0, kt0 + k_tiles) of split blockIdx.z. x by TMA
// (`ma`, AT == kBF16) or as e4m3 values `xa` with K % 16 == 0; y by TMA
// (`mb`, BT == kBF16) or as 1-byte values `wq` with N % 16 == 0. With
// `part` the f32 sums go there, (split, M, N); else they are scaled by
// `ws` (when given) and stored in `out`, bf16 when `out_bf16`, else f32.
template <int WG, int BT, int AT>
__global__ void __launch_bounds__(128 * WG, Gemm<WG, BT, AT>::kMinBlocks)
    gemm_tc_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   const uint8_t* __restrict__ xa,
                   const uint8_t* __restrict__ wq,
                   const float* __restrict__ ws, void* __restrict__ out,
                   float* __restrict__ part, int m, int n, int k,
                   int k_tiles, int out_bf16) {
  using G = Gemm<WG, BT, AT>;
  using TB = typename std::conditional<BT == kE4M3, e4m3, int8_t>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* aconv = base + G::kRing;   // an e4m3 A as f16
  uint8_t* bconv = aconv + (G::kAByte ? G::kABytes : 0);   // a 1-byte B
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(bconv + (G::kByte ? G::kBBytes : 0));

  const int n0 = blockIdx.x * kTcBN;
  const int m0 = blockIdx.y * 64 * WG;
  const int kt0 = blockIdx.z * k_tiles;
  const int nk = min(k_tiles, (k + kTcBK - 1) / kTcBK - kt0);
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  // k tile j of this split into stage j % S
  auto issue = [&](int j) {
    uint8_t* st = base + (j % G::kStages) * G::kStageBytes;
    uint64_t* bar = &bars[j % G::kStages];
    const int k0 = (kt0 + j) * kTcBK;
    if (tid == 0 && !G::kAByte) {
      tc::bar_expect(bar, G::kABytes + (G::kByte ? 0 : G::kBBytes));
#pragma unroll
      for (int w = 0; w < WG; ++w)
        tc::load_box(st + w * tc::kBoxBytes, &ma, bar, k0, m0 + 64 * w);
      if (!G::kByte) {
        tc::load_box(st + G::kABytes, &mb, bar, n0, k0);
        tc::load_box(st + G::kABytes + tc::kBoxBytes, &mb, bar, n0 + 64, k0);
      }
    }
    if (G::kAByte) {
      for (int c = tid; c < 64 * WG * kTcBK / 16; c += G::kThreads) {
        const int r = c / (kTcBK / 16);
        const int col = 16 * (c % (kTcBK / 16));
        // K % 16 == 0: a chunk lies wholly inside or wholly past K
        const bool ok = m0 + r < m && k0 + col < k;
        tc::cp_async16(st + r * kTcBK + col,
                       ok ? xa + static_cast<long long>(m0 + r) * k + k0 + col
                          : xa,
                       ok);
      }
    }
    if (G::kByte) {
      uint8_t* raw = st + G::kAPart;
      for (int c = tid; c < kTcBK * kTcBN / 16; c += G::kThreads) {
        const int r = c / (kTcBN / 16);
        const int col = 16 * (c % (kTcBN / 16));
        // N % 16 == 0: a chunk lies wholly inside or wholly past N
        const bool ok = k0 + r < k && n0 + col < n;
        tc::cp_async16(raw + r * kTcBN + col,
                       ok ? wq + static_cast<long long>(k0 + r) * n + n0 + col
                          : wq,
                       ok);
      }
      tc::cp_async_commit();
    }
  };

  if (tid == 0) {
    for (int i = 0; i < G::kStages; ++i) tc::bar_init(&bars[i]);
    tc::fence_bar_init();
  }
  __syncthreads();
  // every thread commits one cp.async group per k tile (empty past the
  // end), so "tile i has landed" is "at most S - 2 groups pending"
  for (int j = 0; j < G::kStages - 1; ++j) {
    if (j < nk)
      issue(j);
    else if (G::kByte)
      tc::cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % G::kStages;
    uint8_t* st = base + s * G::kStageBytes;
    if (G::kByte) tc::cp_async_wait<G::kStages - 2>();
    // every warpgroup has waited on its products of tile i - 1, so its
    // stage is free; the raw bytes of tile i are in for every thread
    __syncthreads();
    if (i + G::kStages - 1 < nk)
      issue(i + G::kStages - 1);
    else if (G::kByte)
      tc::cp_async_commit();
    uint32_t b_addr = tc::smem_u32(st + G::kAPart);
    uint32_t a_addr = tc::smem_u32(st + wg * tc::kBoxBytes);
    if (G::kByte) {
      if (G::kAByte) {
        convert_a<64 * WG>(st, aconv, tid, G::kThreads);
        a_addr = tc::smem_u32(aconv + wg * tc::kBoxBytes);
      }
      convert_tile<TB, G::kAByte>(st + G::kAPart, bconv, tid, G::kThreads);
      tc::fence_proxy_async();   // the generic writes, before wgmma reads
      __syncthreads();
      b_addr = tc::smem_u32(bconv);
    }
    if (!G::kAByte) tc::bar_wait(&bars[s], (i / G::kStages) & 1);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      if constexpr (G::kAByte)
        wgmma_ss_n128_t_f16(acc, tc::desc_k(a_addr, ks),
                            tc::desc_mn(b_addr, ks));
      else
        tc::wgmma_ss_n128_t(acc, tc::desc_k(a_addr, ks),
                            tc::desc_mn(b_addr, ks));
    }
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs(acc);
  }

  // thread t of warpgroup wg: rows 16 (t / 32) + (t % 32) / 4 (+ 8) of
  // its 64, columns 8 j + 2 (t % 4) (+ 1), j < 16
  const int lane = tid % 32;
  const int row0 = m0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
      const int col = col0 + 8 * j;     // N % 8 == 0: col + 1 < N too
      if (col >= n) continue;
      float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      const long long at = static_cast<long long>(row) * n + col;
      if (part != nullptr) {
        *reinterpret_cast<float2*>(
            part + static_cast<long long>(blockIdx.z) * m * n + at) =
            make_float2(v0, v1);
        continue;
      }
      if (ws != nullptr) {
        v0 *= ws[col];
        v1 *= ws[col + 1];
      }
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(out) + at) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
            make_float2(v0, v1);
    }
  }
}

// out = (sum over the splits of part, in split order) * ws, rounded once.
__global__ void split_sum_kernel(const float* __restrict__ part,
                                 const float* __restrict__ ws,
                                 void* __restrict__ out, int m, int n,
                                 int splits, int out_bf16) {
  const long long size = static_cast<long long>(m) * n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= size) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[z * size + i];
  if (ws != nullptr) v *= ws[i % n];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

template <int WG, int BT, int AT = kBF16>
int launch_tc(const CUtensorMap& ma, const CUtensorMap& mb, const void* xa,
              const void* wq, const void* ws, void* out, void* part, int m,
              int n, int k, int splits, int out_bf16, cudaStream_t stream) {
  using G = Gemm<WG, BT, AT>;
  auto kernel = gemm_tc_kernel<WG, BT, AT>;
  int e = tc::set_smem(reinterpret_cast<const void*>(kernel), G::kSmem);
  if (e != 0) return e;
  const int k_all = (k + kTcBK - 1) / kTcBK;
  const int k_tiles = (k_all + splits - 1) / splits;
  const dim3 grid((n + kTcBN - 1) / kTcBN, (m + 64 * WG - 1) / (64 * WG),
                  splits);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      ma, mb, static_cast<const uint8_t*>(xa),
      static_cast<const uint8_t*>(wq),
      static_cast<const float*>(ws), out,
      splits > 1 ? static_cast<float*>(part) : nullptr, m, n, k, k_tiles,
      out_bf16);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  const long long size = static_cast<long long>(m) * n;
  split_sum_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0,
                     stream>>>(static_cast<const float*>(part),
                               static_cast<const float*>(ws), out, m, n,
                               splits, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int WG>
int dispatch_tc(const CUtensorMap& ma, const CUtensorMap& mb, const void* wq,
                const void* ws, void* out, void* part, int m, int n, int k,
                int splits, int b_dtype, int out_bf16, cudaStream_t stream) {
#define LAUNCH_TC(BT)                                                    \
  return launch_tc<WG, BT>(ma, mb, nullptr, wq, ws, out, part, m, n, k, \
                           splits, out_bf16, stream)
  if (b_dtype == kBF16) LAUNCH_TC(kBF16);
  if (b_dtype == kI8) LAUNCH_TC(kI8);
  if (b_dtype == kE4M3) LAUNCH_TC(kE4M3);
#undef LAUNCH_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The f32-FMA build. x (m, k) and y (k, n) row major, contiguous; out
// (m, n) row major; ws (n,) f32 scales of the sums, or null. Dtype codes:
// 0 float32, 1 bfloat16, 2 int8, 3 float8 e4m3. Takes x f32 or bf16 with
// y of x's dtype (out f32 or bf16), or a 1-byte y (out in x's dtype), or
// e4m3 x and y (out f32).
// m, n, k > 0 and m at most 65535 * 128 (the grid's y extent). Returns
// the launch's cudaGetLastError() (0 = success); the Python wrapper
// checks shapes, types and devices before the call.
int blocked_matmul(const void* x, const void* y, const void* ws, void* out,
                   int m, int n, int k, int x_dtype, int y_dtype,
                   int out_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define BLOCKED_MATMUL(X, Y, O, TX, TY, TO)                      \
  if (x_dtype == X && y_dtype == Y && out_dtype == O)            \
  return launch<TX, TY, TO>(x, y, ws, out, m, n, k, s)
  BLOCKED_MATMUL(kF32, kF32, kF32, float, float, float);
  BLOCKED_MATMUL(kF32, kF32, kBF16, float, float, __nv_bfloat16);
  BLOCKED_MATMUL(kBF16, kBF16, kF32, __nv_bfloat16, __nv_bfloat16, float);
  BLOCKED_MATMUL(kBF16, kBF16, kBF16, __nv_bfloat16, __nv_bfloat16,
                 __nv_bfloat16);
  BLOCKED_MATMUL(kF32, kI8, kF32, float, int8_t, float);
  BLOCKED_MATMUL(kF32, kE4M3, kF32, float, e4m3, float);
  BLOCKED_MATMUL(kBF16, kI8, kBF16, __nv_bfloat16, int8_t, __nv_bfloat16);
  BLOCKED_MATMUL(kBF16, kE4M3, kBF16, __nv_bfloat16, e4m3, __nv_bfloat16);
  BLOCKED_MATMUL(kE4M3, kE4M3, kF32, e4m3, e4m3, float);
#undef BLOCKED_MATMUL
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core build. x (m, k) bf16 row major with k % 8 == 0 (a_dtype
// 1) or e4m3 with k % 16 == 0 (a_dtype 3, fp8_dense's build: y e4m3, out
// f32); y (k, n) row major, bf16 with n % 8 == 0 (b_dtype 1) or int8 /
// e4m3 values with n % 16 == 0 (b_dtype 2 / 3); x, y 16-byte aligned. ws
// (n,) f32 or null; out (m, n) bf16 (out_dtype 1) or f32 (0). `wg` is the
// warpgroups of a block (1 or 2: 64 or 128 output rows). With splits > 1
// K is split that many ways over blockIdx.z and `part` holds
// splits x m x n f32 partial sums; `split_sum_kernel` then writes out.
// Returns the launches' cudaGetLastError() (0 = success).
int gemm_tc(const void* x, const void* y, const void* ws, void* out,
            void* part, int m, int n, int k, int wg, int splits, int a_dtype,
            int b_dtype, int out_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 || (wg != 1 && wg != 2) ||
      (m + 64 * wg - 1) / (64 * wg) > 65535 ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_dtype == kE4M3) {
    if (b_dtype != kE4M3 || out_dtype != kF32 || k % 16 != 0 || n % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMap none = {};   // both operands come by cp.async
#define LAUNCH_FP8(WG)                                                  \
  return launch_tc<WG, kE4M3, kE4M3>(none, none, x, y, ws, out, part, m, \
                                     n, k, splits, 0, s)
    if (wg == 1) LAUNCH_FP8(1);
    LAUNCH_FP8(2);
#undef LAUNCH_FP8
  }
  if (a_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb = {};
  int e = tc::map_2d(&ma, x, m, k, k);
  if (e == 0 && b_dtype == kBF16) e = tc::map_2d(&mb, y, k, n, n);
  if (e != 0) return e;
  const int out_bf16 = out_dtype == kBF16;
  return wg == 1 ? dispatch_tc<1>(ma, mb, y, ws, out, part, m, n, k, splits,
                                  b_dtype, out_bf16, s)
                 : dispatch_tc<2>(ma, mb, y, ws, out, part, m, n, k, splits,
                                  b_dtype, out_bf16, s);
}

// Dynamic shared memory of the tensor-core build, in bytes.
int gemm_tc_smem(int wg, int a_dtype, int b_dtype) {
  if (a_dtype == kE4M3) return wg == 1 ? Gemm<1, kE4M3, kE4M3>::kSmem
                                       : Gemm<2, kE4M3, kE4M3>::kSmem;
  if (b_dtype == kBF16) return wg == 1 ? Gemm<1, kBF16>::kSmem
                                       : Gemm<2, kBF16>::kSmem;
  return wg == 1 ? Gemm<1, kI8>::kSmem : Gemm<2, kI8>::kSmem;
}

const char* blocked_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
