// Fused geometric-structure embedding, forward, on Hopper (sm_90a).
//
// Replaces the TPU kernel sam6d_tpu/ops/pallas/geo_embed.py:geo_embed_maxk
// (_geo_embed_fwd_call, kernel _fwd_kernel):
//
//   out[p, :] = T(xd[p]) @ Md + max_k T(xa[p, k]) @ Ma + bias
//
// where T(x) is the Chebyshev basis T_0..T_{P-1} of the index field
// normalised to [-1, 1] (clamped, as _norm_idx does), run in float32 and
// rounded to the compute dtype (float32 or bfloat16) before the products,
// which accumulate in float32.  Pd = 40, Pa = 28, k = 3 (the PEM config).
//
// What bounds it on this card: per pair 2 * (40 + 3 * 28) * d flops against
// d output values.  At d = 256 that is 248 flops per output element, so a
// float32 output (4 bytes) is bound by float32 operations and a bfloat16
// output (2 bytes) by the bytes it writes (below the tensor cores' ~295
// flops per byte).  This first version runs the products on CUDA cores in
// float32, well short of the tensor-core rate.
//
// Design: one block of d threads (one output channel each) per tile of 64
// pairs.  Each thread holds its Md and Ma columns (68 floats) in registers
// for the whole tile.  The block first runs the four recurrences of every
// pair of the tile (1 distance + 3 angles) into shared memory, then each
// thread walks the pairs, reading each basis vector as a shared-memory
// broadcast, takes the max over k in registers, and writes its channel of
// the output row: the (B, N, N, k, d) angle tensor and the bases never touch
// device memory, and the output is written once, coalesced.
//
// The recurrence and the normalisation use explicitly rounded operations
// (no FMA contraction) in the order of the plain version, so the bases are
// bit-identical to it; only the dot-product summation order differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kPd = 40;
constexpr int kPa = 28;
constexpr int kK = 3;
constexpr int kTile = 64;     // pairs per block
constexpr int kStride = 128;  // floats per pair in shared memory (124 used)

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

template <typename T, int P>
__device__ __forceinline__ void cheb_basis(float raw, float scale,
                                           float* dst) {
  float x = __fsub_rn(__fmul_rn(raw, scale), 1.0f);
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  const float x2 = __fmul_rn(2.0f, x);
  float tp = 1.0f;
  float tc = x;
  dst[0] = round_to<T>(tp);
  dst[1] = round_to<T>(tc);
#pragma unroll
  for (int p = 2; p < P; ++p) {
    const float tn = __fsub_rn(__fmul_rn(x2, tc), tp);
    tp = tc;
    tc = tn;
    dst[p] = round_to<T>(tc);
  }
}

template <int P>
__device__ __forceinline__ float dot_basis(const float* __restrict__ b,
                                           const float (&m)[P]) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const float4 t = b4[q];
    acc = fmaf(t.x, m[4 * q], acc);
    acc = fmaf(t.y, m[4 * q + 1], acc);
    acc = fmaf(t.z, m[4 * q + 2], acc);
    acc = fmaf(t.w, m[4 * q + 3], acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(256)
    geo_embed_fwd_kernel(const float* __restrict__ d_idx,
                         const float* __restrict__ a_idx,
                         const T* __restrict__ md_g, const T* __restrict__ ma_g,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int64_t n_pairs, int d, float scale_d,
                         float scale_a) {
  __shared__ __align__(16) float s_basis[kTile * kStride];
  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int npr = static_cast<int>(
      n_pairs - p0 < kTile ? n_pairs - p0 : kTile);

  for (int task = tid; task < npr * (1 + kK); task += blockDim.x) {
    const int pr = task / (1 + kK);
    const int f = task % (1 + kK);
    float* dst = s_basis + pr * kStride;
    if (f == 0) {
      cheb_basis<T, kPd>(d_idx[p0 + pr], scale_d, dst);
    } else {
      cheb_basis<T, kPa>(a_idx[(p0 + pr) * kK + (f - 1)], scale_a,
                         dst + kPd + (f - 1) * kPa);
    }
  }

  const int c = tid;  // blockDim.x == d
  float md[kPd];
  float ma[kPa];
#pragma unroll
  for (int p = 0; p < kPd; ++p) md[p] = to_float<T>(md_g[p * d + c]);
#pragma unroll
  for (int p = 0; p < kPa; ++p) ma[p] = to_float<T>(ma_g[p * d + c]);
  const float bc = bias[c];
  __syncthreads();

  for (int pr = 0; pr < npr; ++pr) {
    const float* b = s_basis + pr * kStride;
    const float acc = dot_basis<kPd>(b, md);
    float amax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      amax = fmaxf(amax, dot_basis<kPa>(b + kPd + kk * kPa, ma));
    }
    out[(p0 + pr) * d + c] = from_float<T>(__fadd_rn(__fadd_rn(acc, amax), bc));
  }
}

}  // namespace

// d_idx (n_pairs) f32 (already clamped to hi_d by the caller), a_idx
// (n_pairs, 3) f32, md (40, d) / ma (28, d) in the compute dtype, bias (d)
// f32, out (n_pairs, d) in the compute dtype.  is_bf16 selects bfloat16
// (else float32).  d: a multiple of 32, at most 256.  scale_* = 2 / hi_*.
// Returns cudaGetLastError() after the launch.
extern "C" int geo_embed_fwd(const void* d_idx, const void* a_idx,
                             const void* md, const void* ma, const void* bias,
                             void* out, long long n_pairs, int d,
                             float scale_d, float scale_a, int is_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + kTile - 1) / kTile);
  const float* di = static_cast<const float*>(d_idx);
  const float* ai = static_cast<const float*>(a_idx);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    geo_embed_fwd_kernel<__nv_bfloat16><<<blocks, d, 0, st>>>(
        di, ai, static_cast<const __nv_bfloat16*>(md),
        static_cast<const __nv_bfloat16*>(ma), bi,
        static_cast<__nv_bfloat16*>(out), n_pairs, d, scale_d, scale_a);
  } else {
    geo_embed_fwd_kernel<float><<<blocks, d, 0, st>>>(
        di, ai, static_cast<const float*>(md), static_cast<const float*>(ma),
        bi, static_cast<float*>(out), n_pairs, d, scale_d, scale_a);
  }
  return static_cast<int>(cudaGetLastError());
}
