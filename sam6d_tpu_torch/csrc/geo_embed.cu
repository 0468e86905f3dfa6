// Fused geometric-structure embedding on Hopper (sm_90a): the forward
// (geo_embed_fwd) and, below it, the backward (geo_embed_bwd).
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

// ---------------------------------------------------------------------------
// Backward.  Replaces the TPU kernel sam6d_tpu/ops/pallas/geo_embed.py:
// _geo_embed_bwd_call (kernel _bwd_kernel), reached through _vjp_bwd:
//
//   dMd[p, c]  = sum over pairs of T(xd)[p] * g[c]
//   dMa[p, c]  = sum over pairs and k of T(xa_k)[p] * g[c] * [e_k[c] == max]
//                / #ties[c]
//   dbias[c]   = sum over pairs of g[c]
//
// with e_k = T(xa_k) @ Ma recomputed exactly as the forward kernel above
// computes it (same rounded bases, same fmaf chain in the same order), so
// the k that wins the max, and every exact tie, is the one the forward saw.
// Ties split the cotangent evenly (jnp.max's VJP).  In bfloat16 the bases,
// g and each tie share are rounded to bfloat16 and every product is exact
// in float32, as bf16 operands with float32 sums on the MXU; in float32 the
// products stay float32.  All sums are float32.
//
// What bounds it on this card: operations.  Per pair and channel 40 + 84 +
// 84 multiply-adds (dMd, the recomputed e_k, dMa) against 2 bytes of g read
// in bfloat16: about 231 GFLOP for 1.1 GB at the training shape (56 x 197 x
// 197 pairs, d = 256).  This first version runs them on the CUDA cores in
// float32 (bound 3.4 ms at the card's 67 TFLOP/s), not the tensor cores.
// A variant with dMd and dMa on mma.sync m16n8k16 ran no faster on the card
// (9.85 against 9.87 ms), so the e_k rebuild, which has to stay on the
// CUDA cores in K2's fmaf order, and the shared-memory traffic around it
// set the time, not the products; the variant was dropped.
//
// Design: the TPU kernel carries its sums across a sequential grid.  Here a
// fixed grid of blocks (d threads, one channel each) walks the 64-pair
// tiles in a grid-stride loop, builds each tile's bases in shared memory as
// the forward does, and keeps its channel's 40 + 28 + 1 sums in registers
// for all of its tiles.  Each block writes its partial sums to its own
// scratch row; a second kernel adds the rows in block order.  No float
// atomics: the result is the same on every run.  No (pairs, k, d) tensor
// and no basis ever reaches device memory.

constexpr int kRows = kPd + kPa + 1;  // dMd rows, dMa rows, dbias

// One block of 256 threads per SM: each thread keeps its 28 Ma values and
// 69 sums in registers (about 150), which two blocks per SM would spill.
template <typename T>
__global__ void __launch_bounds__(256, 1)
    geo_embed_bwd_kernel(const float* __restrict__ d_idx,
                         const float* __restrict__ a_idx,
                         const T* __restrict__ ma_g, const T* __restrict__ g,
                         float* __restrict__ partial, int64_t n_pairs, int d,
                         float scale_d, float scale_a) {
  __shared__ __align__(16) float s_basis[kTile * kStride];
  const int tid = threadIdx.x;
  const int c = tid;  // blockDim.x == d
  float ma[kPa];
#pragma unroll
  for (int p = 0; p < kPa; ++p) ma[p] = to_float<T>(ma_g[p * d + c]);
  float acc_d[kPd];
  float acc_a[kPa];
#pragma unroll
  for (int p = 0; p < kPd; ++p) acc_d[p] = 0.0f;
#pragma unroll
  for (int p = 0; p < kPa; ++p) acc_a[p] = 0.0f;
  float acc_b = 0.0f;

  const int64_t n_tiles = (n_pairs + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t p0 = tile * kTile;
    const int npr = static_cast<int>(
        n_pairs - p0 < kTile ? n_pairs - p0 : kTile);
    __syncthreads();  // the previous tile's bases are no longer read
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
    __syncthreads();

    float g_next = to_float<T>(g[p0 * d + c]);
    for (int pr = 0; pr < npr; ++pr) {
      const float gv = g_next;
      if (pr + 1 < npr) g_next = to_float<T>(g[(p0 + pr + 1) * d + c]);
      const float* b = s_basis + pr * kStride;
      const float4* bd = reinterpret_cast<const float4*>(b);
#pragma unroll
      for (int q = 0; q < kPd / 4; ++q) {
        const float4 t = bd[q];
        acc_d[4 * q] = fmaf(t.x, gv, acc_d[4 * q]);
        acc_d[4 * q + 1] = fmaf(t.y, gv, acc_d[4 * q + 1]);
        acc_d[4 * q + 2] = fmaf(t.z, gv, acc_d[4 * q + 2]);
        acc_d[4 * q + 3] = fmaf(t.w, gv, acc_d[4 * q + 3]);
      }
      acc_b += gv;

      float e[kK];
      float emax = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        e[kk] = dot_basis<kPa>(b + kPd + kk * kPa, ma);
        emax = fmaxf(emax, e[kk]);
      }
      float cnt = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) cnt += e[kk] == emax ? 1.0f : 0.0f;
      const float share = round_to<T>(__fdiv_rn(gv, cnt));
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        // A loser adds exact zeros, which leaves every sum unchanged.
        const float w = e[kk] == emax ? share : 0.0f;
        const float4* ba = reinterpret_cast<const float4*>(b + kPd + kk * kPa);
#pragma unroll
        for (int q = 0; q < kPa / 4; ++q) {
          const float4 t = ba[q];
          acc_a[4 * q] = fmaf(t.x, w, acc_a[4 * q]);
          acc_a[4 * q + 1] = fmaf(t.y, w, acc_a[4 * q + 1]);
          acc_a[4 * q + 2] = fmaf(t.z, w, acc_a[4 * q + 2]);
          acc_a[4 * q + 3] = fmaf(t.w, w, acc_a[4 * q + 3]);
        }
      }
    }
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * kRows * d;
#pragma unroll
  for (int p = 0; p < kPd; ++p) out[p * d + c] = acc_d[p];
#pragma unroll
  for (int p = 0; p < kPa; ++p) out[(kPd + p) * d + c] = acc_a[p];
  out[(kPd + kPa) * d + c] = acc_b;
}

// Adds the blocks' partial rows in block order: one thread per output.
__global__ void geo_embed_bwd_fold(const float* __restrict__ partial,
                                   float* __restrict__ dmd,
                                   float* __restrict__ dma,
                                   float* __restrict__ dbias, int nblocks,
                                   int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = kRows * d;
  if (t >= total) return;
  float s = 0.0f;
  for (int blk = 0; blk < nblocks; ++blk) {
    s += partial[static_cast<int64_t>(blk) * total + t];
  }
  const int row = t / d;
  const int c = t - row * d;
  if (row < kPd) {
    dmd[row * d + c] = s;
  } else if (row < kPd + kPa) {
    dma[(row - kPd) * d + c] = s;
  } else {
    dbias[c] = s;
  }
}

}  // namespace

// Backward: d_idx, a_idx, scale_* as for geo_embed_fwd; ma (28, d) and g
// (n_pairs, d) in the compute dtype; partial (nblocks, 69, d) float32
// scratch; dmd (40, d), dma (28, d), dbias (d) float32 outputs.  Returns
// cudaGetLastError() after the two launches.
extern "C" int geo_embed_bwd(const void* d_idx, const void* a_idx,
                             const void* ma, const void* g, void* partial,
                             void* dmd, void* dma, void* dbias,
                             long long n_pairs, int d, float scale_d,
                             float scale_a, int is_bf16, int nblocks,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* di = static_cast<const float*>(d_idx);
  const float* ai = static_cast<const float*>(a_idx);
  float* part = static_cast<float*>(partial);
  if (is_bf16) {
    geo_embed_bwd_kernel<__nv_bfloat16><<<nblocks, d, 0, st>>>(
        di, ai, static_cast<const __nv_bfloat16*>(ma),
        static_cast<const __nv_bfloat16*>(g), part, n_pairs, d, scale_d,
        scale_a);
  } else {
    geo_embed_bwd_kernel<float><<<nblocks, d, 0, st>>>(
        di, ai, static_cast<const float*>(ma), static_cast<const float*>(g),
        part, n_pairs, d, scale_d, scale_a);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int total = kRows * d;
  geo_embed_bwd_fold<<<(total + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(dmd), static_cast<float*>(dma),
      static_cast<float*>(dbias), nblocks, d);
  return static_cast<int>(cudaGetLastError());
}

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
