// Fused SAM AMG decode-tail statistics on Hopper (sm_90a).
//
// Replaces the TPU kernel sam6d_tpu/ops/pallas/decode_tail.py:
// decode_tail_stats.  Per prompt p and token n of its post-transformer
// image features keys[p, n, :] (256 channels):
//
//   h1  = keys @ W1 + b1                  (256 cols, nesting (a, d, c4))
//   g   = gelu_s(LN_64(h1) * lns + lnb)   (LayerNorm over each 64-col group)
//   y2  = gelu_s(g[ad] @ W2 + b2)         (per group ad: 128 cols (e, f, c8))
//   m   = y2[(e, f)] . hyper[p, t]        (t < 3 mask tokens)
//
// where gelu_s(x) = x * sigmoid(1.702 x), the sigmoid form the TPU kernel
// uses (the exact-erf tail is recomputed only for the kept candidates).
// The logit m belongs to pixel (4 y + 2 a + e, 4 x + 2 d + f) of the
// 4x-upscaled mask of token t, with (y, x) = divmod(n, side).  Out of the
// logits only statistics leave the card, per column (e, f, t) = e*6+f*3+t:
//   row 0: count(m > thr + off)   row 1: count(m > thr - off)
//   rows 2..5: xmin, ymin, xmax, ymax over m > thr (+-1e9 when empty)
//   row 6: count(m > thr)          row 7: 0
// All arithmetic is float32, as in the TPU kernel.
//
// What bounds it on this card: per token about 100k multiply-adds (the
// 256x256 stage 1 dominates) against 512 bytes of bf16 keys, far above the
// card's ~295 flops per byte, so it is bound by operations.  This first
// version runs the products on the CUDA cores in float32.
//
// Design: one block of 256 threads per (prompt, tile of 64 tokens).  The
// tile's keys are read once from device memory into shared memory
// (transposed, float32); W1 streams through shared memory in chunks of 32
// rows while each thread accumulates an 8 x 8 block of h1 in registers.
// The group LayerNorm reduces over the 8 threads that hold one row's
// 64-column group (shuffles), and the normalised, activated g goes back to
// shared memory.  Stage 2 (64 x 64 @ 64 x 128 per group ad) keeps a 4 x 8
// block per thread; its activated output passes through shared memory to
// the hypernetwork contraction, where thread (ef, row) forms the three
// logits of its pixel and folds them into per-thread statistics.  A warp
// reduction and one write per block put the tile's 8 x 12 statistics into
// a scratch row; a second small kernel reduces the tiles of each prompt in
// a fixed order, so the result does not depend on scheduling.  Neither the
// stage intermediates nor a single mask logit touch device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kC = 256;       // key channels
constexpr int kR = 64;        // tokens per block
constexpr int kThreads = 256;
constexpr int kXS = kR + 4;   // stride of the transposed key / g tile
constexpr int kKC = 32;       // W1 rows per chunk
constexpr int kYS = 129;      // stride of the stage-2 output rows
constexpr int kStats = 8 * 12;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float gelu_s(float x) {
  return x * (1.0f / (1.0f + expf(-1.702f * x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_tail_kernel(const T* __restrict__ keys,
                       const float* __restrict__ hyper,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ lns,
                       const float* __restrict__ lnb,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       float* __restrict__ partial, int N, int side, float thr,
                       float off, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* sXT = smem;                // [256][kXS]: keys^T, then g^T
  float* sW = sXT + kC * kXS;       // [32][256] W1 chunk, then [64][128] W2
  float* sY = sW + kKC * kC;        // [64][kYS]
  float* sB1 = sY + kR * kYS;       // 256
  float* sLs = sB1 + kC;            // 256
  float* sLb = sLs + kC;            // 256
  float* sB2 = sLb + kC;            // 128
  float* sHy = sB2 + 128;           // 96
  float* sRed = sHy + 96;           // [8 warps][21]

  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int tile = blockIdx.x;
  const int n0 = tile * kR;

  const T* kp = keys + (static_cast<int64_t>(p) * N + n0) * kC;
  for (int idx = tid; idx < kR * kC; idx += kThreads) {
    const int r = idx / kC;
    const int c = idx - r * kC;
    sXT[c * kXS + r] = n0 + r < N ? load_f(kp + idx) : 0.0f;
  }
  for (int i = tid; i < kC; i += kThreads) {
    sB1[i] = b1[i];
    sLs[i] = lns[i];
    sLb[i] = lnb[i];
  }
  if (tid < 128) sB2[tid] = b2[tid];
  if (tid < 96) sHy[tid] = hyper[p * 96 + tid];

  // ---- stage 1: h1 (64 x 256), thread block rows 8 ty.., cols 8 tx.. ----
  const int ty = tid >> 5;
  const int tx = tid & 31;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < kC; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * kC; idx += kThreads)
      sW[idx] = w1[k0 * kC + idx];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const float* xa = sXT + (k0 + kk) * kXS + 8 * ty;
      const float* wb = sW + kk * kC + 8 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(xa);
      const float4 a1 = *reinterpret_cast<const float4*>(xa + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(wb);
      const float4 c1 = *reinterpret_cast<const float4*>(wb + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // ---- bias, LayerNorm over 64-column groups, sigmoid GELU -------------
  // The 8 threads tx = 8 g .. 8 g + 7 hold group g of each of their rows.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] += sB1[8 * tx + j];
      sum += acc[i][j];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * (1.0f / 64.0f);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dv = acc[i][j] - mu;
      sq += dv * dv;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float den = sqrtf(sq * (1.0f / 64.0f) + eps);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xn = (acc[i][j] - mu) / den * sLs[8 * tx + j] + sLb[8 * tx + j];
      acc[i][j] = gelu_s(xn);
    }
  }
  __syncthreads();  // every thread is done with keys^T and the W1 chunk
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* dst = sXT + (8 * tx + j) * kXS + 8 * ty;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
  for (int idx = tid; idx < 64 * 128; idx += kThreads) sW[idx] = w2[idx];

  // ---- stage 2 per group ad, contraction and statistics ----------------
  const int ty2 = tid >> 4;  // rows 4 ty2 ..
  const int tx2 = tid & 15;  // cols 8 tx2 ..
  const int ef = tid >> 6;   // contraction: (e, f) and row
  const int row = tid & 63;
  const int e = ef >> 1, f = ef & 1;
  const int n = n0 + row;
  const bool valid = n < N;
  const int ybase = 4 * (n / side) + e;
  const int xbase = 4 * (n % side) + f;
  float hi[3], lo[3], pos[3], xmn[3], ymn[3], xmx[3], ymx[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    hi[t] = lo[t] = pos[t] = 0.0f;
    xmn[t] = ymn[t] = kBig;
    xmx[t] = ymx[t] = -kBig;
  }
  for (int ad = 0; ad < 4; ++ad) {
    __syncthreads();  // g^T and W2 written; the previous sY consumed
    float y[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) y[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < 64; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(sXT + (ad * 64 + kk) * kXS + 4 * ty2);
      const float* wb = sW + kk * 128 + 8 * tx2;
      const float4 c0 = *reinterpret_cast<const float4*>(wb);
      const float4 c1 = *reinterpret_cast<const float4*>(wb + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float b[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) y[i][j] = fmaf(av[i], b[j], y[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sY[(4 * ty2 + i) * kYS + 8 * tx2 + j] = gelu_s(y[i][j] + sB2[8 * tx2 + j]);
    __syncthreads();

    const float* yr = sY + row * kYS + ef * 32;
    float m[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float yv = yr[c];
      m[0] = fmaf(yv, sHy[c], m[0]);
      m[1] = fmaf(yv, sHy[32 + c], m[1]);
      m[2] = fmaf(yv, sHy[64 + c], m[2]);
    }
    if (valid) {
      const float Y = static_cast<float>(ybase + 2 * (ad >> 1));
      const float X = static_cast<float>(xbase + 2 * (ad & 1));
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        hi[t] += m[t] > thr + off ? 1.0f : 0.0f;
        lo[t] += m[t] > thr - off ? 1.0f : 0.0f;
        if (m[t] > thr) {
          pos[t] += 1.0f;
          xmn[t] = fminf(xmn[t], X);
          ymn[t] = fminf(ymn[t], Y);
          xmx[t] = fmaxf(xmx[t], X);
          ymx[t] = fmaxf(ymx[t], Y);
        }
      }
    }
  }

  // ---- reduce the 64 rows of each (e, f): warp shuffles, then 2 warps --
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      hi[t] += __shfl_xor_sync(0xffffffffu, hi[t], o);
      lo[t] += __shfl_xor_sync(0xffffffffu, lo[t], o);
      pos[t] += __shfl_xor_sync(0xffffffffu, pos[t], o);
      xmn[t] = fminf(xmn[t], __shfl_xor_sync(0xffffffffu, xmn[t], o));
      ymn[t] = fminf(ymn[t], __shfl_xor_sync(0xffffffffu, ymn[t], o));
      xmx[t] = fmaxf(xmx[t], __shfl_xor_sync(0xffffffffu, xmx[t], o));
      ymx[t] = fmaxf(ymx[t], __shfl_xor_sync(0xffffffffu, ymx[t], o));
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    float* r = sRed + warp * 21;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      r[t] = hi[t];
      r[3 + t] = lo[t];
      r[6 + t] = xmn[t];
      r[9 + t] = ymn[t];
      r[12 + t] = xmx[t];
      r[15 + t] = ymx[t];
      r[18 + t] = pos[t];
    }
  }
  __syncthreads();
  if (tid < 12) {
    const int efc = tid / 3, t = tid % 3;  // column tid = ef * 3 + t
    const float* a = sRed + (2 * efc) * 21;
    const float* b = sRed + (2 * efc + 1) * 21;
    float* out = partial + (static_cast<int64_t>(p) * gridDim.x + tile) * kStats;
    out[0 * 12 + tid] = a[t] + b[t];
    out[1 * 12 + tid] = a[3 + t] + b[3 + t];
    out[2 * 12 + tid] = fminf(a[6 + t], b[6 + t]);
    out[3 * 12 + tid] = fminf(a[9 + t], b[9 + t]);
    out[4 * 12 + tid] = fmaxf(a[12 + t], b[12 + t]);
    out[5 * 12 + tid] = fmaxf(a[15 + t], b[15 + t]);
    out[6 * 12 + tid] = a[18 + t] + b[18 + t];
    out[7 * 12 + tid] = 0.0f;
  }
}

// stats[p, row, col] from the tiles' partial statistics, tiles in order.
__global__ void reduce_tiles_kernel(const float* __restrict__ partial,
                                    float* __restrict__ stats, int n_tiles) {
  const int p = blockIdx.x;
  const int i = threadIdx.x;  // row * 12 + col
  const int row = i / 12;
  const float* src = partial + static_cast<int64_t>(p) * n_tiles * kStats + i;
  float v = src[0];
  for (int t = 1; t < n_tiles; ++t) {
    const float u = src[static_cast<int64_t>(t) * kStats];
    if (row == 2 || row == 3) {
      v = fminf(v, u);
    } else if (row == 4 || row == 5) {
      v = fmaxf(v, u);
    } else {
      v += u;
    }
  }
  stats[static_cast<int64_t>(p) * kStats + i] = v;
}

template <typename T>
int launch(const void* keys, const void* hyper, const void* w1,
           const void* b1, const void* lns, const void* lnb, const void* w2,
           const void* b2, void* partial, void* stats, int P, int N, int side,
           float thr, float off, float eps, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      (kC * kXS + kKC * kC + kR * kYS + 3 * kC + 128 + 96 + 8 * 21);
  auto kern = decode_tail_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (N + kR - 1) / kR;
  kern<<<dim3(n_tiles, P), kThreads, smem, st>>>(
      static_cast<const T*>(keys), static_cast<const float*>(hyper),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(partial), N, side, thr, off, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_tiles_kernel<<<P, kStats, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys (P, N, 256) float32 or bfloat16 (is_bf16), N = side * side; hyper
// (P, 3, 32), w1 (256, 256), b1 / lns / lnb (256), w2 (64, 128), b2 (128)
// float32; partial (P, ceil(N / 64), 8, 12) float32 scratch; stats
// (P, 8, 12) float32 out.  Returns the CUDA error of the launches.
extern "C" int decode_tail_stats(const void* keys, const void* hyper,
                                 const void* w1, const void* b1,
                                 const void* lns, const void* lnb,
                                 const void* w2, const void* b2,
                                 void* partial, void* stats, int P, int N,
                                 int side, float thr, float off, float eps,
                                 int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(keys, hyper, w1, b1, lns, lnb, w2, b2,
                                 partial, stats, P, N, side, thr, off, eps, st);
  return launch<float>(keys, hyper, w1, b1, lns, lnb, w2, b2, partial, stats,
                       P, N, side, thr, off, eps, st);
}
