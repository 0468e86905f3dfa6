// Flash attention with an optional decomposed relative-position bias, on
// Hopper (sm_90a).  One source, two kernels of the JAX package:
//
//   K4  sam6d_tpu/ops/pallas/flash_rpe.py:flash_rpe_attention (BIAS = true)
//       out = softmax(q k^T / sqrt(d) + bias) v,
//       bias[n, m] = QRh[n, y(m)] + QRw[n, x(m)]   (y, x: the key's grid row
//       and column on the (h, w) token grid, row-major),
//   K5  sam6d_tpu/ops/pallas/flash_rpe.py:flash_attention (BIAS = false)
//       out = softmax(q k^T / sqrt(d)) v.
//
// The per-token tables QRh (BH, N, h) and QRw (BH, N, w) are computed by the
// wrapper with two small matmuls against the raw (2h-1, d) / (2w-1, d)
// tables, as the JAX function does outside its pallas_call; inside, the bias
// of (n, m) is read by index.  (The TPU kernel rebuilds it with one-hot
// selector matmuls, a layout trick for its matrix unit that has no purpose
// here.)  The 1/sqrt(d) scale applies to q.k only, not to the bias.
//
// What bounds it on this card: per (q-row, key) pair 4 d flops against a
// few bytes of q, k and v read once, so at N = 196..4096 the work is bound
// by operations (the tensor cores' 989 TFLOP/s in bf16).
//
// Design: one block per (batch-head, tile of 64 queries).  The block keeps
// its Q tile (and its 64 rows of QRh / QRw, float32) in shared memory for
// the whole pass and walks the keys in tiles of 64 through shared memory,
// with an online softmax (running max m, sum l) in float32.  Ragged N
// (196, 257) is handled by bounds: missing keys get -inf, missing query
// rows are computed on zeros and not stored.  No (N, N) tensor exists; the
// output is written once, in the input dtype.  Two instances:
//
// * bfloat16 (the serving path): 4 warps, each owning 16 query rows, run
//   q.k and P.v as mma.sync m16n8k16 (bf16 operands, float32
//   accumulators), the arithmetic of the TPU kernel (bf16 q, k, v and P,
//   float32 sums).  The logits stay in the mma accumulator fragments; the
//   row max and sum reduce over the 4 lanes that share a row, and the
//   probabilities, rounded to bf16, become the A fragments of P.v in
//   registers.  Tiles are bf16 rows padded by 8 elements, so the 32-bit
//   fragment loads of a warp fall in distinct banks.
// * float32 (tiny configurations, tests): 256 threads on the CUDA cores;
//   thread (ty, tx) computes logits of rows 4 ty .. 4 ty + 3 against keys
//   tx + 16 j, j < 4, from float4 loads (rows padded to d + 4 floats), and
//   accumulates rows 4 ty + i, dims tx + 16 c; the probabilities pass
//   through shared memory to the P.v product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // float32 instance: 16 x 16 threads
constexpr int kWarps = 4;      // bf16 instance: 16 query rows a warp
constexpr int kPStride = kBQ + 4;
constexpr int kMaxGrid = 64;   // largest h, w of the bias tables

template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  // rows [row0, row0 + 64) of a (N, D) matrix into dst[64][D + 4], zeros
  // beyond n_rows.
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + 4) + c] =
        row < n_rows ? src[static_cast<int64_t>(row) * D + c] : 0.0f;
  }
}

template <int DV, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ qrh,
                     const float* __restrict__ qrw, float* __restrict__ out,
                     int N, int h, int w, float scale) {
  constexpr int D = 16 * DV;
  constexpr int DS = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [64][DS]
  float* sK = sQ + kBQ * DS;     // [64][DS]
  float* sV = sK + kBK * DS;     // [64][DS]
  float* sP = sV + kBK * DS;     // [64 keys][kPStride] (transposed P)
  float* sRh = sP + kBK * kPStride;  // [64][h]
  float* sRw = sRh + kBQ * h;        // [64][w]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int64_t base = static_cast<int64_t>(bh) * N * D;

  load_tile<D>(sQ, q + base, q0, N);
  if (BIAS) {
    const float* rh = qrh + static_cast<int64_t>(bh) * N * h;
    const float* rw = qrw + static_cast<int64_t>(bh) * N * w;
    for (int idx = tid; idx < kBQ * h; idx += kThreads) {
      const int row = q0 + idx / h;
      sRh[idx] = row < N ? rh[static_cast<int64_t>(q0) * h + idx] : 0.0f;
    }
    for (int idx = tid; idx < kBQ * w; idx += kThreads) {
      const int row = q0 + idx / w;
      sRw[idx] = row < N ? rw[static_cast<int64_t>(q0) * w + idx] : 0.0f;
    }
  }

  float m_i[4], l_i[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -1e30f;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[i][c] = 0.0f;
  }

  const int n_tiles = (N + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    load_tile<D>(sK, k + base, k0, N);
    load_tile<D>(sV, v + base, k0, N);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * DS + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * DS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      int ky = 0, kx = 0;
      if (BIAS && key < N) {
        ky = key / w;
        kx = key - ky * w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val = s[i][j] * scale;
        if (BIAS) val += sRh[(4 * ty + i) * h + ky] + sRw[(4 * ty + i) * w + kx];
        s[i][j] = key < N ? val : -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(sP + (tx + 16 * j) * kPStride + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int m = 0; m < kBK; ++m) {
      const float4 p =
          *reinterpret_cast<const float4*>(sP + m * kPStride + 4 * ty);
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const float vv = sV[m * DS + tx + 16 * c];
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
    float* o = out + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int c = 0; c < DV; ++c) o[tx + 16 * c] = acc[i][c] * inv;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16) |
         __bfloat16_as_ushort(lo);
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a (N, D) bf16 matrix into dst[64][D + 8], in
// 16-byte chunks, zeros beyond n_rows.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += 32 * kWarps) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < n_rows)
      v = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

template <int DK, bool BIAS>
__global__ void __launch_bounds__(32 * kWarps)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ qrh,
                         const float* __restrict__ qrw,
                         __nv_bfloat16* __restrict__ out, int N, int h, int w,
                         float scale) {
  constexpr int D = 16 * DK;  // head dim: DK k-steps of q.k
  constexpr int DN = 2 * DK;  // n-tiles of 8 columns of P.v
  constexpr int DS = D + 8;   // padded row, bf16 elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * DS;
  __nv_bfloat16* sV = sK + kBK * DS;
  // Bias tables with rows padded by one float (the 8 rows a warp reads
  // at one key fall in distinct banks), and the grid row and column of
  // each key of the current tile.
  float* sRh = reinterpret_cast<float*>(sV + kBK * DS);  // [64][h + 1]
  float* sRw = sRh + kBQ * (h + 1);                      // [64][w + 1]
  int* sKy = reinterpret_cast<int*>(sRw + kBQ * (w + 1));  // [64]
  int* sKx = sKy + kBK;                                    // [64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  const int qr = (tid >> 5) * 16;  // the warp's first row in the tile
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int64_t base = static_cast<int64_t>(bh) * N * D;

  load_tile_bf16<D>(sQ, q + base, q0, N);
  if (BIAS) {
    const float* rh = qrh + static_cast<int64_t>(bh) * N * h;
    const float* rw = qrw + static_cast<int64_t>(bh) * N * w;
    for (int idx = tid; idx < kBQ * h; idx += 32 * kWarps) {
      const int r = idx / h;
      sRh[r * (h + 1) + idx - r * h] =
          q0 + r < N ? rh[static_cast<int64_t>(q0) * h + idx] : 0.0f;
    }
    for (int idx = tid; idx < kBQ * w; idx += 32 * kWarps) {
      const int r = idx / w;
      sRw[r * (w + 1) + idx - r * w] =
          q0 + r < N ? rw[static_cast<int64_t>(q0) * w + idx] : 0.0f;
    }
  }
  __syncthreads();

  // The warp's Q rows as A fragments, for the whole pass.
  uint32_t qa[DK][4];
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    const __nv_bfloat16* r0 = sQ + (qr + g) * DS + ks * 16 + 2 * tg;
    const __nv_bfloat16* r1 = r0 + 8 * DS;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(r0);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(r1);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float m_i[2] = {-1e30f, -1e30f};  // rows g and g + 8
  float l_i[2] = {0.0f, 0.0f};
  float o[DN][4];
#pragma unroll
  for (int nd = 0; nd < DN; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.0f;

  const int n_tiles = (N + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's sK / sV are consumed
    load_tile_bf16<D>(sK, k + base, k0, N);
    load_tile_bf16<D>(sV, v + base, k0, N);
    if (BIAS && tid < kBK) {
      const int key = min(k0 + tid, N - 1);
      sKy[tid] = key / w;
      sKx[tid] = key - (key / w) * w;
    }
    __syncthreads();

    // Logits: 8 n-tiles of 8 keys; element i of tile nt is row
    // g + 8 (i >> 1), key nt * 8 + 2 tg + (i & 1).
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * DS + 2 * tg;
#pragma unroll
      for (int ks = 0; ks < DK; ++ks)
        mma_bf16(s[nt], qa[ks],
                 *reinterpret_cast<const uint32_t*>(kr + ks * 16),
                 *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * tg + j;
        const int key = k0 + col;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = qr + g + 8 * r;
          float val = s[nt][2 * r + j] * scale;
          if (BIAS)
            val += sRh[row * (h + 1) + sKy[col]] + sRw[row * (w + 1) + sKx[col]];
          val = key < N ? val : -INFINITY;
          s[nt][2 * r + j] = val;
          mx[r] = fmaxf(mx[r], val);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m_i[i >> 1]);
        sum[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int nd = 0; nd < DN; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] *= alpha[i >> 1];

    // P.v: the probabilities of keys 16 kk .. 16 kk + 15, rounded to bf16,
    // are the A fragment of k-step kk; v's B fragments come from sV.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = sV + (16 * kk + 2 * tg) * DS + g;
#pragma unroll
      for (int nd = 0; nd < DN; ++nd) {
        const __nv_bfloat16* c = vr + nd * 8;
        mma_bf16(o[nd], pa, pack_bf16(c[0], c[DS]),
                 pack_bf16(c[8 * DS], c[9 * DS]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.0f / fmaxf(l_i[r], 1e-30f);
    __nv_bfloat16* orow = out + base + static_cast<int64_t>(row) * D + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < DN; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
  }
}

template <int DK, bool BIAS>
int launch_mma(const void* q, const void* k, const void* v, const void* qrh,
               const void* qrw, void* out, int BH, int N, int h, int w,
               float scale, cudaStream_t st) {
  size_t smem = sizeof(__nv_bfloat16) * 3 * kBQ * (16 * DK + 8);
  if (BIAS) smem += sizeof(float) * kBQ * (h + w + 2) + sizeof(int) * 2 * kBK;
  auto kern = flash_fwd_mma_kernel<DK, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBQ - 1) / kBQ, BH);
  kern<<<grid, 32 * kWarps, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(qrh),
      static_cast<const float*>(qrw), static_cast<__nv_bfloat16*>(out), N, h,
      w, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int dispatch_mma(int d, const void* q, const void* k, const void* v,
                 const void* qrh, const void* qrw, void* out, int BH, int N,
                 int h, int w, float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch_mma<1, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 32: return launch_mma<2, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 64: return launch_mma<4, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 80: return launch_mma<5, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 128: return launch_mma<8, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DV, bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* qrh,
           const void* qrw, void* out, int BH, int N, int h, int w,
           float scale, cudaStream_t st) {
  constexpr int DS = 16 * DV + 4;
  size_t smem = sizeof(float) * (3 * kBQ * DS + kBK * kPStride);
  if (BIAS) smem += sizeof(float) * kBQ * (h + w);
  auto kern = flash_fwd_kernel<DV, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBQ - 1) / kBQ, BH);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(qrh),
      static_cast<const float*>(qrw), static_cast<float*>(out), N, h, w,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* qrh, const void* qrw, void* out, int BH, int N,
               int h, int w, float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<1, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 32: return launch<2, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 64: return launch<4, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 80: return launch<5, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    case 128: return launch<8, BIAS>(q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (BH, N, d) contiguous, float32 or bfloat16 (is_bf16).
// qrh (BH, N, h) and qrw (BH, N, w) float32 with N == h * w, or both null
// for attention without bias.  d in {16, 32, 64, 80, 128}; h, w <= 64.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* qrh, const void* qrw, void* out,
                              int BH, int N, int d, int h, int w, float scale,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bias = qrh != nullptr;
  if (bias && (h > kMaxGrid || w > kMaxGrid || h * w != N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return bias ? dispatch_mma<true>(d, q, k, v, qrh, qrw, out, BH, N, h, w, scale, st)
                : dispatch_mma<false>(d, q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
  }
  return bias ? dispatch_d<true>(d, q, k, v, qrh, qrw, out, BH, N, h, w, scale, st)
              : dispatch_d<false>(d, q, k, v, qrh, qrw, out, BH, N, h, w, scale, st);
}
