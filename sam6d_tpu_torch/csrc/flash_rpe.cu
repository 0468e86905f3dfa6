// Flash attention with an optional decomposed relative-position bias, on
// Hopper (sm_90a).  One source, two kernels of the JAX package:
//
//   K4  sam6d_tpu/ops/pallas/flash_rpe.py:flash_rpe_attention (BIAS = true)
//       out = softmax(q k^T / sqrt(d) + bias) v,
//       bias[n, m] = q[n].Rh[y(n) - y(m) + h - 1] + q[n].Rw[x(n) - x(m) + w - 1]
//       (y, x: a token's row and column on the (h, w) grid, row-major),
//   K5  sam6d_tpu/ops/pallas/flash_rpe.py:flash_attention (BIAS = false)
//       out = softmax(q k^T / sqrt(d)) v.
//
// The kernel takes the raw tables Rh (2h - 1, d) and Rw (2w - 1, d) in q's
// dtype.  Each block builds the per-token tables of its own query rows,
//   QRh[n, Y] = q[n].Rh[y(n) - Y + h - 1],  QRw[n, X] = q[n].Rw[x(n) - X + w - 1],
// in shared memory (float32), so bias[n, m] = QRh[n, y(m)] + QRw[n, x(m)]
// and a K4 call is one launch.  (The JAX function builds them outside its
// pallas_call for a TPU layout reason and rebuilds the bias with one-hot
// selector matmuls on the MXU; neither is needed here.)  The 1/sqrt(d)
// scale applies to q.k only, never to the bias.
//
// What bounds it on this card: per (query, key) pair 4 d operations
// against q, k, v read once and the output written once.  At the global
// SAM blocks (16, 4096, 80) that is operations (the tensor cores' 989
// TFLOP/s in bf16: 0.090 ms); at the windowed blocks (400, 196, 80) and
// at DINOv2's 257 tokens (4096 and 128 batch-heads) it is bytes (3.35
// TB/s: 0.015, 0.161 and 0.005 ms), and in practice the few dependent
// key tiles each block walks (chip_smoke.py phase 2 computes both).
//
// bfloat16 instance (the serving path), `flash_fwd_mma_kernel<DK, MT, BIAS>`:
//
// * Block: 4 warps; warp w owns MT tiles of 16 query rows, so a block
//   holds 64 MT queries of one batch-head.  MT = 2 for the long sequences
//   (N > 1024, d <= 80: the global blocks): each K and V fragment fetched
//   from shared memory feeds two mma.sync, which halves the shared-memory
//   traffic per product.  MT = 1 for the 196-token windows (4 blocks of
//   64 rows; the fourth block runs one warp: 208 query rows computed for
//   196, against 256 in 64-row tiles), for DINOv2's 257 tokens (5 blocks,
//   the last one warp: 272 rows) and for d = 128 (registers).  Warps
//   whose rows all lie beyond N skip the arithmetic and only help with
//   the copies.
// * K/V tiles of 64 keys stream through a two-stage ring in shared memory
//   filled by cp.async.cg 16-byte copies in commit groups: tile t + 1 is
//   in flight while tile t is computed.  Rows beyond N are zero-filled by
//   the copy (src-size 0), so the ragged edge needs no branch there; a key
//   beyond N still gets -inf in the logits, never 0 + bias.  The Q tile
//   goes through the second stage before the loop and is held in
//   registers as mma A fragments for the whole pass.  cp.async rather
//   than TMA: a tensor map is made on the host for each tensor of each
//   call (a CUDA driver call apiece), and host time is most of a call's
//   time at the small shapes; the copies' zero-fill serves the ragged
//   edge as TMA's would.  A window-head's K and V (four tiles at N = 196) also
//   stream through the ring rather than being loaded whole first, so
//   tiles 1-3 arrive while tile 0 is computed.
// * Fragments: q.k and P.v are mma.sync m16n8k16 (bf16 operands, float32
//   sums, the TPU kernel's arithmetic).  K's B fragments come from
//   ldmatrix.x4 (two n-tiles of 8 keys a load), V's from ldmatrix.x4.trans
//   (two 8-column n-tiles a load) out of the row-major V tile; no scalar
//   shared loads.  Shared rows are padded to d + 8 elements, so the eight
//   16-byte rows of every ldmatrix fall in distinct banks for every d.
// * The last key tile skips each 8-key n-tile that lies wholly beyond N
//   (N = 257: one n-tile and one P.v k-step instead of eight and four;
//   N = 196: the same), with a second, guarded instance of the tile body;
//   full tiles run without guards.
// * Online softmax in float32 with exp2: log2(e) / sqrt(d) is folded into
//   the q.k scale and log2(e) into the tables.  A 64-key tile is taken in
//   two halves of 32 keys, each its own softmax step, so that only half
//   the logits are live; with two m-tiles the row sums live in shared
//   memory (a slot a thread and row); no instance spills.  Row sums stay
//   per thread and are reduced over the 4 lanes of a row once, at the
//   end.  The probabilities, rounded to bf16, become the A fragments of
//   P.v in registers.
// * Tables (K4): the block's Q fragments times Rh and Rw on the tensor
//   cores (an (64 MT x d) . (d x (2h - 1)) product a table, bf16 operands
//   loaded straight from global memory into B fragments, float32 sums),
//   each sum scattered to its (row, Y) slot.  Every warp reads only its
//   own rows' tables.  In the global blocks (w = 64 = the key tile) each
//   tile is one grid row, so QRh is read once per (row, 32-key half) and a
//   key pair costs one float2 of QRw; otherwise a pair costs two shared
//   loads, QRh at its grid row (shared by the pair when w is even) and QRw
//   as one float2.  A key's grid row is a multiply and a shift, not a
//   division.
// * wgmma: a warpgroup instance (two warpgroups, Q and P as register A
//   operands, K and V through no-swizzle descriptors; commit e5c0ce0 of
//   this file) was right at every shape but slower than this one at all
//   four main-path shapes (PERF.md).  Its 64-row warpgroup tiles pad 196
//   queries to 256 and 257 to 384, and each product was waited for before
//   the softmax, so nothing overlapped the products inside a warpgroup.
//
// float32 instance (tiny configurations, tests), `flash_fwd_kernel`: 256
// threads on the CUDA cores; thread (ty, tx) computes logits of rows
// 4 ty .. 4 ty + 3 against keys tx + 16 j, j < 4, from float4 loads (rows
// padded to d + 4 floats), and accumulates rows 4 ty + i, dims tx + 16 c;
// the probabilities pass through shared memory to the P.v product.  It
// builds its QRh / QRw rows from the raw tables on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;        // float32 instance: queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // float32 instance: 16 x 16 threads
constexpr int kPStride = kBQ + 4;
constexpr int kMaxGrid = 64;   // largest h, w of the bias tables
constexpr float kLog2e = 1.4426950408889634f;

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
                     const float* __restrict__ v,
                     const float* __restrict__ rel_h,
                     const float* __restrict__ rel_w, float* __restrict__ out,
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
    // QRh[r, Y] = q[r].Rh[y(r) - Y + h - 1] and QRw[r, X] alike, for the
    // block's rows (rows beyond N take grid position 0).
    __syncthreads();
    for (int idx = tid; idx < kBQ * (h + w); idx += kThreads) {
      const bool is_h = idx < kBQ * h;
      const int side = is_h ? h : w;
      const int j = is_h ? idx : idx - kBQ * h;
      const int r = j / side;
      const int c = j - r * side;
      const int n = q0 + r;
      const int yn = n < N ? n / w : 0;
      const int pos = n < N ? (is_h ? yn : n - yn * w) : 0;
      const float* R = (is_h ? rel_h : rel_w) +
                       static_cast<int64_t>(pos - c + side - 1) * D;
      const float* qr = sQ + r * DS;
      float acc = 0.0f;
      for (int cc = 0; cc < D; ++cc) acc = fmaf(qr[cc], R[cc], acc);
      (is_h ? sRh : sRw)[j] = acc;
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

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// rows [row0, row0 + ROWS) of a (n_rows, D) bf16 matrix into
// dst[ROWS][D + 8] with cp.async, zeros beyond n_rows; 128 threads.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % 128 == 0, "whole rounds of 128 copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / 128; ++i) {
    const int idx = threadIdx.x + 128 * i;
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(smem_addr(dst + r * (D + 8) + c),
               src + static_cast<int64_t>(ok ? row : 0) * D + c, ok);
  }
}

// QRw rows hold 32 floats (w <= 32) or 64, their 8-float groups permuted
// by the row: column X of row r lies at X ^ 8 (r & 3).  In the logits
// phase lanes 4 g .. 4 g + 3 read float2s of row g; the permutation puts
// the four rows of a half-warp in four distinct groups of 8 banks, so the
// reads meet no bank conflict (a padded row of w + 2 floats met up to
// four-way conflicts).
__host__ __device__ constexpr int qrw_stride(int w) { return w <= 32 ? 32 : 64; }

// One per-token table of the warp's rows: tbl[row][Y ^ swz (row & 3)] =
// log2(e) q[row].R[c(row) + side - 1 - Y], Y < side, from the product of
// the Q fragments with every row of R (2 side - 1 of them, read from
// global memory straight into B fragments).  c: the grid coordinate of
// each of the thread's rows (y for Rh, x for Rw); swz: 0 for QRh, 8 for
// QRw.
template <int DK, int MT>
__device__ __forceinline__ void rel_table(float* tbl, int stride, int swz,
                                          const __nv_bfloat16* R, int side,
                                          const int (&c)[MT][2],
                                          const uint32_t (&qa)[MT][DK][4],
                                          int wr, int g, int tg) {
  constexpr int D = 16 * DK;
  const int nr = 2 * side - 1;
#pragma unroll 2
  for (int r0 = 0; r0 < nr; r0 += 8) {
    const int r = r0 + g;
    uint32_t b[DK][2];
#pragma unroll
    for (int ks = 0; ks < DK; ++ks) {
      const __nv_bfloat16* p = R + static_cast<int64_t>(r) * D + ks * 16 + 2 * tg;
      b[ks][0] = r < nr ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      b[ks][1] = r < nr ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
    }
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < DK; ++ks) mma_bf16(acc[mt], qa[mt][ks], b[ks][0], b[ks][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Element i: row g + 8 (i >> 1), column r0 + 2 tg + (i & 1).
        const int Y = c[mt][i >> 1] + side - 1 - (r0 + 2 * tg + (i & 1));
        const int row = wr + 16 * mt + g + 8 * (i >> 1);
        if (Y >= 0 && Y < side)
          tbl[row * stride + (Y ^ (row & 3) * swz)] = acc[mt][i] * kLog2e;
      }
  }
}

template <int DK, int MT, bool BIAS>
__global__ void __launch_bounds__(128, (MT == 2 || DK == 8) ? 2 : 3)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ rel_h,
                         const __nv_bfloat16* __restrict__ rel_w,
                         __nv_bfloat16* __restrict__ out, int N, int h, int w,
                         float scale_log2) {
  constexpr int D = 16 * DK;   // head dim: DK k-steps of q.k
  constexpr int DN = 2 * DK;   // n-tiles of 8 columns of P.v
  constexpr int DS = D + 8;    // padded shared row, bf16 elements
  constexpr int BQ = 64 * MT;  // queries per block
  constexpr int kTile = kBK * DS;
  static_assert(BQ <= 2 * kBK, "the Q tile fits one ring stage");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Ring: stage s holds K at ring + 2 s kTile and V after it.  The Q tile
  // passes through stage 1 before the loop.  Then the tables (BIAS):
  // QRh [BQ][h + 1] and QRw [BQ][qrw_stride(w)] (permuted, see there).
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sQ = ring + 2 * kTile;
  const int hs = h + 1, wss = qrw_stride(w);
  float* sRh = reinterpret_cast<float*>(ring + 4 * kTile);
  float* sRw = sRh + BQ * hs;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  const int wr = (tid >> 5) * 16 * MT;  // the warp's first row in the block
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int64_t base = static_cast<int64_t>(bh) * N * D;
  const bool active = q0 + wr < N;  // warp-uniform
  const int n_tiles = (N + kBK - 1) / kBK;

  load_rows_async<D, BQ>(sQ, q + base, q0, N);
  cp_async_commit();
  load_rows_async<D, kBK>(ring, k + base, 0, N);
  load_rows_async<D, kBK>(ring + kTile, v + base, 0, N);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; tile 0 may still be in flight
  __syncthreads();

  // The warp's Q rows as A fragments, for the whole pass.
  uint32_t qa[MT][DK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < DK; ++ks)
      ldsm_x4(qa[mt][ks], smem_addr(sQ + (wr + 16 * mt + (lane & 15)) * DS +
                                    ks * 16 + (lane >> 4) * 8));
  __syncthreads();  // stage 1 is free for tile 1
  if (n_tiles > 1) {
    load_rows_async<D, kBK>(ring + 2 * kTile, k + base, kBK, N);
    load_rows_async<D, kBK>(ring + 3 * kTile, v + base, kBK, N);
  }
  cp_async_commit();

  if (BIAS && active) {
    int cy[MT][2], cx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = q0 + wr + 16 * mt + g + 8 * i;
        cy[mt][i] = n < N ? n / w : 0;
        cx[mt][i] = n < N ? n - (n / w) * w : 0;
      }
    rel_table<DK, MT>(sRh, hs, 0, rel_h, h, cy, qa, wr, g, tg);
    rel_table<DK, MT>(sRw, wss, 8, rel_w, w, cx, qa, wr, g, tg);
    __syncwarp();
  }

  // Running max and row sum of rows g and g + 8 of each m-tile.  With two
  // m-tiles the sums live in shared memory, one slot a thread and row
  // (touched once a sub-tile), which keeps those instances within 255
  // registers without spills.
  constexpr bool kSumsShared = MT == 2;
  float* sL = (BIAS ? sRw + BQ * wss
                    : reinterpret_cast<float*>(ring + 4 * kTile)) + tid;
  float m_i[MT][2], l_i[MT][2];
  float o[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_i[mt][r] = -1e30f;
      l_i[mt][r] = 0.0f;
      if constexpr (kSumsShared) sL[128 * (2 * mt + r)] = 0.0f;
    }
#pragma unroll
    for (int nd = 0; nd < DN; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nd][i] = 0.0f;
  }
  // A key's grid row is key / w = (key * wdiv) >> 22: exact, and within
  // 32 bits, for every key below 64 (w + 1) when w <= 64 (checked for all
  // of them), so the loop divides nothing.
  const uint32_t wdiv = BIAS ? ((1u << 22) + w - 1) / w : 0u;
  const bool w_even = (w & 1) == 0;
  const bool row_tiles = BIAS && w == kBK;  // each key tile one grid row
  const int sw = (g & 3) << 3;  // QRw's permutation for rows g, g + 8

  // One 64-key tile in sub-tiles of kSub n-tiles of 8 keys (32-key
  // halves), each its own online-softmax step: only a sub-tile's logits
  // are live, which keeps the two-m-tile instances within 255 registers.
  constexpr int kSub = 4;
  // Per-lane byte offsets of the ldmatrix rows: K (x4: two n-tiles, both
  // halves of a k-step) and V (x4.trans: both 8-key halves, two 8-column
  // n-tiles); each load adds a compile-time offset.
  const uint32_t k_lane = ((((lane >> 4) << 3) + (lane & 7)) * DS +
                           ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * DS +
                           (lane >> 4) * 8) * 2;

  auto tile_body = [&](const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                       int k0, int n_nt, auto partial_tag) {
    constexpr bool PARTIAL = decltype(partial_tag)::value;
    const uint32_t k_base = smem_addr(sK) + k_lane;
    const uint32_t v_base = smem_addr(sV) + v_lane;
#pragma unroll
    for (int hh = 0; hh < 8 / kSub; ++hh) {
      if (PARTIAL && kSub * hh >= n_nt) break;
      // Logits: element i of n-tile nt is row g + 8 (i >> 1), key
      // 8 (kSub hh + nt) + 2 tg + (i & 1) of the tile.
      float s[MT][kSub][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kSub; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < DK; ++ks) {
#pragma unroll
        for (int p = 0; p < kSub / 2; ++p) {
          const int np = kSub / 2 * hh + p;  // pair of n-tiles in the tile
          if (PARTIAL && 2 * np >= n_nt) break;
          uint32_t b[4];
          ldsm_x4(b, k_base + (16 * np * DS + ks * 16) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * p], qa[mt][ks], b[0], b[1]);
            if (!PARTIAL || 2 * np + 1 < n_nt)
              mma_bf16(s[mt][2 * p + 1], qa[mt][ks], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = wr + 16 * mt + g + 8 * r;
          const float* rh = sRh + lr * hs;
          const float* rw = sRw + lr * wss;
          // One grid row a tile (w = 64): its QRh value, read once.
          const float rh_tile = row_tiles ? rh[k0 >> 6] : 0.0f;
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kSub; ++nt) {
            const int ng = kSub * hh + nt;  // n-tile in the tile
            if (PARTIAL && ng >= n_nt) break;
            float b0 = 0.0f, b1 = 0.0f;
            if (BIAS && row_tiles) {  // x is the key's place in the tile
              const float2 bw = *reinterpret_cast<const float2*>(
                  rw + ((8 * ng + 2 * tg) ^ sw));
              b0 = rh_tile + bw.x;
              b1 = rh_tile + bw.y;
            } else if (BIAS) {
              const int key = k0 + 8 * ng + 2 * tg;
              int y = static_cast<int>((static_cast<uint32_t>(key) * wdiv) >> 22);
              const int x = key - y * w;
              if (w_even) {  // the pair shares its grid row
                if (PARTIAL) y = min(y, h - 1);
                const float2 bw =
                    *reinterpret_cast<const float2*>(rw + (x ^ sw));
                b0 = rh[y] + bw.x;
                b1 = rh[y] + bw.y;
              } else {
                int y1 = y, x1 = x + 1;
                if (x1 == w) {
                  x1 = 0;
                  ++y1;
                }
                if (PARTIAL) {
                  y = min(y, h - 1);
                  y1 = min(y1, h - 1);
                }
                b0 = rh[y] + rw[x ^ sw];
                b1 = rh[y1] + rw[x1 ^ sw];
              }
            }
            float v0 = fmaf(s[mt][nt][2 * r], scale_log2, b0);
            float v1 = fmaf(s[mt][nt][2 * r + 1], scale_log2, b1);
            if (PARTIAL) {
              const int key = k0 + 8 * ng + 2 * tg;
              if (key >= N) v0 = -INFINITY;
              if (key + 1 >= N) v1 = -INFINITY;
            }
            s[mt][nt][2 * r] = v0;
            s[mt][nt][2 * r + 1] = v1;
            mx = fmaxf(mx, fmaxf(v0, v1));
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_i[mt][r], mx);
          const float alpha = fast_exp2(m_i[mt][r] - m_new);
          m_i[mt][r] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int nt = 0; nt < kSub; ++nt) {
            if (PARTIAL && kSub * hh + nt >= n_nt) break;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float p = fast_exp2(s[mt][nt][2 * r + j] - m_new);
              s[mt][nt][2 * r + j] = p;
              sum += p;
            }
          }
          if constexpr (kSumsShared)
            sL[128 * (2 * mt + r)] = sL[128 * (2 * mt + r)] * alpha + sum;
          else
            l_i[mt][r] = l_i[mt][r] * alpha + sum;
#pragma unroll
          for (int nd = 0; nd < DN; ++nd) {
            o[mt][nd][2 * r] *= alpha;
            o[mt][nd][2 * r + 1] *= alpha;
          }
        }
      }
      // P.v: the probabilities of 16 keys, rounded to bf16, are the A
      // fragment of a k-step; V's B fragments come from ldmatrix.trans,
      // two 8-column n-tiles a load.
#pragma unroll
      for (int kk = 0; kk < kSub / 2; ++kk) {
        const int kg = kSub / 2 * hh + kk;  // k-step in the tile
        if (PARTIAL && 2 * kg >= n_nt) break;
        const bool hi = !PARTIAL || 2 * kg + 1 < n_nt;
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = hi ? pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]) : 0u;
          pa[mt][3] = hi ? pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]) : 0u;
        }
#pragma unroll
        for (int p = 0; p < DK; ++p) {
          uint32_t b[4];
          ldsm_x4_trans(b, v_base + (16 * kg * DS + 16 * p) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * p], pa[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * p + 1], pa[mt], b[2], b[3]);
          }
        }
      }
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const __nv_bfloat16* sK = ring + 2 * st * kTile;
    cp_async_wait<1>();  // tile t has landed; tile t + 1 may be in flight
    __syncthreads();
    if (active) {
      const int k0 = t * kBK;
      const int n_nt = min(8, (N - k0 + 7) >> 3);
      if (k0 + kBK <= N)
        tile_body(sK, sK + kTile, k0, 8, std::false_type{});
      else
        tile_body(sK, sK + kTile, k0, n_nt, std::true_type{});
    }
    __syncthreads();  // every warp is done with stage st
    if (t + 2 < n_tiles) {
      load_rows_async<D, kBK>(ring + 2 * st * kTile, k + base, (t + 2) * kBK, N);
      load_rows_async<D, kBK>(ring + (2 * st + 1) * kTile, v + base, (t + 2) * kBK, N);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = kSumsShared ? sL[128 * (2 * mt + r)] : l_i[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + wr + 16 * mt + g + 8 * r;
      if (row >= N) continue;
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      __nv_bfloat16* orow = out + base + static_cast<int64_t>(row) * D + 2 * tg;
#pragma unroll
      for (int nd = 0; nd < DN; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8) =
            pack_bf16(o[mt][nd][2 * r] * inv, o[mt][nd][2 * r + 1] * inv);
    }
}

// Lets `kern` take up to `bytes` of dynamic shared memory.  The attribute
// is set once per device, at the most any call of the instance takes (a
// launch only checks its own size against it), so a launch makes one
// runtime call fewer.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int DK, int MT, bool BIAS>
int launch_mma(const void* q, const void* k, const void* v, const void* rh,
               const void* rw, void* out, int BH, int N, int h, int w,
               cudaStream_t st) {
  constexpr int D = 16 * DK;
  constexpr int BQ = 64 * MT;
  auto smem_for = [](int h, int w) {
    size_t b = sizeof(__nv_bfloat16) * 4 * kBK * (D + 8);
    if (BIAS) b += sizeof(float) * BQ * (h + 1 + qrw_stride(w));
    if (MT == 2) b += sizeof(float) * 128 * 4;  // the row sums
    return b;
  };
  const size_t smem = smem_for(h, w);
  auto kern = flash_fwd_mma_kernel<DK, MT, BIAS>;
  static std::atomic<unsigned> allowed{0};
  cudaError_t err = allow_smem(kern, smem_for(kMaxGrid, kMaxGrid), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  dim3 grid((N + BQ - 1) / BQ, BH);
  kern<<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(rh),
      static_cast<const __nv_bfloat16*>(rw), static_cast<__nv_bfloat16*>(out), N,
      h, w, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Two m-tiles a warp for the long sequences at d <= 80 (the global SAM
// blocks), one for the 196-token windows, N <= 1024 and d = 128.
template <int DK, bool BIAS>
int launch_bf16(const void* q, const void* k, const void* v, const void* rh,
                const void* rw, void* out, int BH, int N, int h, int w,
                cudaStream_t st) {
  if constexpr (DK <= 5) {
    if (N > 1024)
      return launch_mma<DK, 2, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
  }
  return launch_mma<DK, 1, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
}

template <bool BIAS>
int dispatch_mma(int d, const void* q, const void* k, const void* v,
                 const void* rh, const void* rw, void* out, int BH, int N,
                 int h, int w, cudaStream_t st) {
  switch (d) {
    case 16: return launch_bf16<1, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 32: return launch_bf16<2, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 64: return launch_bf16<4, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 80: return launch_bf16<5, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 128: return launch_bf16<8, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DV, bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* rh,
           const void* rw, void* out, int BH, int N, int h, int w,
           cudaStream_t st) {
  constexpr int DS = 16 * DV + 4;
  auto smem_for = [](int h, int w) {
    size_t b = sizeof(float) * (3 * kBQ * DS + kBK * kPStride);
    if (BIAS) b += sizeof(float) * kBQ * (h + w);
    return b;
  };
  const size_t smem = smem_for(h, w);
  auto kern = flash_fwd_kernel<DV, BIAS>;
  static std::atomic<unsigned> allowed{0};
  cudaError_t err = allow_smem(kern, smem_for(kMaxGrid, kMaxGrid), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBQ - 1) / kBQ, BH);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rh),
      static_cast<const float*>(rw), static_cast<float*>(out), N, h, w,
      1.0f / sqrtf(static_cast<float>(16 * DV)));
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* rh, const void* rw, void* out, int BH, int N,
               int h, int w, cudaStream_t st) {
  switch (d) {
    case 16: return launch<1, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 32: return launch<2, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 64: return launch<4, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 80: return launch<5, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    case 128: return launch<8, BIAS>(q, k, v, rh, rw, out, BH, N, h, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (BH, N, d) contiguous, float32 or bfloat16 (is_bf16).
// rel_h (2h - 1, d) and rel_w (2w - 1, d) in q's dtype with N == h * w,
// or both null for attention without bias.  d in {16, 32, 64, 80, 128};
// h, w <= 64.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* rel_h, const void* rel_w, void* out,
                              int BH, int N, int d, int h, int w, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bias = rel_h != nullptr;
  if (bias && (h > kMaxGrid || w > kMaxGrid || h * w != N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return bias ? dispatch_mma<true>(d, q, k, v, rel_h, rel_w, out, BH, N, h, w, st)
                : dispatch_mma<false>(d, q, k, v, rel_h, rel_w, out, BH, N, h, w, st);
  }
  return bias ? dispatch_d<true>(d, q, k, v, rel_h, rel_w, out, BH, N, h, w, st)
              : dispatch_d<false>(d, q, k, v, rel_h, rel_w, out, BH, N, h, w, st);
}
