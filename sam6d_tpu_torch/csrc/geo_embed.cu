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
// flops per byte).
//
// Two instances.  bfloat16, the serving and training dtype, runs its
// products on the tensor cores (geo_embed_fwd_mma_kernel, below the
// backward's helpers, which it shares).  float32 keeps the CUDA-core
// design that follows: one block of d threads (one output channel each)
// per tile of 64 pairs.  Each thread holds its Md and Ma columns (68
// floats) in registers for the whole tile.  The block first runs the four
// recurrences of every pair of the tile (1 distance + 3 angles) into
// shared memory, then each thread walks the pairs, reading each basis
// vector as a shared-memory broadcast, takes the max over k in registers,
// and writes its channel of the output row.  In both, the (B, N, N, k, d)
// angle tensor and the bases never touch device memory.
//
// The recurrence and the normalisation use explicitly rounded operations
// (no FMA contraction) in the order of the plain version, so the bases are
// bit-identical to it; only the dot-product summation order differs.
//
// For training the forward also writes the winners: one byte per (pair,
// channel) whose bit k is set where e_k reaches the max (several bits at
// an exact tie).  The backward reads them instead of rebuilding e_k.  The
// serving call passes no winners buffer; its embedding is the same, bit
// for bit.

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

// The float32 instance's bases: the plain version's rounded recurrence.
template <int P>
__device__ __forceinline__ void cheb_basis(float raw, float scale,
                                           float* dst) {
  float x = __fsub_rn(__fmul_rn(raw, scale), 1.0f);
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  const float x2 = __fmul_rn(2.0f, x);
  float tp = 1.0f;
  float tc = x;
  dst[0] = tp;
  dst[1] = tc;
#pragma unroll
  for (int p = 2; p < P; ++p) {
    const float tn = __fsub_rn(__fmul_rn(x2, tc), tp);
    tp = tc;
    tc = tn;
    dst[p] = tc;
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

__global__ void __launch_bounds__(256)
    geo_embed_fwd_kernel(const float* __restrict__ d_idx,
                         const float* __restrict__ a_idx,
                         const float* __restrict__ md_g,
                         const float* __restrict__ ma_g,
                         const float* __restrict__ bias, float* __restrict__ out,
                         uint8_t* __restrict__ win, int64_t n_pairs, int d,
                         float scale_d, float scale_a) {
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
      cheb_basis<kPd>(d_idx[p0 + pr], scale_d, dst);
    } else {
      cheb_basis<kPa>(a_idx[(p0 + pr) * kK + (f - 1)], scale_a,
                      dst + kPd + (f - 1) * kPa);
    }
  }

  const int c = tid;  // blockDim.x == d
  float md[kPd];
  float ma[kPa];
#pragma unroll
  for (int p = 0; p < kPd; ++p) md[p] = md_g[p * d + c];
#pragma unroll
  for (int p = 0; p < kPa; ++p) ma[p] = ma_g[p * d + c];
  const float bc = bias[c];
  __syncthreads();

  for (int pr = 0; pr < npr; ++pr) {
    const float* b = s_basis + pr * kStride;
    const float acc = dot_basis<kPd>(b, md);
    float e[kK];
    float amax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      e[kk] = dot_basis<kPa>(b + kPd + kk * kPa, ma);
      amax = fmaxf(amax, e[kk]);
    }
    out[(p0 + pr) * d + c] = __fadd_rn(__fadd_rn(acc, amax), bc);
    if (win != nullptr) {
      unsigned bits = 0;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) bits |= (e[kk] == amax ? 1u : 0u) << kk;
      win[(p0 + pr) * d + c] = static_cast<uint8_t>(bits);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.  Replaces the TPU kernel sam6d_tpu/ops/pallas/geo_embed.py:
// _geo_embed_bwd_call (kernel _bwd_kernel), reached through _vjp_bwd:
//
//   dMd[p, c]  = sum over pairs of T(xd)[p] * g[c]
//   dMa[p, c]  = sum over pairs and k of T(xa_k)[p] * G_k[c],
//                G_k[c] = g[c] / popcount(win[c]) where bit k of win[c]
//                is set, else 0
//   dbias[c]   = sum over pairs of g[c]   (= dMd[0, c]: T_0 = 1)
//
// win is the forward's record of the k that reached the max (K2 writes it
// when the embedding is trained), so the even tie split of jnp.max's VJP
// (geo_embed.py:158-176) needs no rebuild of e_k here.  In bfloat16 the
// bases, g and each share are bfloat16, as the Pallas kernel rounds them
// (geo_embed.py:132-133, 165-168), and the products run on mma.sync
// m16n8k16 with float32 sums; in float32 every operand is split into
// bfloat16 hi and lo and the four partial products are summed, which keeps
// float32 accuracy.
//
// What bounds it on this card: bytes.  Per pair 2 d bytes of g (bf16) and
// d bytes of winners against 2 (40 + 3 x 28) d flops on the tensor cores,
// ~80 flops a byte, far below the card's ~295: about 1.7 GB at the
// training shape (56 x 197 x 197 pairs, d = 256), 0.5 ms at 3.35 TB/s.
//
// Design: the products are dMd = Td^T (40 x pairs) . g (pairs x d) and
// dMa = sum_k Ta_k^T . G_k, the pairs as the reduction dimension.  A fixed
// grid of blocks (d threads; warp w owns channels 32 w .. 32 w + 31, four
// n-tiles) walks the 64-pair tiles in a grid-stride loop.  A tile's index
// fields, g and winners come in by cp.async, one tile ahead (two stages).
// The block builds the tile's Chebyshev bases (40 + 3 x 28 recurrences a
// pair, in the plain version's rounded order) into a bf16 [basis][pair]
// tile in shared memory (rows padded to 48 and 3 x 32 with zeros), whose
// ldmatrix fragments are the A operands.  In bfloat16 g's B fragments
// come from the [pair][channel] tile by ldmatrix.trans, and each share
// fragment G_k is g's packed pair masked by the winner bits (an exact tie
// divides its element by the popcount first, on a rarely taken branch);
// in float32 the lanes read their fragments' values as scalars and split
// them.  3 + 3 x 2 mma per n-tile and k-step go into 80 float32
// accumulators, kept for all of the block's tiles.  Each
// block writes its partial sums to its own scratch row; a second kernel
// adds the rows in block order.  No float atomics: the result is the same
// on every run.  No (pairs, k, d) tensor and no basis reaches device
// memory.

constexpr int kRows = kPd + kPa + 1;  // dMd rows, dMa rows, dbias
constexpr int kBT = 64;               // pairs of a backward tile
constexpr int kBS = kBT + 8;          // bf16 row stride of the basis tile
constexpr int kTdRows = 48;           // Td rows padded to 3 m-tiles
constexpr int kTaRows = 32;           // each Ta_k padded to 2 m-tiles
constexpr int kBasisRows = kTdRows + kK * kTaRows;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Up to 16 bytes global -> shared, asynchronously; zeros past src_bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
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

// bf16 hi = rn(x) and lo = rn(x - hi) of two floats, the first in the low
// half (the lower k of a fragment).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Shared-memory layout of the backward, per stage: the tile's index
// fields (64 + 192 floats), g [64][d + pad] and winners [64][d + 16]; then
// the basis tile(s) [kBasisRows][kBS] bf16 (hi, and lo in float32).
template <typename T>
struct BwdLayout {
  static constexpr bool kF32 = sizeof(T) == 4;
  int g_stride, w_stride, stage_bytes, idx_bytes, g_bytes;
  __host__ __device__ explicit BwdLayout(int d) {
    // Row strides of 16 mod 64 bytes: a lane's four pair rows of a B
    // fragment fall in distinct banks.
    g_stride = kF32 ? d + 4 : d + 8;
    w_stride = d + 16;
    idx_bytes = (kBT + kK * kBT) * 4;
    g_bytes = kBT * g_stride * static_cast<int>(sizeof(T));
    stage_bytes = idx_bytes + g_bytes + kBT * w_stride;
  }
  __host__ __device__ int basis_bytes() const {
    return (kF32 ? 2 : 1) * kBasisRows * kBS * 2;
  }
  __host__ __device__ int total() const {
    return 2 * stage_bytes + basis_bytes();
  }
};

template <typename T>
__device__ __forceinline__ void fetch_tile(unsigned char* stage,
                                           const BwdLayout<T>& L,
                                           const float* d_idx,
                                           const float* a_idx, const T* g,
                                           const uint8_t* win,
                                           int64_t n_pairs, int64_t p0,
                                           int d, int tid, int nthreads) {
  const int64_t npr = n_pairs - p0 < kBT ? n_pairs - p0 : kBT;
  // Index fields: 16 chunks of d_idx, 48 of a_idx, zeros past the end.
  for (int i = tid; i < 64; i += nthreads) {
    const bool is_d = i < 16;
    const int ci = is_d ? i : i - 16;
    const int64_t n_bytes = (is_d ? npr : kK * npr) * 4;
    const int64_t off = static_cast<int64_t>(ci) * 16;
    const int64_t left = n_bytes - off;
    const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
    const char* src = is_d ? reinterpret_cast<const char*>(d_idx + p0)
                           : reinterpret_cast<const char*>(a_idx + kK * p0);
    cp_async16(smem_addr(stage + (is_d ? 0 : kBT * 4) + off),
               bytes ? src + off : src, bytes);
  }
  // g rows, then winner rows, 16 bytes a chunk.
  unsigned char* gs = stage + L.idx_bytes;
  unsigned char* ws = gs + L.g_bytes;
  const int g_chunks = d * static_cast<int>(sizeof(T)) / 16;
  const int w_chunks = d / 16;
  const int per_row = g_chunks + w_chunks;
  for (int i = tid; i < kBT * per_row; i += nthreads) {
    const int r = i / per_row;
    const int c = i - r * per_row;
    const bool valid = r < npr;
    const int64_t row = valid ? p0 + r : 0;
    if (c < g_chunks) {
      cp_async16(smem_addr(gs + (r * L.g_stride) * sizeof(T) + c * 16),
                 reinterpret_cast<const char*>(g + row * d) + c * 16,
                 valid ? 16 : 0);
    } else {
      const int cw = c - g_chunks;
      cp_async16(smem_addr(ws + r * L.w_stride + cw * 16),
                 win + row * d + cw * 16, valid ? 16 : 0);
    }
  }
}

// float32: the B fragment values of one lane for n-tile j at k-step ks,
// read as scalars: g at pairs 16 ks + {2q, 2q + 1, 2q + 8, 2q + 9} of
// channel col, and the three shares G_k, as bf16 hi and lo fragments.
struct BFrag {
  uint32_t g_hi[2], g_lo[2];
  uint32_t s_hi[kK][2], s_lo[kK][2];
};

__device__ __forceinline__ void b_fragments_f32(BFrag& f, const float* gs,
                                                const uint8_t* ws,
                                                int g_stride, int w_stride,
                                                int pr0, int col) {
  float gv[4];
  unsigned bits[4];
  float share[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pr = pr0 + (i & 1) + (i >> 1) * 8;
    gv[i] = gs[pr * g_stride + col];
    bits[i] = ws[pr * w_stride + col];
    share[i] = gv[i];
    const int cnt = __popc(bits[i]);
    if (cnt > 1) share[i] = __fdiv_rn(gv[i], static_cast<float>(cnt));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    split2(gv[2 * h], gv[2 * h + 1], f.g_hi[h], f.g_lo[h]);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float s0 = (bits[2 * h] >> kk) & 1u ? share[2 * h] : 0.0f;
      const float s1 = (bits[2 * h + 1] >> kk) & 1u ? share[2 * h + 1] : 0.0f;
      split2(s0, s1, f.s_hi[kk][h], f.s_lo[kk][h]);
    }
  }
}

// bfloat16: a packed pair of g values (the low half the lower pair) and
// their winner bytes w = bits_lo | bits_hi << 16.  Where a byte has more
// than one bit (an exact tie) its element becomes rn(g / popcount); the
// other elements are their own share, as is.
__device__ __forceinline__ bool has_tie(uint32_t w) {
  return ((w & (w >> 1)) | (w & (w >> 2))) & 0x00070007u;
}

__device__ __forceinline__ uint32_t tie_shares(uint32_t g, uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&g);
  const int c0 = __popc(w & 0xffu), c1 = __popc(w >> 16);
  float lo = __low2float(v), hi = __high2float(v);
  if (c0 > 1) lo = __fdiv_rn(lo, static_cast<float>(c0));
  if (c1 > 1) hi = __fdiv_rn(hi, static_cast<float>(c1));
  v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The share fragment register of branch k: each half kept where its
// winner byte has bit k, else zero.
__device__ __forceinline__ uint32_t share_k(uint32_t s, uint32_t w, int k) {
  return s & (((w >> k) & 0x00010001u) * 0xffffu);
}

// One Chebyshev basis of a pair into column pr of the basis tile(s):
// rows row0 .. row0 + P - 1, the plain version's rounded recurrence.
template <typename T, int P>
__device__ __forceinline__ void cheb_rows(float raw, float scale, bool valid,
                                          __nv_bfloat16* hi,
                                          __nv_bfloat16* lo, int row0,
                                          int pr) {
  float x = __fsub_rn(__fmul_rn(raw, scale), 1.0f);
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  const float x2 = __fmul_rn(2.0f, x);
  float tp = 1.0f;
  float tc = x;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v;
    if (p == 0) {
      v = tp;
    } else if (p == 1) {
      v = tc;
    } else {
      const float tn = __fsub_rn(__fmul_rn(x2, tc), tp);
      tp = tc;
      tc = tn;
      v = tc;
    }
    v = valid ? v : 0.0f;
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[(row0 + p) * kBS + pr] = h;
    if (lo != nullptr) {
      lo[(row0 + p) * kBS + pr] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1)
    geo_embed_bwd_kernel(const float* __restrict__ d_idx,
                         const float* __restrict__ a_idx,
                         const uint8_t* __restrict__ win,
                         const T* __restrict__ g, float* __restrict__ partial,
                         int64_t n_pairs, int d, float scale_d,
                         float scale_a) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdLayout<T> L(d);
  __nv_bfloat16* basis_hi =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * L.stage_bytes);
  __nv_bfloat16* basis_lo = kF32 ? basis_hi + kBasisRows * kBS : nullptr;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int r0 = lane >> 2;

  // The padding rows of the basis tile stay zero.
  for (int i = tid; i < kBasisRows * kBS; i += nthreads) {
    basis_hi[i] = __float2bfloat16_rn(0.0f);
    if (kF32) basis_lo[i] = __float2bfloat16_rn(0.0f);
  }

  float acc_d[3][4][4];  // [m-tile][n-tile][fragment]
  float acc_a[2][4][4];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_d[m][j][e] = 0.0f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_a[m][j][e] = 0.0f;

  const int64_t n_tiles = (n_pairs + kBT - 1) / kBT;
  int64_t tile = blockIdx.x;
  if (tile < n_tiles)
    fetch_tile<T>(smem_raw, L, d_idx, a_idx, g, win, n_pairs, tile * kBT, d,
                  tid, nthreads);
  cp_async_commit();

  const uint32_t a_off = ((lane & 15) * kBS + (lane >> 4) * 8) * 2;
  // ldmatrix.trans rows of g (bf16): pair (lane % 8) + 8 ((lane / 8) % 2),
  // channel 32 w + 8 (lane / 16): the B fragments of two n-tiles.
  const uint32_t g_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t g_lane_off =
      (g_row * L.g_stride + 32 * warp + 8 * (lane >> 4)) * 2;
  const uint32_t bh_base = smem_addr(basis_hi) + a_off;
  const uint32_t bl_base = kF32 ? smem_addr(basis_lo) + a_off : 0u;

  for (int st = 0; tile < n_tiles; tile += gridDim.x, st ^= 1) {
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      fetch_tile<T>(smem_raw + (st ^ 1) * L.stage_bytes, L, d_idx, a_idx, g, win, n_pairs,
                    next * kBT, d, tid, nthreads);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();

    const int64_t p0 = tile * kBT;
    const int npr = static_cast<int>(n_pairs - p0 < kBT ? n_pairs - p0 : kBT);
    unsigned char* stage = smem_raw + st * L.stage_bytes;
    const float* s_idx = reinterpret_cast<const float*>(stage);
    for (int task = tid; task < (1 + kK) * kBT; task += nthreads) {
      const int f = task / kBT;  // 0: distance; 1..3: angle k
      const int pr = task - f * kBT;
      const bool valid = pr < npr;
      if (f == 0) {
        cheb_rows<T, kPd>(s_idx[pr], scale_d, valid, basis_hi, basis_lo, 0,
                          pr);
      } else {
        cheb_rows<T, kPa>(s_idx[kBT + pr * kK + f - 1], scale_a, valid,
                          basis_hi, basis_lo, kTdRows + (f - 1) * kTaRows, pr);
      }
    }
    __syncthreads();

    const T* gs = reinterpret_cast<const T*>(stage + L.idx_bytes);
    const uint8_t* ws = stage + L.idx_bytes + L.g_bytes;
    const uint32_t g_lane = smem_addr(gs) + g_lane_off;
#pragma unroll 2
    for (int ks = 0; ks < kBT / 16; ++ks) {
      uint32_t ad[3][4], aa[kK][2][4];
      uint32_t adl[3][4], aal[kK][2][4];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const uint32_t o = (16 * m * kBS) * 2 + ks * 32;
        ldsm_x4(ad[m], bh_base + o);
        if (kF32) ldsm_x4(adl[m], bl_base + o);
      }
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint32_t o =
              ((kTdRows + kk * kTaRows + 16 * m) * kBS) * 2 + ks * 32;
          ldsm_x4(aa[kk][m], bh_base + o);
          if (kF32) ldsm_x4(aal[kk][m], bl_base + o);
        }
      if constexpr (kF32) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          BFrag f;
          b_fragments_f32(f, reinterpret_cast<const float*>(gs), ws,
                          L.g_stride, L.w_stride, 16 * ks + 2 * q,
                          32 * warp + 8 * j + r0);
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            mma_bf16(acc_d[m][j], adl[m], f.g_lo[0], f.g_lo[1]);
            mma_bf16(acc_d[m][j], adl[m], f.g_hi[0], f.g_hi[1]);
            mma_bf16(acc_d[m][j], ad[m], f.g_lo[0], f.g_lo[1]);
            mma_bf16(acc_d[m][j], ad[m], f.g_hi[0], f.g_hi[1]);
          }
#pragma unroll
          for (int kk = 0; kk < kK; ++kk)
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(acc_a[m][j], aal[kk][m], f.s_lo[kk][0], f.s_lo[kk][1]);
              mma_bf16(acc_a[m][j], aal[kk][m], f.s_hi[kk][0], f.s_hi[kk][1]);
              mma_bf16(acc_a[m][j], aa[kk][m], f.s_lo[kk][0], f.s_lo[kk][1]);
              mma_bf16(acc_a[m][j], aa[kk][m], f.s_hi[kk][0], f.s_hi[kk][1]);
            }
        }
      } else {
        // g's B fragments straight from the [pair][channel] tile
        // (ldmatrix.trans: two n-tiles a load); the shares by masking
        // the packed pairs with their winner bits.
        const int pr = 16 * ks + 2 * q;
        const uint8_t* w_r = ws + pr * L.w_stride + 32 * warp + r0;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t gb[4];
          ldsm_x4_trans(gb, g_lane + ks * 16 * L.g_stride * 2 + j * 16);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int n = j + jj;
            const uint8_t* wp = w_r + 8 * n;
            const uint32_t g0 = gb[2 * jj], g1 = gb[2 * jj + 1];
            const uint32_t w0 = wp[0] | (uint32_t(wp[L.w_stride]) << 16);
            const uint32_t w1 =
                wp[8 * L.w_stride] | (uint32_t(wp[9 * L.w_stride]) << 16);
            const uint32_t s0 = has_tie(w0) ? tie_shares(g0, w0) : g0;
            const uint32_t s1 = has_tie(w1) ? tie_shares(g1, w1) : g1;
#pragma unroll
            for (int m = 0; m < 3; ++m) mma_bf16(acc_d[m][n], ad[m], g0, g1);
#pragma unroll
            for (int kk = 0; kk < kK; ++kk) {
              const uint32_t b0 = share_k(s0, w0, kk);
              const uint32_t b1 = share_k(s1, w1, kk);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma_bf16(acc_a[m][n], aa[kk][m], b0, b1);
            }
          }
        }
      }
    }
    __syncthreads();  // the basis tile and this stage are free again
  }
  cp_async_wait<0>();

  // Partial sums: fragment (m-tile, n-tile, e) holds row 16 m + r0 (+ 8
  // for e >= 2), channel 32 w + 8 j + 2 q + (e & 1).
  float* out = partial + static_cast<int64_t>(blockIdx.x) * kRows * d;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 32 * warp + 8 * j + 2 * q + (e & 1);
      const int rr = r0 + (e >> 1) * 8;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int row = 16 * m + rr;
        if (row < kPd) out[row * d + c] = acc_d[m][j][e];
        if (row == 0) out[(kPd + kPa) * d + c] = acc_d[m][j][e];
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row = 16 * m + rr;
        if (row < kPa) out[(kPd + row) * d + c] = acc_a[m][j][e];
      }
    }
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

template <typename T>
int launch_bwd(const void* d_idx, const void* a_idx, const void* win,
               const void* g, void* partial, void* dmd, void* dma,
               void* dbias, long long n_pairs, int d, float scale_d,
               float scale_a, int nblocks, cudaStream_t st) {
  const BwdLayout<T> L(d);
  const int smem = L.total();
  static int attr_bytes = 0;  // the largest size set so far
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        geo_embed_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = smem;
  }
  geo_embed_bwd_kernel<T><<<nblocks, d, smem, st>>>(
      static_cast<const float*>(d_idx), static_cast<const float*>(a_idx),
      static_cast<const uint8_t*>(win), static_cast<const T*>(g),
      static_cast<float*>(partial), n_pairs, d, scale_d, scale_a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int total = kRows * d;
  geo_embed_bwd_fold<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dmd),
      static_cast<float*>(dma), static_cast<float*>(dbias), nblocks, d);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bfloat16 forward on the tensor cores.
//
// The products are out = Tb . M with Tb the tile's bases, pairs as rows
// ([pair][basis] bf16 in shared memory: Td in columns 0..47, Ta_k in
// 48 + 32 k .. + 31, the padding zero) and M^T as [channel][basis] (Md^T in
// columns 0..47, Ma^T in 48..79, zero padded), both read by ldmatrix as
// the A and B fragments of mma.sync m16n8k16.  The accumulators of Td . Md
// and of each Ta_k . Ma sit in the same lanes and fragment positions, so
// the max over k, its winner bits, + bias and the cast are an epilogue in
// registers.  The instance that writes the winners (kWinners) adds only
// the bits: the embedding's arithmetic is the same in both instances, so
// the serving output equals the training call's bit for bit.  The bases
// are the plain version's rounded recurrences and bf16 x bf16 products
// are exact in float32, so only the order of the float32 sums differs
// from it.
//
// What bounds it: bytes.  Per pair 2 d bytes of output (+ d of winners)
// against 2 x 144 x d flops on the tensor cores, ~144 flops a byte, below
// the card's ~295: 1.66 GB at the training shape with the winners.
//
// Design: a persistent grid (two blocks of d threads an SM) walks 32-pair
// tiles; warp w owns channels 32 w .. 32 w + 31 (four n-tiles) and runs the
// tile's two m-tiles in turn.  A tile's index fields come in by cp.async
// one tile ahead; the block builds the tile's bases (128 recurrences, one
// thread each) while the other block on the SM multiplies.  The epilogue
// writes the bf16 tile and the winners tile to a staging buffer in shared
// memory (rows padded 16 bytes: no bank conflicts), and the block copies
// it out with 16-byte stores, each output row's in order across the
// threads: the tile is one contiguous run of device memory (one
// cp.async.bulk a row measured slower, most of all with the winners).  M^T
// and the bias stay for the block's life.

constexpr int kFT = 32;   // pairs of a forward tile (two m-tiles)
constexpr int kFS = 152;  // bf16 row stride of the basis tile (144 used)
constexpr int kMS = 88;   // bf16 row stride of M^T (80 used)
constexpr int kIdxStage = kFT + kK * kFT;  // floats of a tile's index fields
static_assert(kTdRows + kK * kTaRows <= kFS, "basis row");
static_assert(kTdRows + kTaRows <= kMS, "M^T row");

struct FwdLayout {
  int o_stride, w_stride;  // staging row strides, bytes
  int basis_off, mt_off, o_off, w_off, total;
  __host__ __device__ explicit FwdLayout(int d) {
    o_stride = 2 * d + 16;
    w_stride = d + 16;
    basis_off = 2 * kIdxStage * 4;  // two stages of index fields
    mt_off = basis_off + kFT * kFS * 2;
    o_off = mt_off + d * kMS * 2;
    w_off = o_off + kFT * o_stride;
    total = w_off + kFT * w_stride;
  }
};

// The index fields of a forward tile: 8 chunks of d_idx, 24 of a_idx.
__device__ __forceinline__ void fetch_idx(float* stage, const float* d_idx,
                                          const float* a_idx, int64_t n_pairs,
                                          int64_t p0, int tid) {
  if (tid >= 32) return;
  const int64_t npr = n_pairs - p0 < kFT ? n_pairs - p0 : kFT;
  const bool is_d = tid < 8;
  const int ci = is_d ? tid : tid - 8;
  const int64_t n_bytes = (is_d ? npr : kK * npr) * 4;
  const int64_t off = static_cast<int64_t>(ci) * 16;
  const int64_t left = n_bytes - off;
  const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
  const char* src = is_d ? reinterpret_cast<const char*>(d_idx + p0)
                         : reinterpret_cast<const char*>(a_idx + kK * p0);
  cp_async16(smem_addr(reinterpret_cast<char*>(stage) + (is_d ? 0 : kFT * 4) +
                       off),
             bytes ? src + off : src, bytes);
}

// One Chebyshev basis into a row of the basis tile, in the plain version's
// rounded order, two bf16 values a store.
template <int P>
__device__ __forceinline__ void cheb_row(float raw, float scale,
                                         __nv_bfloat16* dst) {
  float x = __fsub_rn(__fmul_rn(raw, scale), 1.0f);
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  const float x2 = __fmul_rn(2.0f, x);
  float tp = 1.0f;
  float tc = x;
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __floats2bfloat162_rn(tp, tc);
#pragma unroll
  for (int p = 2; p < P; p += 2) {
    const float t0 = __fsub_rn(__fmul_rn(x2, tc), tp);
    const float t1 = __fsub_rn(__fmul_rn(x2, t0), tc);
    tp = t0;
    tc = t1;
    d2[p / 2] = __floats2bfloat162_rn(t0, t1);
  }
}

template <bool kWinners>
__global__ void __launch_bounds__(256, 2)
    geo_embed_fwd_mma_kernel(const float* __restrict__ d_idx,
                             const float* __restrict__ a_idx,
                             const __nv_bfloat16* __restrict__ md_g,
                             const __nv_bfloat16* __restrict__ ma_g,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out,
                             uint8_t* __restrict__ win, int64_t n_pairs,
                             int d, float scale_d, float scale_a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdLayout L(d);
  float* s_idx = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* basis =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L.basis_off);
  __nv_bfloat16* mt = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.mt_off);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // == d
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int r0 = lane >> 2;

  // M^T for the block's life; the basis tile's padding stays zero.
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < d * kMS; i += nthreads) {
    const int c = i / kMS;
    const int col = i - c * kMS;
    __nv_bfloat16 v = zero;
    if (col < kPd) {
      v = md_g[col * d + c];
    } else if (col >= kTdRows && col < kTdRows + kPa) {
      v = ma_g[(col - kTdRows) * d + c];
    }
    mt[i] = v;
  }
  for (int i = tid; i < kFT * kFS; i += nthreads) basis[i] = zero;
  float bc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 32 * warp + 8 * j + 2 * q;
    bc[j][0] = bias[c];
    bc[j][1] = bias[c + 1];
  }

  // ldmatrix lane addresses: A rows (pairs) lane % 16, columns 8 (lane / 16);
  // B rows (channels) 32 w + 8 (lane / 16) + lane % 8 (two n-tiles a
  // load), columns 8 ((lane / 8) % 2).
  const uint32_t a_base =
      smem_addr(basis) + ((lane & 15) * kFS + (lane >> 4) * 8) * 2;
  const int b_row = 32 * warp + 8 * (lane >> 4) + (lane & 7);
  const uint32_t b_base =
      smem_addr(mt) + (b_row * kMS + 8 * ((lane >> 3) & 1)) * 2;

  const int64_t n_tiles = (n_pairs + kFT - 1) / kFT;
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) fetch_idx(s_idx, d_idx, a_idx, n_pairs, tile * kFT, tid);
  cp_async_commit();

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int st = it & 1;
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      fetch_idx(s_idx + (st ^ 1) * kIdxStage, d_idx, a_idx, n_pairs,
                next * kFT, tid);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's fields have landed
    __syncthreads();     // ... for every thread; the basis tile is free

    const int64_t p0 = tile * kFT;
    const int npr = static_cast<int>(n_pairs - p0 < kFT ? n_pairs - p0 : kFT);
    const float* idx = s_idx + st * kIdxStage;
    for (int task = tid; task < (1 + kK) * kFT; task += nthreads) {
      const int f = task / kFT;  // 0: distance; 1..3: angle k
      const int pr = task - f * kFT;
      if (f == 0) {
        cheb_row<kPd>(idx[pr], scale_d, basis + pr * kFS);
      } else {
        cheb_row<kPa>(idx[kFT + pr * kK + f - 1], scale_a,
                      basis + pr * kFS + kTdRows + (f - 1) * kTaRows);
      }
    }
    __syncthreads();

    unsigned char* os = smem_raw + L.o_off;
    unsigned char* ws = smem_raw + L.w_off;
#pragma unroll 1
    for (int m = 0; m < kFT / 16; ++m) {
      const uint32_t a_m = a_base + 16 * m * kFS * 2;
      float acc[4][4], e[kK][4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[j][t] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < kK; ++kk) e[kk][j][t] = 0.0f;
        }
      // T(xd) . Md: three k-steps.
#pragma unroll
      for (int ks = 0; ks < kTdRows / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, a_m + ks * 32);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, b_base + (16 * jp * kMS + 16 * ks) * 2);
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
      // e_k = T(xa_k) . Ma, Ma's fragments shared by the three k.
      uint32_t bm[2][4][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, b_base + (16 * jp * kMS + kTdRows + 16 * ks) * 2);
          bm[ks][2 * jp][0] = b[0];
          bm[ks][2 * jp][1] = b[1];
          bm[ks][2 * jp + 1][0] = b[2];
          bm[ks][2 * jp + 1][1] = b[3];
        }
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, a_m + (kTdRows + kk * kTaRows + 16 * ks) * 2);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(e[kk][j], a, bm[ks][j][0], bm[ks][j][1]);
        }
      // Epilogue: fragment t of n-tile j is row 16 m + r0 (+ 8 for t >= 2),
      // channel 32 w + 8 j + 2 q + (t & 1).
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * warp + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * m + r0 + 8 * h;
          float v[2];
          unsigned bits = 0;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int t = 2 * h + u;
            const float amax =
                fmaxf(fmaxf(e[0][j][t], e[1][j][t]), e[2][j][t]);
            v[u] = __fadd_rn(__fadd_rn(acc[j][t], amax), bc[j][u]);
            if (kWinners) {
#pragma unroll
              for (int kk = 0; kk < kK; ++kk)
                bits |= (e[kk][j][t] == amax ? 1u : 0u) << (kk + 8 * u);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(os + row * L.o_stride + 2 * c) =
              __floats2bfloat162_rn(v[0], v[1]);
          if (kWinners) {
            *reinterpret_cast<uint16_t*>(ws + row * L.w_stride + c) =
                static_cast<uint16_t>(bits);
          }
        }
      }
    }
    __syncthreads();
    // The staged tile out to device memory: 16-byte chunks, each row's in
    // order across the threads.
    const int oc = d / 8;
    for (int i = tid; i < npr * oc; i += nthreads) {
      const int r = i / oc, c = i - r * oc;
      *reinterpret_cast<uint4*>(out + (p0 + r) * d + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * L.o_stride + 16 * c);
    }
    if (kWinners) {
      const int wc = d / 16;
      for (int i = tid; i < npr * wc; i += nthreads) {
        const int r = i / wc, c = i - r * wc;
        *reinterpret_cast<uint4*>(win + (p0 + r) * d + 16 * c) =
            *reinterpret_cast<const uint4*>(ws + r * L.w_stride + 16 * c);
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kWinners>
int launch_fwd_mma(const float* d_idx, const float* a_idx,
                   const __nv_bfloat16* md, const __nv_bfloat16* ma,
                   const float* bias, __nv_bfloat16* out, uint8_t* win,
                   long long n_pairs, int d, float scale_d, float scale_a,
                   cudaStream_t st) {
  const FwdLayout L(d);
  auto kern = geo_embed_fwd_mma_kernel<kWinners>;
  // Blocks: as many as the card holds at once (two an SM at d = 256),
  // fixed per d after the first call.  The shared-memory limit is set
  // once, for the largest d.
  static int grid_for[9] = {0};
  static bool attr_set = false;
  cudaError_t err = cudaSuccess;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FwdLayout(256).total);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int& grid = grid_for[d / 32];
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, d,
                                                          L.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    grid = sms * per_sm;
  }
  const long long n_tiles = (n_pairs + kFT - 1) / kFT;
  const int blocks = static_cast<int>(n_tiles < grid ? n_tiles : grid);
  if (blocks == 0) return 0;
  kern<<<blocks, d, L.total, st>>>(d_idx, a_idx, md, ma, bias, out, win,
                                   n_pairs, d, scale_d, scale_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Backward: d_idx, a_idx, scale_* as for geo_embed_fwd; win (n_pairs, d)
// uint8 winners from geo_embed_fwd; g (n_pairs, d) in the compute dtype;
// d_idx, a_idx, win and g 16-byte aligned; partial (nblocks, 69, d)
// float32 scratch; dmd (40, d), dma (28, d), dbias (d) float32 outputs.
// Returns the CUDA error of the two launches.
extern "C" int geo_embed_bwd(const void* d_idx, const void* a_idx,
                             const void* win, const void* g, void* partial,
                             void* dmd, void* dma, void* dbias,
                             long long n_pairs, int d, float scale_d,
                             float scale_a, int is_bf16, int nblocks,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(d_idx, a_idx, win, g, partial, dmd, dma,
                                     dbias, n_pairs, d, scale_d, scale_a,
                                     nblocks, st);
  return launch_bwd<float>(d_idx, a_idx, win, g, partial, dmd, dma, dbias,
                           n_pairs, d, scale_d, scale_a, nblocks, st);
}

// d_idx (n_pairs) f32 (already clamped to hi_d by the caller), a_idx
// (n_pairs, 3) f32, md (40, d) / ma (28, d) in the compute dtype, bias (d)
// f32, out (n_pairs, d) in the compute dtype, win (n_pairs, d) uint8 or
// null (no winners written).  is_bf16 selects bfloat16 (else float32).
// d: a multiple of 32, at most 256.  scale_* = 2 / hi_*.  Returns
// cudaGetLastError() after the launch.
extern "C" int geo_embed_fwd(const void* d_idx, const void* a_idx,
                             const void* md, const void* ma, const void* bias,
                             void* out, void* win, long long n_pairs, int d,
                             float scale_d, float scale_a, int is_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* di = static_cast<const float*>(d_idx);
  const float* ai = static_cast<const float*>(a_idx);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    auto launch = win != nullptr ? launch_fwd_mma<true>
                                 : launch_fwd_mma<false>;
    return launch(di, ai, static_cast<const __nv_bfloat16*>(md),
                  static_cast<const __nv_bfloat16*>(ma), bi,
                  static_cast<__nv_bfloat16*>(out),
                  static_cast<uint8_t*>(win), n_pairs, d, scale_d, scale_a,
                  st);
  }
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + kTile - 1) / kTile);
  geo_embed_fwd_kernel<<<blocks, d, 0, st>>>(
      di, ai, static_cast<const float*>(md), static_cast<const float*>(ma),
      bi, static_cast<float*>(out), static_cast<uint8_t*>(win), n_pairs, d,
      scale_d, scale_a);
  return static_cast<int>(cudaGetLastError());
}
