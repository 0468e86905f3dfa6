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
//
// For training the forward also writes the winners: one byte per (pair,
// channel) whose bit k is set where e_k reaches the max (several bits at
// an exact tie).  The backward reads them instead of rebuilding e_k.  The
// serving call passes no winners buffer and computes what it did before.

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
    float e[kK];
    float amax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      e[kk] = dot_basis<kPa>(b + kPd + kk * kPa, ma);
      amax = fmaxf(amax, e[kk]);
    }
    out[(p0 + pr) * d + c] = from_float<T>(__fadd_rn(__fadd_rn(acc, amax), bc));
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
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + kTile - 1) / kTile);
  const float* di = static_cast<const float*>(d_idx);
  const float* ai = static_cast<const float*>(a_idx);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    geo_embed_fwd_kernel<__nv_bfloat16><<<blocks, d, 0, st>>>(
        di, ai, static_cast<const __nv_bfloat16*>(md),
        static_cast<const __nv_bfloat16*>(ma), bi,
        static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(win), n_pairs,
        d, scale_d, scale_a);
  } else {
    geo_embed_fwd_kernel<float><<<blocks, d, 0, st>>>(
        di, ai, static_cast<const float*>(md), static_cast<const float*>(ma),
        bi, static_cast<float*>(out), static_cast<uint8_t*>(win), n_pairs, d,
        scale_d, scale_a);
  }
  return static_cast<int>(cudaGetLastError());
}
