// The image side of SAM's two-way transformer, one pass per key row, on
// Hopper (sm_90a): K9.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA's
// fusion (sam6d_tpu/models/ism/sam/decoder.py:144, TwoWayAttentionBlock).
// It was added because the chain, run as PyTorch ops on the H100, moved
// about 12.8 GB a batch of 64 grid prompts through float32 elementwise
// passes (the AMG decode held about 87% of a frame).  Per prompt b and key
// row n, with keys_in[b or 0, n] (256 channels) and key_pe[n]:
//
//   x  = keys_in + key_pe;          q = bf(x) Wq^T + bq  -> bf   (8 x 16)
//   l  = bf(q_h . k_tok[b, t]_h);   p = softmax_t(l / 4)        (float32)
//   o  = sum_t p v_tok[b, t]_h  -> bf;   a = o Wo^T + bo  -> bf
//   y  = LN(keys_in + a)  -> bf  = keys_out[b, n]   (the residual rounds to
//        bf when keys_in is bf, as the plain path's bf16 add does)
//   kp = bf(y + key_pe) Wk^T + bk -> bf;   vp = y Wv^T + bv -> bf
//        (both stored head-major, [b][head][n][16])
//
// (bf: rounded to bfloat16; weights [out][in] as nn.Linear keeps them.)
// These are the rounding points of `ops/two_way.two_way_keys_plain`.
// The softmax runs over the T prompt tokens, never over the keys, so the
// whole chain is local to one (prompt, row).
//
// What bounds it on this card: per (prompt, row) 4 x 256 x 128 multiply-
// adds (262,144 tensor-core operations) against 1 KB that must be written
// (keys_out, kp, vp in bf16) and, for the batched call, 0.5 KB read: about
// 3.5 operations a byte, far below the card's ~295: bytes.  The design
// keeps every intermediate out of device memory: a tile of 128 rows
// comes in once, and the three outputs leave once, in 16-byte stores.
//
// Design (bf16 compute, `two_way_mma_kernel`): a persistent grid, one
// block of 8 warps per SM, walks work items (a tile of 128 rows x a
// group of prompts).  Each warp owns 16 rows of the tile, its band of
// shared memory, for the whole item; only the weights and the prompt's
// tokens are shared between warps.  The four bf16 weight matrices (256 KB)
// do not fit a block: they stream through a ring of three 18 KB buffers by
// cp.async, in chunks (Wq, Wv: 32 output rows x 256; Wo: 64 x 128; Wk:
// 128 x 64 input columns), two chunks in flight ahead of the one being
// multiplied; every product is an mma.sync m16n8k16 (bf16 operands from
// ldmatrix, float32 sums).  The warp's bf(x) band feeds q = x Wq^T; q's
// accumulator layout, rounded, is the A layout of the logits' product with
// the prompt's k tokens (one head a k-step, 16 tokens an n-step, padded
// with zeros and masked before the softmax).  The softmax runs over the
// tokens 16 at a time with a running maximum and sum, in registers (quad
// shuffles), so a prompt may bring any number of tokens: the buffer holds
// its first 16, and more replace them chunk by chunk (`attend`).  The
// float32 probabilities are split into bf16 hi + lo, so p v keeps float32
// accuracy as the plain path's float32 product does (v is exact in bf16;
// ldmatrix.trans reads it in [token][channel] layout).  o's accumulators
// become the A fragments of o Wo^T; the 16 x 256 result of a warp stays in
// registers (128 a lane) through the
// residual, the LayerNorm (two passes over registers, quad shuffles) and
// the rounding, and becomes the A fragments of y Wv^T and, chunk by chunk,
// of bf(y + key_pe) Wk^T.  Eight warps a block hide little latency, so the
// reads the epilogues need (keys_in at the residual, key_pe at the k
// projection; L2 hits at the fragments' positions) are issued a chunk
// ahead of their use, while tensor-core work runs.  Outputs go through a
// small per-warp staging tile to 16-byte stores; kp and vp are written
// head-major, (B, 8, N, 16), the layout in which the next token-to-image
// attention's products read them without a copy.  With a batch-1 image
// side (the first block) the item holds a group of prompts: q depends on
// the row alone, so it is computed once per item, kept in the band, and
// each prompt of the group reuses it (12 of the 16 weight chunks per
// prompt).  The next prompt's first 16 tokens arrive by cp.async while
// this prompt's output projection runs, and the next item's key rows are
// prefetched into L2.
//
// Float32 compute (`two_way_f32_kernel`, tiny configurations; no
// benchmark cell runs it): CUDA cores, float32 throughout, a block of 256
// threads per 32 rows and a group of prompts (one, or with a batch-1
// image side several, which share q), every intermediate in shared
// memory; the tokens are read where they lie, one pass with a running
// softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 256;      // key channels
constexpr int kI = 128;      // the attentions' width: 8 heads of 16
constexpr int kHeads = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows of a tile, 16 a warp
constexpr int kXS = kC + 8;          // band row stride (bf16)
constexpr int kTS = kI + 8;          // token and Wo-chunk row stride (bf16)
constexpr int kStS = 64 + 8;         // staging and Wk-chunk row stride (bf16)
constexpr int kChunk = kI * kStS;    // elements of a weight buffer: the
                                     // largest chunk, Wk's 128 x 64
static_assert(kChunk >= 64 * kTS && kChunk >= 32 * kXS, "weight buffer");
constexpr int kStages = 3;           // weight buffers
constexpr int kVec = 1152;           // bq 128, bo 256, ln w / b 512, bk, bv 256
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* keys;       // (Bk, N, 256) float32 or bf16
  const float* pe;        // (N, 256)
  const void* ktok;       // (B, T, 128) compute dtype
  const void* vtok;
  const void* wq;         // (128, 256)
  const void* bq;         // (128)
  const void* wo;         // (256, 128)
  const void* bo;         // (256)
  const float* lnw;       // (256)
  const float* lnb;
  const void* wk;         // (128, 256)
  const void* bk;
  const void* wv;
  const void* bv;
  void* keys_out;         // (B, N, 256) compute dtype
  void* kp;               // (B, N, 128)
  void* vp;
  int B, N, T, shared, group, n_tiles, n_items;
  float eps;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
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

// Two floats rounded to bf16, packed with the first in the low half (the
// lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 hi = rn(x) and lo = rn(x - hi) of two floats, packed.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

// Two consecutive key channels as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Eight consecutive key channels as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Sixteen consecutive floats (a head of a token).
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}

// The residual keys_in + a: float32 keys add in float32, bf16 keys in
// bf16 (the plain path's bf16 + bf16).
template <typename KT>
__device__ __forceinline__ float residual(float k, float a) {
  if constexpr (sizeof(KT) == 2) {
    return round_bf16(k + a);
  } else {
    return k + a;
  }
}

// Element (b, n, c) of a (B, N, 128) projection stored head-major, as
// (B, 8, N, 16): head c / 16, channel c % 16.
template <typename T>
__device__ __forceinline__ T* head_major(void* base, int b, int c, int n,
                                         int N) {
  return static_cast<T*>(base) +
         ((static_cast<int64_t>(b) * kHeads + c / 16) * N + n) * 16 + c % 16;
}

// A prompt's tokens come in chunks of 16: k rows 0..15, v rows 16..31.
constexpr int kTokRows = 16;
constexpr int kTokElems = 2 * kTokRows * kTS;
constexpr int kMmaSmem =
    (kRows * kXS + kStages * kChunk + kTokElems + kWarps * 16 * kStS) * 2 +
    kVec * 4;

// The weight chunk sequence of a work item: Wq 0..3, then for each prompt
// Wo 0..3, Wk 0..3, Wv 0..3.  kind 0: Wq, 1: Wo, 2: Wk, 3: Wv.
struct Cursor {
  int item, ci, np;
};

__device__ __forceinline__ int item_prompts(const Params& p, int item) {
  if (item >= p.n_items) return 0;
  const int b0 = (item / p.n_tiles) * p.group;
  return min(p.group, p.B - b0);
}

__device__ __forceinline__ void advance(Cursor& c, const Params& p) {
  if (++c.ci == 4 + 12 * c.np) {
    c.item += gridDim.x;
    c.ci = 0;
    c.np = item_prompts(p, c.item);
  }
}

// Chunk c.ci of item c.item into a buffer (nothing past the last item).
__device__ __forceinline__ void fetch_chunk(const Params& p, const Cursor& c,
                                            bf16* buf, int tid) {
  if (c.item >= p.n_items) return;
  int kind, j;
  if (c.ci < 4) {
    kind = 0;
    j = c.ci;
  } else {
    const int r = (c.ci - 4) % 12;
    kind = 1 + r / 4;
    j = r % 4;
  }
  if (kind == 1) {  // Wo: output rows 64 j .., every input column
    const bf16* w = static_cast<const bf16*>(p.wo) + 64 * j * kI;
    for (int i = tid; i < 64 * (kI / 8); i += kThreads) {
      const int r = i >> 4, col = (i & 15) * 8;
      cp_async16(smem_addr(buf + r * kTS + col), w + r * kI + col, true);
    }
  } else if (kind == 2) {  // Wk: every output row, input columns 64 j ..
    const bf16* w = static_cast<const bf16*>(p.wk) + 64 * j;
    for (int i = tid; i < kI * 8; i += kThreads) {
      const int r = i >> 3, col = (i & 7) * 8;
      cp_async16(smem_addr(buf + r * kStS + col), w + r * kC + col, true);
    }
  } else {  // Wq, Wv: output rows 32 j .., every input column
    const bf16* w = static_cast<const bf16*>(kind == 0 ? p.wq : p.wv) +
                    32 * j * kC;
    for (int i = tid; i < 32 * (kC / 8); i += kThreads) {
      const int r = i >> 5, col = (i & 31) * 8;
      cp_async16(smem_addr(buf + r * kXS + col), w + r * kC + col, true);
    }
  }
}

// Chunk kc of prompt b's k and v tokens (tokens 16 kc ..) into the token
// buffer, zero rows past T.
__device__ __forceinline__ void fetch_tokens(const Params& p, int b, int kc,
                                             bf16* buf, int tid) {
  for (int i = tid; i < 2 * kTokRows * (kI / 8); i += kThreads) {
    const int which = i / (kTokRows * (kI / 8));
    const int rem = i - which * kTokRows * (kI / 8);
    const int r = rem >> 4, col = (rem & 15) * 8;
    const int t = kTokRows * kc + r;
    const bool valid = t < p.T;
    const bf16* src = static_cast<const bf16*>(which ? p.vtok : p.ktok) +
                      (static_cast<int64_t>(b) * p.T + (valid ? t : 0)) * kI +
                      col;
    cp_async16(smem_addr(buf + (which * kTokRows + r) * kTS + col), src,
               valid);
  }
}

// The attention of a warp's 16 rows (q, rounded, in its band) over prompt
// b's tokens -> o (the A fragments of o Wo^T), head by head, 16 tokens a
// k-step with a running softmax.  The token buffer holds the first chunk.
// kOne: one chunk (the common case: a grid point brings 7 tokens, a box
// 8), no barrier.  Else more than 16 tokens replace the buffer chunk by
// chunk for every head, every warp at once: the path stays correct for
// any number of tokens and leaves the common case's registers alone.
template <bool kOne>
__device__ __forceinline__ void attend(const Params& p, int b, int n_chunks,
                                       bf16* tok, int tid, uint32_t band_a,
                                       uint32_t tk_b, uint32_t tv_b, int t4,
                                       uint32_t (&oa)[kHeads][4]) {
  const int chunks = kOne ? 1 : n_chunks;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    uint32_t a[4];
    ldsm_x4(a, band_a + h * 32);
    float m0 = -INFINITY, m1 = -INFINITY, z0 = 0.0f, z1 = 0.0f;
    float o[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    for (int kc = 0; kc < chunks; ++kc) {
      if (!kOne && (h > 0 || kc > 0)) {
        __syncthreads();
        fetch_tokens(p, b, kc, tok, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      uint32_t bb[4];
      ldsm_x4(bb, tk_b + 16 * h * 2);
      mma_bf16(s[0], a, bb[0], bb[1]);
      mma_bf16(s[1], a, bb[2], bb[3]);
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = kTokRows * kc + 8 * n + 2 * t4 + (e & 1);
          const float v = t < p.T ? round_bf16(s[n][e]) * 0.25f : -INFINITY;
          s[n][e] = v;
          if (e < 2) {
            c0 = fmaxf(c0, v);
          } else {
            c1 = fmaxf(c1, v);
          }
        }
      // Every chunk holds a token, so the new maxima are finite; the first
      // chunk's rescale is exp(-inf) = 0.
      c0 = fmaxf(m0, quad_max(c0));
      c1 = fmaxf(m1, quad_max(c1));
      if (!kOne) {
        const float r0 = __expf(m0 - c0), r1 = __expf(m1 - c1);
        z0 *= r0;
        z1 *= r1;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          o[n][0] *= r0;
          o[n][1] *= r0;
          o[n][2] *= r1;
          o[n][3] *= r1;
        }
      }
      m0 = c0;
      m1 = c1;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __expf(s[n][e] - (e < 2 ? c0 : c1));
          s[n][e] = v;
          if (e < 2) {
            z0 += v;
          } else {
            z1 += v;
          }
        }
      // p in [0, 1] as bf16 hi + lo: p v keeps float32 accuracy, as the
      // plain path's float32 product does (v is exact in bf16).
      uint32_t ph[4], pl[4];
      split2(s[0][0], s[0][1], ph[0], pl[0]);
      split2(s[0][2], s[0][3], ph[1], pl[1]);
      split2(s[1][0], s[1][1], ph[2], pl[2]);
      split2(s[1][2], s[1][3], ph[3], pl[3]);
      uint32_t vb[4];
      ldsm_x4_t(vb, tv_b + 16 * h * 2);
      mma_bf16(o[0], pl, vb[0], vb[1]);
      mma_bf16(o[0], ph, vb[0], vb[1]);
      mma_bf16(o[1], pl, vb[2], vb[3]);
      mma_bf16(o[1], ph, vb[2], vb[3]);
    }
    z0 = 1.0f / quad_sum(z0);
    z1 = 1.0f / quad_sum(z1);
    oa[h][0] = pack_bf16(o[0][0] * z0, o[0][1] * z0);
    oa[h][1] = pack_bf16(o[0][2] * z1, o[0][3] * z1);
    oa[h][2] = pack_bf16(o[1][0] * z0, o[1][1] * z0);
    oa[h][3] = pack_bf16(o[1][2] * z1, o[1][3] * z1);
  }
}

template <typename KT>
__global__ void __launch_bounds__(kThreads, 1)
    two_way_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* band = reinterpret_cast<bf16*>(smem_raw);
  bf16* wbuf = band + kRows * kXS;
  bf16* tok = wbuf + kStages * kChunk;
  bf16* stage_all = tok + kTokElems;
  float* vec = reinterpret_cast<float*>(stage_all + kWarps * 16 * kStS);
  float* s_bq = vec;
  float* s_bo = vec + 128;
  float* s_lnw = vec + 384;
  float* s_lnb = vec + 640;
  float* s_bk = vec + 896;
  float* s_bv = vec + 1024;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment rows g and g + 8
  const int t4 = lane & 3;  // fragment column pair
  const KT* keys = static_cast<const KT*>(p.keys);
  const int N = p.N;
  const int n_chunks = (p.T + kTokRows - 1) / kTokRows;

  for (int i = tid; i < kI; i += kThreads) {
    s_bq[i] = __bfloat162float(static_cast<const bf16*>(p.bq)[i]);
    s_bk[i] = __bfloat162float(static_cast<const bf16*>(p.bk)[i]);
    s_bv[i] = __bfloat162float(static_cast<const bf16*>(p.bv)[i]);
  }
  for (int i = tid; i < kC; i += kThreads) {
    s_bo[i] = __bfloat162float(static_cast<const bf16*>(p.bo)[i]);
    s_lnw[i] = p.lnw[i];
    s_lnb[i] = p.lnb[i];
  }

  // Prologue: chunks 0 and 1, and the first prompt's tokens.
  Cursor fetch{static_cast<int>(blockIdx.x), 0,
               item_prompts(p, blockIdx.x)};
  fetch_chunk(p, fetch, wbuf, tid);
  fetch_tokens(p, (blockIdx.x / p.n_tiles) * p.group, 0, tok, tid);
  cp_async_commit();
  advance(fetch, p);
  fetch_chunk(p, fetch, wbuf + kChunk, tid);
  cp_async_commit();
  advance(fetch, p);
  int cc = 0;  // chunks consumed by this block

  // Wait for the next chunk, free the oldest buffer, fetch two ahead.
  // Returns the chunk's buffer.  `tokens_for` >= 0: also fetch that
  // prompt's first 16 tokens (once every warp is past this prompt's
  // attention).
  auto consume = [&](int tokens_for) -> const bf16* {
    cp_async_wait<1>();
    __syncthreads();
    fetch_chunk(p, fetch, wbuf + ((cc + 2) % kStages) * kChunk, tid);
    if (tokens_for >= 0) fetch_tokens(p, tokens_for, 0, tok, tid);
    cp_async_commit();
    advance(fetch, p);
    return wbuf + (cc++ % kStages) * kChunk;
  };

  // Per-lane ldmatrix offsets.  A (16 x 16 of a row-major tile): row
  // lane % 16, column 8 (lane / 16).  B (two n-tiles of an [n][k] tile):
  // row (lane % 8) + 8 (lane / 16), column 8 ((lane / 8) % 2).  B of
  // ldmatrix.trans ([k][n] tile, two n-tiles): row (lane % 8) +
  // 8 ((lane / 8) % 2), column 8 (lane / 16).
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;
  bf16* my_band = band + 16 * warp * kXS;
  const uint32_t band_a =
      smem_addr(my_band + (lane & 15) * kXS + (lane >> 4) * 8);
  bf16* stage = stage_all + 16 * warp * kStS;

  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int tile = item % p.n_tiles;
    const int b0 = (item / p.n_tiles) * p.group;
    const int np = min(p.group, p.B - b0);
    const int n0 = tile * kRows;
    const int row0 = n0 + 16 * warp;  // this warp's first row
    const int kb0 = p.shared ? 0 : b0;

    // The next item's key rows into L2 (a batch-1 image side stays there).
    const int next = item + gridDim.x;
    if (!p.shared && next < p.n_items) {
      const int nn0 = (next % p.n_tiles) * kRows;
      const int nb = (next / p.n_tiles) * p.group;
      const char* base = reinterpret_cast<const char*>(
          keys + (static_cast<int64_t>(nb) * N + nn0) * kC);
      const int lines = min(kRows, N - nn0) * kC * sizeof(KT) / 128;
      for (int i = tid; i < lines; i += kThreads) prefetch_l2(base + i * 128);
    }

    // ---- the warp's band: bf(keys_in + key_pe), zeros past N ----------
#pragma unroll 8
    for (int r = 0; r < 16; ++r) {
      const int n = row0 + r;
      float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (n < N) {
        float k[8], e[8];
        load8(keys + (static_cast<int64_t>(kb0) * N + n) * kC + 8 * lane, k);
        load8(p.pe + static_cast<int64_t>(n) * kC + 8 * lane, e);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = k[i] + e[i];
      }
      uint4 u;
      u.x = pack_bf16(x[0], x[1]);
      u.y = pack_bf16(x[2], x[3]);
      u.z = pack_bf16(x[4], x[5]);
      u.w = pack_bf16(x[6], x[7]);
      *reinterpret_cast<uint4*>(my_band + r * kXS + 8 * lane) = u;
    }
    __syncwarp();

    // ---- q = bf(x) Wq^T + bq, 32 columns (two heads) a chunk ------------
    uint32_t qa[kHeads][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t wb = smem_addr(consume(-1)) + (b_row * kXS + b_col) * 2;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, band_a + ks * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b[4];
          ldsm_x4(b, wb + (16 * h * kXS + 16 * ks) * 2);
          mma_bf16(acc[2 * h], a, b[0], b[1]);
          mma_bf16(acc[2 * h + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c0 = 32 * j + 16 * hh + 2 * t4, c1 = c0 + 8;
        const float(&u)[4] = acc[2 * hh];
        const float(&v)[4] = acc[2 * hh + 1];
        qa[2 * j + hh][0] = pack_bf16(u[0] + s_bq[c0], u[1] + s_bq[c0 + 1]);
        qa[2 * j + hh][1] = pack_bf16(u[2] + s_bq[c0], u[3] + s_bq[c0 + 1]);
        qa[2 * j + hh][2] = pack_bf16(v[0] + s_bq[c1], v[1] + s_bq[c1 + 1]);
        qa[2 * j + hh][3] = pack_bf16(v[2] + s_bq[c1], v[3] + s_bq[c1 + 1]);
      }
    }
    // q into the band's first 128 columns, for every prompt of the item.
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      uint32_t* r0 = reinterpret_cast<uint32_t*>(my_band + g * kXS + 16 * h +
                                                 2 * t4);
      uint32_t* r8 = reinterpret_cast<uint32_t*>(my_band + (g + 8) * kXS +
                                                 16 * h + 2 * t4);
      r0[0] = qa[h][0];
      r8[0] = qa[h][1];
      r0[4] = qa[h][2];
      r8[4] = qa[h][3];
    }
    __syncwarp();

    for (int pi = 0; pi < np; ++pi) {
      const int b = b0 + pi;
      const uint32_t tk_b = smem_addr(tok) + (b_row * kTS + b_col) * 2;
      const uint32_t tv_b =
          smem_addr(tok + kTokRows * kTS) + (t_row * kTS + t_col) * 2;

      // ---- attention over the prompt's tokens ---------------------------
      uint32_t oa[kHeads][4];
      if (n_chunks == 1) {
        attend<true>(p, b, 1, tok, tid, band_a, tk_b, tv_b, t4, oa);
      } else {
        attend<false>(p, b, n_chunks, tok, tid, band_a, tk_b, tv_b, t4, oa);
      }

      // ---- a = bf(o) Wo^T + bo, 64 columns a chunk -----------------------
      // With the first chunk, the next prompt's tokens start to arrive.
      int nb = -1;
      if (pi + 1 < np) {
        nb = b + 1;
      } else if (next < p.n_items) {
        nb = (next / p.n_tiles) * p.group;
      }
      const int rg = row0 + g;
      const bool v0 = rg < N, v1 = rg + 8 < N;
      const KT* k0 =
          keys + (static_cast<int64_t>(p.shared ? 0 : b) * N + rg) * kC;
      const KT* k1 = k0 + 8 * kC;
      float y[32][4];
#pragma unroll
      for (int n = 0; n < 32; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[n][e] = 0.0f;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t wb =
            smem_addr(consume(j == 0 ? nb : -1)) +
            (b_row * kTS + b_col) * 2;
        // keys_in at this chunk's columns, read while its products run.
        float2 x0[8], x1[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 64 * j + 8 * i + 2 * t4;
          x0[i] = v0 ? load2(k0 + c) : make_float2(0.0f, 0.0f);
          x1[i] = v1 ? load2(k1 + c) : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int ks = 0; ks < kI / 16; ++ks)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            uint32_t bb[4];
            ldsm_x4(bb, wb + (16 * h * kTS + 16 * ks) * 2);
            mma_bf16(y[8 * j + 2 * h], oa[ks], bb[0], bb[1]);
            mma_bf16(y[8 * j + 2 * h + 1], oa[ks], bb[2], bb[3]);
          }
        // bf(a + bo), then the residual.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 8 * j + i, c = 8 * n + 2 * t4;
          y[n][0] = residual<KT>(x0[i].x, round_bf16(y[n][0] + s_bo[c]));
          y[n][1] = residual<KT>(x0[i].y, round_bf16(y[n][1] + s_bo[c + 1]));
          y[n][2] = residual<KT>(x1[i].x, round_bf16(y[n][2] + s_bo[c]));
          y[n][3] = residual<KT>(x1[i].y, round_bf16(y[n][3] + s_bo[c + 1]));
          sum0 += y[n][0] + y[n][1];
          sum1 += y[n][2] + y[n][3];
        }
      }

      // ---- LayerNorm (two passes over registers), keys_out ------------
      const float mu0 = quad_sum(sum0) * (1.0f / kC);
      const float mu1 = quad_sum(sum1) * (1.0f / kC);
      float sq0 = 0.0f, sq1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        y[n][0] -= mu0;
        y[n][1] -= mu0;
        y[n][2] -= mu1;
        y[n][3] -= mu1;
        sq0 += y[n][0] * y[n][0] + y[n][1] * y[n][1];
        sq1 += y[n][2] * y[n][2] + y[n][3] * y[n][3];
      }
      const float rs0 = rsqrtf(quad_sum(sq0) * (1.0f / kC) + p.eps);
      const float rs1 = rsqrtf(quad_sum(sq1) * (1.0f / kC) + p.eps);
      uint32_t ya[16][4];
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int c = 8 * n + 2 * t4;
        // n-tile n is k-step n / 2: registers 0, 1 (n even) or 2, 3.
        const int ks = n >> 1, hf = (n & 1) * 2;
        ya[ks][hf] = pack_bf16(y[n][0] * rs0 * s_lnw[c] + s_lnb[c],
                               y[n][1] * rs0 * s_lnw[c + 1] + s_lnb[c + 1]);
        ya[ks][hf + 1] = pack_bf16(y[n][2] * rs1 * s_lnw[c] + s_lnb[c],
                                   y[n][3] * rs1 * s_lnw[c + 1] + s_lnb[c + 1]);
      }
      bf16* out_keys = static_cast<bf16*>(p.keys_out) +
                       (static_cast<int64_t>(b) * N + row0) * kC;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * qq + kk;
          uint32_t* r0 = reinterpret_cast<uint32_t*>(stage + g * kStS +
                                                     16 * kk + 2 * t4);
          uint32_t* r8 = reinterpret_cast<uint32_t*>(stage + (g + 8) * kStS +
                                                     16 * kk + 2 * t4);
          r0[0] = ya[ks][0];
          r8[0] = ya[ks][1];
          r0[4] = ya[ks][2];
          r8[4] = ya[ks][3];
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int piece = lane + 32 * i;
          const int r = piece >> 3, c8 = (piece & 7) * 8;
          if (row0 + r < N)
            *reinterpret_cast<uint4*>(out_keys + r * kC + 64 * qq + c8) =
                *reinterpret_cast<const uint4*>(stage + r * kStS + c8);
        }
        __syncwarp();
      }

      // ---- kp = bf(y + pe) Wk^T + bk, 64 input columns a chunk: the
      // positional encoding at a chunk's columns is read while the last
      // chunk's products run, and bf(y + pe) is made as a chunk needs it.
      const float* e0 = p.pe + static_cast<int64_t>(rg) * kC;
      const float* e1 = e0 + 8 * kC;
      float ka[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ka[n][e] = 0.0f;
      float2 q0[8], q1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * i + 2 * t4;
        q0[i] = v0 ? load2(e0 + c) : make_float2(0.0f, 0.0f);
        q1[i] = v1 ? load2(e1 + c) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ypa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 2 * kk + hf;
            const float2 u0 = unpack_bf16(ya[4 * j + kk][2 * hf]);
            const float2 u1 = unpack_bf16(ya[4 * j + kk][2 * hf + 1]);
            ypa[kk][2 * hf] = pack_bf16(u0.x + q0[i].x, u0.y + q0[i].y);
            ypa[kk][2 * hf + 1] = pack_bf16(u1.x + q1[i].x, u1.y + q1[i].y);
          }
        if (j < 3) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = 64 * (j + 1) + 8 * i + 2 * t4;
            q0[i] = v0 ? load2(e0 + c) : make_float2(0.0f, 0.0f);
            q1[i] = v1 ? load2(e1 + c) : make_float2(0.0f, 0.0f);
          }
        }
        const uint32_t wb =
            smem_addr(consume(-1)) + (b_row * kStS + b_col) * 2;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 8; ++h) {
            uint32_t bb[4];
            ldsm_x4(bb, wb + (16 * h * kStS + 16 * kk) * 2);
            mma_bf16(ka[2 * h], ypa[kk], bb[0], bb[1]);
            mma_bf16(ka[2 * h + 1], ypa[kk], bb[2], bb[3]);
          }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 8 * half + i, c = 8 * i + 2 * t4, cg = 8 * n + 2 * t4;
          *reinterpret_cast<uint32_t*>(stage + g * kStS + c) = pack_bf16(
              ka[n][0] + s_bk[cg], ka[n][1] + s_bk[cg + 1]);
          *reinterpret_cast<uint32_t*>(stage + (g + 8) * kStS + c) =
              pack_bf16(ka[n][2] + s_bk[cg], ka[n][3] + s_bk[cg + 1]);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int piece = lane + 32 * i;
          const int r = piece >> 3, c8 = (piece & 7) * 8;
          if (row0 + r < N)
            *reinterpret_cast<uint4*>(head_major<bf16>(
                p.kp, b, 64 * half + c8, row0 + r, N)) =
                *reinterpret_cast<const uint4*>(stage + r * kStS + c8);
        }
        __syncwarp();
      }

      // ---- vp = y Wv^T + bv, 32 output columns a chunk -----------------
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t wb =
            smem_addr(consume(-1)) + (b_row * kXS + b_col) * 2;
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t bb[4];
            ldsm_x4(bb, wb + (16 * h * kXS + 16 * ks) * 2);
            mma_bf16(acc[2 * h], ya[ks], bb[0], bb[1]);
            mma_bf16(acc[2 * h + 1], ya[ks], bb[2], bb[3]);
          }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * t4, cg = 32 * j + c;
          *reinterpret_cast<uint32_t*>(stage + g * kStS + c) = pack_bf16(
              acc[n][0] + s_bv[cg], acc[n][1] + s_bv[cg + 1]);
          *reinterpret_cast<uint32_t*>(stage + (g + 8) * kStS + c) =
              pack_bf16(acc[n][2] + s_bv[cg], acc[n][3] + s_bv[cg + 1]);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int piece = lane + 32 * i;
          const int r = piece >> 2, c8 = (piece & 3) * 8;
          if (row0 + r < N)
            *reinterpret_cast<uint4*>(head_major<bf16>(
                p.vp, b, 32 * j + c8, row0 + r, N)) =
                *reinterpret_cast<const uint4*>(stage + r * kStS + c8);
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight when the block ends
}

// ---- float32: CUDA cores, a block per (32 rows, a group of prompts) ----
// Activations live in shared memory transposed, [channel][row], so a
// thread's 4 rows are one float4; the weights come transposed, [in][out]
// (`ops/two_way.kernel_weights`), so a warp's columns are one coalesced
// read.  Each product gives a thread a 4 x 4 or 4 x 8 tile: per input
// channel one shared and one or two global float4 reads feed 16 or 32 FMAs.
constexpr int kFRows = 32;
constexpr int kRS = kFRows + 4;  // row stride of a transposed activation
constexpr int kF32Smem = (2 * kC + 2 * kI) * kRS * 4;

// acc[i][4 v + j] += sum_k at[k][r0 + i] wt[k][c0 + 16 v + j]: at a
// transposed activation in shared memory, wt a transposed weight of row
// stride ldw in global memory.
template <int K, int CV>
__device__ __forceinline__ void f32_product(const float* at, const float* wt,
                                            int ldw, int r0, int c0,
                                            float (&acc)[4][4 * CV]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(at + k * kRS + r0);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int v = 0; v < CV; ++v) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(
          wt + static_cast<int64_t>(k) * ldw + c0 + 16 * v));
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][4 * v + j] = fmaf(av[i], wv[j], acc[i][4 * v + j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    two_way_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xt = reinterpret_cast<float*>(smem_raw);  // x, then y + pe
  float* yt = xt + kC * kRS;                        // y
  float* qt = yt + kC * kRS;                        // q
  float* ot = qt + kI * kRS;                        // the attention's o
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N;
  const int tile = blockIdx.x % p.n_tiles;
  const int b0 = (blockIdx.x / p.n_tiles) * p.group;
  const int np = min(p.group, p.B - b0);
  const int n0 = tile * kFRows;
  const float* keys_all = static_cast<const float*>(p.keys);
  const float* keys0 =
      keys_all + static_cast<int64_t>(p.shared ? 0 : b0) * N * kC;
  // A thread's tile of a product: rows r0 .. r0 + 3 and, with CV = 2,
  // columns c0 .. c0 + 3 and c0 + 16 .. c0 + 19.
  const int r0 = 4 * (lane >> 2);

  // x = keys_in + key_pe, transposed; zeros past N.  Lane = row.
  for (int i = tid; i < kFRows * (kC / 8); i += kThreads) {
    const int r = i & (kFRows - 1), c = (i / kFRows) * 8;
    const int n = n0 + r;
    float k[8] = {0, 0, 0, 0, 0, 0, 0, 0}, e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (n < N) {
      load8(keys0 + static_cast<int64_t>(n) * kC + c, k);
      load8(p.pe + static_cast<int64_t>(n) * kC + c, e);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) xt[(c + j) * kRS + r] = k[j] + e[j];
  }
  __syncthreads();

  {  // q = x Wq^T + bq: warp w, columns 16 w ..
    const int c0 = 16 * warp + 4 * (lane & 3);
    float acc[4][4] = {};
    f32_product<kC, 1>(xt, static_cast<const float*>(p.wq), kI, r0, c0, acc);
    const float* bq = static_cast<const float*>(p.bq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = bq[c0 + j];
      *reinterpret_cast<float4*>(qt + (c0 + j) * kRS + r0) = make_float4(
          acc[0][j] + bj, acc[1][j] + bj, acc[2][j] + bj, acc[3][j] + bj);
    }
  }
  __syncthreads();

  for (int pi = 0; pi < np; ++pi) {
    const int b = b0 + pi;
    const float* keys =
        keys_all + static_cast<int64_t>(p.shared ? 0 : b) * N * kC;

    {  // attention: warp = head, lane = row; one pass, a running softmax
      const int h = warp, r = lane;
      float q[16], acc[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        q[d] = qt[(16 * h + d) * kRS + r];
        acc[d] = 0.0f;
      }
      const float* kt = static_cast<const float*>(p.ktok) +
                        static_cast<int64_t>(b) * p.T * kI + 16 * h;
      const float* vt = static_cast<const float*>(p.vtok) +
                        static_cast<int64_t>(b) * p.T * kI + 16 * h;
      float m = -INFINITY, z = 0.0f;
      for (int t = 0; t < p.T; ++t) {
        float kv[16], vv[16];
        load16(kt + t * kI, kv);
        float l = 0.0f;
#pragma unroll
        for (int d = 0; d < 16; ++d) l = fmaf(q[d], kv[d], l);
        l *= 0.25f;
        const float mn = fmaxf(m, l);
        const float sc = expf(m - mn), e = expf(l - mn);
        m = mn;
        z = z * sc + e;
        load16(vt + t * kI, vv);
#pragma unroll
        for (int d = 0; d < 16; ++d) acc[d] = fmaf(e, vv[d], acc[d] * sc);
      }
      const float zi = 1.0f / z;
#pragma unroll
      for (int d = 0; d < 16; ++d) ot[(16 * h + d) * kRS + r] = acc[d] * zi;
    }
    __syncthreads();

    {  // y = keys_in + (o Wo^T + bo): warp w, columns 32 w ..
      const int c0 = 32 * warp + 4 * (lane & 3);
      float acc[4][8] = {};
      f32_product<kI, 2>(ot, static_cast<const float*>(p.wo), kC, r0, c0,
                         acc);
      const float* bo = static_cast<const float*>(p.bo);
      float res[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + r0 + i;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float4 k4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (n < N)
            k4 = *reinterpret_cast<const float4*>(
                keys + static_cast<int64_t>(n) * kC + c0 + 16 * v);
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            res[i][4 * v + j] =
                kk[j] + (acc[i][4 * v + j] + bo[c0 + 16 * v + j]);
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(yt + (c0 + 16 * v + j) * kRS + r0) =
              make_float4(res[0][4 * v + j], res[1][4 * v + j],
                          res[2][4 * v + j], res[3][4 * v + j]);
    }
    __syncthreads();

    {  // LayerNorm: warp w, rows 4 w ..; 8 lanes a row, channels lane % 8
       // + 8 i.  keys_out, y into yt, y + pe into xt.
      const int r = 4 * warp + (lane >> 3), cl = lane & 7;
      const int n = n0 + r;
      float v[32], s = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        v[i] = yt[(cl + 8 * i) * kRS + r];
        s += v[i];
      }
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      s += __shfl_xor_sync(kFull, s, 4);
      const float mu = s * (1.0f / kC);
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        v[i] -= mu;
        sq += v[i] * v[i];
      }
      sq += __shfl_xor_sync(kFull, sq, 1);
      sq += __shfl_xor_sync(kFull, sq, 2);
      sq += __shfl_xor_sync(kFull, sq, 4);
      const float rs = rsqrtf(sq * (1.0f / kC) + p.eps);
      float* out = static_cast<float*>(p.keys_out) +
                   (static_cast<int64_t>(b) * N + n) * kC;
      const float* pe = p.pe + static_cast<int64_t>(n) * kC;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = cl + 8 * i;
        const float y = v[i] * rs * p.lnw[c] + p.lnb[c];
        yt[c * kRS + r] = y;
        xt[c * kRS + r] = y + (n < N ? pe[c] : 0.0f);
        if (n < N) out[c] = y;
      }
    }
    __syncthreads();

    {  // kp = (y + pe) Wk^T + bk (warps 0-3), vp = y Wv^T + bv (warps 4-7)
      const int which = warp >> 2;
      const int c0 = 32 * (warp & 3) + 4 * (lane & 3);
      float acc[4][8] = {};
      f32_product<kC, 2>(which ? yt : xt,
                         static_cast<const float*>(which ? p.wv : p.wk), kI,
                         r0, c0, acc);
      const float* bias = static_cast<const float*>(which ? p.bv : p.bk);
      void* out = which ? p.vp : p.kp;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + r0 + i;
        if (n >= N) continue;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c = c0 + 16 * v;
          *reinterpret_cast<float4*>(head_major<float>(out, b, c, n, N)) =
              make_float4(acc[i][4 * v] + bias[c],
                          acc[i][4 * v + 1] + bias[c + 1],
                          acc[i][4 * v + 2] + bias[c + 2],
                          acc[i][4 * v + 3] + bias[c + 3]);
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kMaxDev = 16;

// The device's SM count, and the dynamic shared memory attribute of
// `kern` set once per device.
template <typename K>
cudaError_t setup(K kern, int smem, bool (&done)[kMaxDev], int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDev) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

// A batch-1 image side: the prompts in groups of `group`, so that the
// items (tiles x groups) fill about `slots` blocks; else one prompt an
// item.
void plan(Params& p, int rows, int slots) {
  p.n_tiles = (p.N + rows - 1) / rows;
  int groups = p.B;
  p.group = 1;
  if (p.shared) {
    groups = max(1, min(p.B, slots / p.n_tiles));
    p.group = (p.B + groups - 1) / groups;
    groups = (p.B + p.group - 1) / p.group;
  }
  p.n_items = p.n_tiles * groups;
}

template <typename KT>
int launch_mma(Params p, cudaStream_t st) {
  auto kern = two_way_mma_kernel<KT>;
  static bool done[kMaxDev] = {};
  int n_sm = 0;
  cudaError_t err = setup(kern, kMmaSmem, done, &n_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan(p, kRows, n_sm);
  kern<<<min(p.n_items, n_sm), kThreads, kMmaSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(Params p, cudaStream_t st) {
  static bool done[kMaxDev] = {};
  int n_sm = 0;
  cudaError_t err = setup(two_way_f32_kernel, kF32Smem, done, &n_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan(p, kFRows, 2 * n_sm);  // two blocks an SM
  two_way_f32_kernel<<<p.n_items, kThreads, kF32Smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys (Bk, N, 256): float32, or bf16 (keys_bf16) with a bf16 compute
// dtype; Bk = 1 when shared_keys (every prompt reads the same rows), else
// B.  key_pe (N, 256) float32.  k_tok, v_tok (B, T, 128), T >= 1; wq,
// wk, wv (128, 256), wo (256, 128) and the biases bq, bk, bv (128), bo
// (256) in the compute dtype (bf16 when compute_bf16, else float32 with
// the matrices transposed, [in][out]); ln_w, ln_b (256) float32.  Out: keys_out (B, N, 256), and kp, vp
// head-major (B, 8, N, 16), in the compute dtype.  Every pointer 16-byte
// aligned, every tensor contiguous.  Returns the CUDA error of the launch.
extern "C" int two_way_launch(
    const void* keys, const void* key_pe, const void* k_tok,
    const void* v_tok, const void* wq, const void* bq, const void* wo,
    const void* bo, const void* ln_w, const void* ln_b, const void* wk,
    const void* bk, const void* wv, const void* bv, void* keys_out, void* kp,
    void* vp, int B, int N, int T, int shared_keys, int keys_bf16,
    int compute_bf16, float eps, void* stream) {
  if (B < 1 || N < 1 || T < 1 || (keys_bf16 && !compute_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{keys, static_cast<const float*>(key_pe), k_tok, v_tok, wq, bq, wo,
           bo, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
           wk, bk, wv, bv, keys_out, kp, vp, B, N, T, shared_keys, 1, 0, 0,
           eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!compute_bf16) return launch_f32(p, st);
  return keys_bf16 ? launch_mma<bf16>(p, st) : launch_mma<float>(p, st);
}
