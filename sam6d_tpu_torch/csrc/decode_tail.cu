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
//
// What bounds it on this card: per token 2 x (256 x 256 + 4 x 64 x 128)
// multiply-adds against 512 bytes of bf16 keys, far above the card's ~295
// flops per byte: operations.  The products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 sums) at float32-level
// accuracy: every float32 operand x is split into bf16 hi = rn(x) and
// lo = rn(x - hi) (|x - hi - lo| <= 2^-17 |x|), and the products that
// matter are summed: stage 1 keys . W1_hi + keys . W1_lo for bf16 keys
// (exact in bf16), plus keys_lo . W1_hi for float32 keys; stage 2
// g_hi . W2_hi + g_hi . W2_lo + g_lo . W2_hi.  A single bf16 product would
// move logits by ~2^-9 relative and change which pixels cross a threshold.
// The LayerNorm, the GELUs and the hypernetwork contraction stay float32
// on the CUDA cores.
//
// Design: a persistent grid (one block of 8 warps per SM) walks the work
// items (prompt, tile of 256 tokens; 128 tokens and 4 warps for float32
// keys).  Each warp owns 32 token rows, two m-tiles, so that every B
// fragment read from shared memory feeds two products: the operand that
// all warps share (W1, W2) sets the shared-memory traffic.  The item's
// bf16 key tile comes in by cp.async into shared memory (rows padded to
// 264 elements, so the ldmatrix rows fall in distinct banks).  W1 (256 x
// 256, split and transposed once by the wrapper into hi and lo bf16) is
// 256 KB, more than a block holds: it streams through two buffers in
// chunks of one LayerNorm group's 64 output columns by 64 of depth (hi and
// lo, 18 KB), the next chunk fetched while this one is multiplied; W2 (hi
// and lo, 36 KB) stays for the whole run.  After a group's four chunks
// the warp reduces the group LayerNorm from its accumulator fragments
// (quad shuffles), applies the GELU, splits g into hi / lo A fragments in
// registers (the accumulator layout of two n-tiles is the A layout of one
// k-step) and runs stage 2, 32 columns (e, f) at a time, then the
// contraction with the prompt's hyper rows (quad shuffles) and the
// statistics: each lane speaks for one of the warp's 32 rows, so one
// ballot counts them all and integer min / max reductions give the box.
// The next item's keys are fetched while the last group's stage 2 runs.
// Each item writes its 8 x 12 statistics to a scratch row; a second small
// kernel reduces the tiles of each prompt in a fixed order, so the result
// does not depend on scheduling.  Neither the stage intermediates nor a
// logit touch device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kC = 256;       // key channels: stage-1 depth and width
constexpr int kG = 64;        // columns of one LayerNorm group
constexpr int kS2 = 128;      // stage-2 output columns
constexpr int kKC = 64;       // stage-1 depth of one W1 chunk
constexpr int kKS = kC + 8;   // shared row stride (bf16) of the keys
constexpr int kWS = kKC + 8;  // shared row stride (bf16) of a W1 chunk
constexpr int kW2S = kG + 8;  // shared row stride (bf16) of W2^T
constexpr int kStats = 8 * 12;
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

template <bool F32>
struct Cfg {
  static constexpr int kWarps = F32 ? 4 : 8;
  static constexpr int kRows = 32 * kWarps;  // tokens of a work item
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeyTiles = F32 ? 2 : 1;  // hi (and lo) key tiles
  static constexpr int kKeyBytes = kKeyTiles * kRows * kKS * 2;
  static constexpr int kW1Bytes = 2 * 2 * kG * kWS * 2;  // 2 buffers, hi + lo
  static constexpr int kW2Bytes = 2 * kS2 * kW2S * 2;
  static constexpr int kVecBytes = (3 * kC + kS2) * 4;
  static constexpr int kRedBytes = kWarps * 12 * 7 * 4;
  static constexpr int kSmem =
      kKeyBytes + kW1Bytes + kW2Bytes + kVecBytes + kRedBytes;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// bf16 hi = rn(x) and lo = rn(x - hi) of two floats, packed with the
// first in the low half (the lower column of a fragment).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float gelu_s(float x) {
  return __fdividef(x, 1.0f + __expf(-1.702f * x));
}

// Shared-memory layout, in bytes from the dynamic base.
template <bool F32>
struct Smem {
  __nv_bfloat16* keys;  // [kKeyTiles][kRows][kKS]
  __nv_bfloat16* w1;    // [2 buffers][2: hi, lo][kG][kWS]: one W1 chunk
  __nv_bfloat16* w2;    // [2][kS2][kW2S]
  float* b1;            // 256
  float* lns;           // 256
  float* lnb;           // 256
  float* b2;            // 128
  int* red;             // [kWarps][12][7]
  __device__ explicit Smem(unsigned char* base) {
    keys = reinterpret_cast<__nv_bfloat16*>(base);
    base += Cfg<F32>::kKeyBytes;
    w1 = reinterpret_cast<__nv_bfloat16*>(base);
    base += Cfg<F32>::kW1Bytes;
    w2 = reinterpret_cast<__nv_bfloat16*>(base);
    base += Cfg<F32>::kW2Bytes;
    b1 = reinterpret_cast<float*>(base);
    lns = b1 + kC;
    lnb = lns + kC;
    b2 = lnb + kC;
    red = reinterpret_cast<int*>(b2 + kS2);
  }
};

// W1 chunk c (group c / 4, depth 64 (c % 4) ..) of W1^T, hi and lo, into
// buffer c % 2.  The chunks do not depend on the item: the sequence
// repeats every 16.
template <bool F32>
__device__ __forceinline__ void fetch_w1(const Smem<F32>& s,
                                         const __nv_bfloat16* w1s, int c,
                                         int tid) {
  const int ad = c >> 2, k0 = (c & 3) * kKC;
  __nv_bfloat16* dst = s.w1 + (c & 1) * 2 * kG * kWS;
  constexpr int kPerRow = kKC / 8;
  for (int i = tid; i < 2 * kG * kPerRow; i += Cfg<F32>::kThreads) {
    const int hr = i / kPerRow;  // half * kG + row
    const int col = (i - hr * kPerRow) * 8;
    const int half = hr / kG;
    const int r = hr - half * kG;
    cp_async16(smem_addr(dst + hr * kWS + col),
               w1s + (static_cast<int64_t>(half) * kC + ad * kG + r) * kC +
                   k0 + col,
               true);
  }
}

// An item's key rows into shared memory, zeros beyond N: bf16 by
// cp.async; float32 split into hi and lo tiles by plain loads.
template <bool F32, typename T>
__device__ __forceinline__ void fetch_keys(const Smem<F32>& s, const T* keys,
                                           int p, int n0, int N, int tid) {
  constexpr int kRows = Cfg<F32>::kRows;
  const T* kp = keys + (static_cast<int64_t>(p) * N + n0) * kC;
  if constexpr (!F32) {
    for (int i = tid; i < kRows * (kC / 8); i += Cfg<F32>::kThreads) {
      const int r = i / (kC / 8);
      const int c = (i - r * (kC / 8)) * 8;
      const bool valid = n0 + r < N;
      cp_async16(smem_addr(s.keys + r * kKS + c),
                 kp + (valid ? r * kC + c : 0), valid);
    }
  } else {
    for (int i = tid; i < kRows * (kC / 2); i += Cfg<F32>::kThreads) {
      const int r = i / (kC / 2);
      const int c = (i - r * (kC / 2)) * 2;
      float2 v = make_float2(0.0f, 0.0f);
      if (n0 + r < N) v = *reinterpret_cast<const float2*>(kp + r * kC + c);
      uint32_t hi, lo;
      split2(v.x, v.y, hi, lo);
      *reinterpret_cast<uint32_t*>(s.keys + r * kKS + c) = hi;
      *reinterpret_cast<uint32_t*>(s.keys + (kRows + r) * kKS + c) = lo;
    }
  }
}

template <bool F32, typename T>
__global__ void __launch_bounds__(Cfg<F32>::kThreads, 1)
    decode_tail_mma_kernel(const T* __restrict__ keys,
                           const float* __restrict__ hyper,
                           const __nv_bfloat16* __restrict__ w1s,
                           const float* __restrict__ b1,
                           const float* __restrict__ lns,
                           const float* __restrict__ lnb,
                           const __nv_bfloat16* __restrict__ w2s,
                           const float* __restrict__ b2,
                           float* __restrict__ partial, int N, int side,
                           int n_tiles, int n_items, float thr, float off,
                           float eps) {
  using C = Cfg<F32>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<F32> s(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q = lane & 3;    // column pair of a fragment
  const int r0 = lane >> 2;  // fragment rows r0 and r0 + 8

  // Resident for the whole run: W2 (hi, lo) and the vectors.
  for (int i = tid; i < 2 * kS2 * (kG / 8); i += C::kThreads) {
    const int r = i / (kG / 8);
    const int c = (i - r * (kG / 8)) * 8;
    cp_async16(smem_addr(s.w2 + r * kW2S + c), w2s + r * kG + c, true);
  }
  for (int i = tid; i < kC; i += C::kThreads) {
    s.b1[i] = b1[i];
    s.lns[i] = lns[i];
    s.lnb[i] = lnb[i];
  }
  for (int i = tid; i < kS2; i += C::kThreads) s.b2[i] = b2[i];
  if (blockIdx.x < n_items) {
    const int p = blockIdx.x / n_tiles;
    fetch_keys<F32>(s, keys, p, (blockIdx.x - p * n_tiles) * C::kRows, N,
                    tid);
  }
  fetch_w1<F32>(s, w1s, 0, tid);
  cp_async_commit();

  // Per-lane byte offsets of the ldmatrix rows.  A (16 x 16 of a
  // row-major tile): row lane % 16, column 8 (lane / 16).  B (two n-tiles
  // of an [n][k] tile): row (lane % 8) + 8 (lane / 16), column
  // 8 ((lane / 8) % 2).  A warp owns token rows 32 w .. 32 w + 31: two
  // m-tiles, so every B fragment feeds two products.
  const uint32_t a_off =
      ((32 * warp + (lane & 15)) * kKS + (lane >> 4) * 8) * 2;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const uint32_t keys_hi = smem_addr(s.keys) + a_off;
  const uint32_t keys_lo = keys_hi + C::kRows * kKS * 2;
  const uint32_t w1_base = smem_addr(s.w1) + (b_row * kWS + b_col) * 2;
  const uint32_t w2_hi = smem_addr(s.w2) + (b_row * kW2S + b_col) * 2;
  const uint32_t w2_lo = w2_hi + kS2 * kW2S * 2;
  constexpr uint32_t kMT = 16 * kKS * 2;        // bytes of an m-tile's rows
  constexpr uint32_t kW1Half = kG * kWS * 2;    // hi -> lo of a chunk
  constexpr uint32_t kW1Buf = 2 * kW1Half;      // one chunk buffer

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int p = item / n_tiles;
    const int n0 = (item - p * n_tiles) * C::kRows;
    // hyper[p, t, c] at this lane's fragment columns c = 8 j + 2 q + e.
    float hy[3][4][2];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(
            hyper + (p * 3 + t) * 32 + 8 * j + 2 * q);
        hy[t][j][0] = v.x;
        hy[t][j][1] = v.y;
      }
    // This lane speaks for one of the warp's 32 rows in the statistics:
    // row 16 (q / 2) + 8 (q % 2) + r0 (m-tile q / 2, fragment half q % 2).
    const int n_me = n0 + 32 * warp + 16 * (q >> 1) + 8 * (q & 1) + r0;
    const bool v_me = n_me < N;
    const int y_me = 4 * (n_me / side), x_me = 4 * (n_me % side);
    // Lane statistics of column `lane` (lanes 0..11).
    int s_hi = 0, s_lo = 0, s_pos = 0;
    int s_xmn = INT_MAX, s_ymn = INT_MAX, s_xmx = INT_MIN, s_ymx = INT_MIN;

    for (int ad = 0; ad < 4; ++ad) {
      // ---- stage 1: h1 columns of group ad, 32 rows x 64 a warp ------
      float acc[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
      for (int kc = 0; kc < kC / kKC; ++kc) {
        const int c = ad * 4 + kc;
        cp_async_wait_all();
        __syncthreads();  // chunk c (and the keys) landed; c - 1 consumed
        fetch_w1<F32>(s, w1s, (c + 1) & 15, tid);
        cp_async_commit();
        const uint32_t w1_hi = w1_base + (c & 1) * kW1Buf;
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          const uint32_t ka = (kc * kKC + kk * 16) * 2;
          uint32_t a[2][4], al[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            ldsm_x4(a[m], keys_hi + m * kMT + ka);
            if constexpr (F32) ldsm_x4(al[m], keys_lo + m * kMT + ka);
          }
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            uint32_t bh[4], bl[4];
            const uint32_t o = j * 8 * kWS * 2 + kk * 32;
            ldsm_x4(bh, w1_hi + o);
            ldsm_x4(bl, w1_hi + kW1Half + o);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(acc[m][j], a[m], bl[0], bl[1]);
              mma_bf16(acc[m][j + 1], a[m], bl[2], bl[3]);
              if constexpr (F32) {
                mma_bf16(acc[m][j], al[m], bh[0], bh[1]);
                mma_bf16(acc[m][j + 1], al[m], bh[2], bh[3]);
              }
              mma_bf16(acc[m][j], a[m], bh[0], bh[1]);
              mma_bf16(acc[m][j + 1], a[m], bh[2], bh[3]);
            }
          }
        }
      }
      if (ad == 3) {
        // Every warp is done with the keys: fetch the next item's.
        __syncthreads();
        if (item + gridDim.x < n_items) {
          const int it = item + gridDim.x;
          const int pn = it / n_tiles;
          fetch_keys<F32>(s, keys, pn, (it - pn * n_tiles) * C::kRows, N,
                          tid);
        }
        cp_async_commit();
      }

      // ---- bias, LayerNorm over the group, GELU, hi / lo A fragments --
      uint32_t gh[2][4][4], gl[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = ad * kG + 8 * j + 2 * q;
          acc[m][j][0] += s.b1[c];
          acc[m][j][1] += s.b1[c + 1];
          acc[m][j][2] += s.b1[c];
          acc[m][j][3] += s.b1[c + 1];
          sa += acc[m][j][0] + acc[m][j][1];
          sb += acc[m][j][2] + acc[m][j][3];
        }
        sa += __shfl_xor_sync(kFull, sa, 1);
        sa += __shfl_xor_sync(kFull, sa, 2);
        sb += __shfl_xor_sync(kFull, sb, 1);
        sb += __shfl_xor_sync(kFull, sb, 2);
        const float mua = sa * (1.0f / kG), mub = sb * (1.0f / kG);
        float qa = 0.0f, qb = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[m][j][0] -= mua;
          acc[m][j][1] -= mua;
          acc[m][j][2] -= mub;
          acc[m][j][3] -= mub;
          qa += acc[m][j][0] * acc[m][j][0] + acc[m][j][1] * acc[m][j][1];
          qb += acc[m][j][2] * acc[m][j][2] + acc[m][j][3] * acc[m][j][3];
        }
        qa += __shfl_xor_sync(kFull, qa, 1);
        qa += __shfl_xor_sync(kFull, qa, 2);
        qb += __shfl_xor_sync(kFull, qb, 1);
        qb += __shfl_xor_sync(kFull, qb, 2);
        const float ia = 1.0f / sqrtf(qa * (1.0f / kG) + eps);
        const float ib = 1.0f / sqrtf(qb * (1.0f / kG) + eps);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = ad * kG + 8 * j + 2 * q;
          const float g0 = gelu_s(acc[m][j][0] * ia * s.lns[c] + s.lnb[c]);
          const float g1 =
              gelu_s(acc[m][j][1] * ia * s.lns[c + 1] + s.lnb[c + 1]);
          const float g2 = gelu_s(acc[m][j][2] * ib * s.lns[c] + s.lnb[c]);
          const float g3 =
              gelu_s(acc[m][j][3] * ib * s.lns[c + 1] + s.lnb[c + 1]);
          // n-tile j is k-step j / 2: registers 0, 1 (j even) or 2, 3.
          const int ks = j >> 1, hf = (j & 1) * 2;
          split2(g0, g1, gh[m][ks][hf], gl[m][ks][hf]);
          split2(g2, g3, gh[m][ks][hf + 1], gl[m][ks][hf + 1]);
        }
      }

      // ---- stage 2, contraction and statistics, 32 columns (e, f) ----
      for (int ef = 0; ef < 4; ++ef) {
        float y[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[m][j][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kG / 16; ++ks) {
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            uint32_t bh[4], bl[4];
            const uint32_t o = (32 * ef + 8 * j) * kW2S * 2 + ks * 32;
            ldsm_x4(bh, w2_hi + o);
            ldsm_x4(bl, w2_lo + o);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(y[m][j], gl[m][ks], bh[0], bh[1]);
              mma_bf16(y[m][j + 1], gl[m][ks], bh[2], bh[3]);
              mma_bf16(y[m][j], gh[m][ks], bl[0], bl[1]);
              mma_bf16(y[m][j + 1], gh[m][ks], bl[2], bl[3]);
              mma_bf16(y[m][j], gh[m][ks], bh[0], bh[1]);
              mma_bf16(y[m][j + 1], gh[m][ks], bh[2], bh[3]);
            }
          }
        }
        // Logits of the warp's 32 rows: mt[m][h][t], row 16 m + 8 h + r0.
        float mt[2][2][3];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int t = 0; t < 3; ++t) mt[m][0][t] = mt[m][1][t] = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 32 * ef + 8 * j + 2 * q;
            const float u0 = gelu_s(y[m][j][0] + s.b2[c]);
            const float u1 = gelu_s(y[m][j][1] + s.b2[c + 1]);
            const float u2 = gelu_s(y[m][j][2] + s.b2[c]);
            const float u3 = gelu_s(y[m][j][3] + s.b2[c + 1]);
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              mt[m][0][t] =
                  fmaf(u0, hy[t][j][0], fmaf(u1, hy[t][j][1], mt[m][0][t]));
              mt[m][1][t] =
                  fmaf(u2, hy[t][j][0], fmaf(u3, hy[t][j][1], mt[m][1][t]));
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              mt[m][h][t] += __shfl_xor_sync(kFull, mt[m][h][t], 1);
              mt[m][h][t] += __shfl_xor_sync(kFull, mt[m][h][t], 2);
            }
        }
        const int X = x_me + 2 * (ad & 1) + (ef & 1);
        const int Y = y_me + 2 * (ad >> 1) + (ef >> 1);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float m = q == 0 ? mt[0][0][t]
                          : q == 1 ? mt[0][1][t]
                          : q == 2 ? mt[1][0][t]
                                   : mt[1][1][t];
          const bool pos = v_me && m > thr;
          const int c_hi = __popc(__ballot_sync(kFull, v_me && m > thr + off));
          const int c_lo = __popc(__ballot_sync(kFull, v_me && m > thr - off));
          const int c_pos = __popc(__ballot_sync(kFull, pos));
          const int xmn = __reduce_min_sync(kFull, pos ? X : INT_MAX);
          const int ymn = __reduce_min_sync(kFull, pos ? Y : INT_MAX);
          const int xmx = __reduce_max_sync(kFull, pos ? X : INT_MIN);
          const int ymx = __reduce_max_sync(kFull, pos ? Y : INT_MIN);
          if (lane == ef * 3 + t) {
            s_hi += c_hi;
            s_lo += c_lo;
            s_pos += c_pos;
            s_xmn = min(s_xmn, xmn);
            s_ymn = min(s_ymn, ymn);
            s_xmx = max(s_xmx, xmx);
            s_ymx = max(s_ymx, ymx);
          }
        }
      }
    }

    // ---- the item's statistics: warps folded in order, one scratch row
    if (lane < 12) {
      int* r = s.red + (warp * 12 + lane) * 7;
      r[0] = s_hi;
      r[1] = s_lo;
      r[2] = s_xmn;
      r[3] = s_ymn;
      r[4] = s_xmx;
      r[5] = s_ymx;
      r[6] = s_pos;
    }
    __syncthreads();
    if (tid < 12) {
      int v[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) v[k] = s.red[tid * 7 + k];
      for (int w = 1; w < C::kWarps; ++w) {
        const int* r = s.red + (w * 12 + tid) * 7;
        v[0] += r[0];
        v[1] += r[1];
        v[2] = min(v[2], r[2]);
        v[3] = min(v[3], r[3]);
        v[4] = max(v[4], r[4]);
        v[5] = max(v[5], r[5]);
        v[6] += r[6];
      }
      float* out = partial + static_cast<int64_t>(item) * kStats;
      out[0 * 12 + tid] = static_cast<float>(v[0]);
      out[1 * 12 + tid] = static_cast<float>(v[1]);
      out[2 * 12 + tid] = v[2] == INT_MAX ? kBig : static_cast<float>(v[2]);
      out[3 * 12 + tid] = v[3] == INT_MAX ? kBig : static_cast<float>(v[3]);
      out[4 * 12 + tid] = v[4] == INT_MIN ? -kBig : static_cast<float>(v[4]);
      out[5 * 12 + tid] = v[5] == INT_MIN ? -kBig : static_cast<float>(v[5]);
      out[6 * 12 + tid] = static_cast<float>(v[6]);
      out[7 * 12 + tid] = 0.0f;
    }
  }
  cp_async_wait_all();  // nothing left in flight when the block ends
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

template <bool F32, typename T>
int launch(const void* keys, const void* hyper, const void* w1s,
           const void* b1, const void* lns, const void* lnb, const void* w2s,
           const void* b2, void* partial, void* stats, int P, int N, int side,
           float thr, float off, float eps, cudaStream_t st) {
  using C = Cfg<F32>;
  auto kern = decode_tail_mma_kernel<F32, T>;
  static bool attr_set[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int n_sm[16] = {};
  if (dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  const int n_tiles = (N + C::kRows - 1) / C::kRows;
  const int n_items = P * n_tiles;
  const int grid = n_items < n_sm[dev] ? n_items : n_sm[dev];
  kern<<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const T*>(keys), static_cast<const float*>(hyper),
      static_cast<const __nv_bfloat16*>(w1s), static_cast<const float*>(b1),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const __nv_bfloat16*>(w2s), static_cast<const float*>(b2),
      static_cast<float*>(partial), N, side, n_tiles, n_items, thr, off, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_tiles_kernel<<<P, kStats, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys (P, N, 256) float32 or bfloat16 (is_bf16), N = side * side, 16-byte
// aligned; hyper (P, 3, 32) float32; w1s (2, 256, 256) bf16: hi and lo of
// W1^T ([out][in]); b1 / lns / lnb (256) float32; w2s (2, 128, 64) bf16:
// hi and lo of W2^T; b2 (128) float32; partial (P, ceil(N / rows), 8, 12)
// float32 scratch (rows: 256 tokens for bf16 keys, 128 for float32, as
// Cfg::kRows); stats (P, 8, 12) float32 out.
// Returns the CUDA error of the launches.
extern "C" int decode_tail_stats(const void* keys, const void* hyper,
                                 const void* w1s, const void* b1,
                                 const void* lns, const void* lnb,
                                 const void* w2s, const void* b2,
                                 void* partial, void* stats, int P, int N,
                                 int side, float thr, float off, float eps,
                                 int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<false, __nv_bfloat16>(keys, hyper, w1s, b1, lns, lnb, w2s,
                                        b2, partial, stats, P, N, side, thr,
                                        off, eps, st);
  return launch<true, float>(keys, hyper, w1s, b1, lns, lnb, w2s, b2, partial,
                             stats, P, N, side, thr, off, eps, st);
}
