// Batched weighted Procrustes (rigid alignment by a weighted 3x3 SVD) on
// Hopper (sm_90a): the whole solve of a problem in one launch.
//
// Replaces no TPU kernel: its counterpart is the XLA fusion that jit makes
// of sam6d_tpu/ops/procrustes.py:26 weighted_procrustes (with
// sam6d_tpu/ops/svd3.py's struct-of-arrays SVD).  Eagerly on the card the
// plain version (ops/procrustes.py:weighted_procrustes_plain and
// ops/svd3.py) is about 1670 launches of elementwise kernels a call, each
// a few microseconds of host time for almost no device work; the pose
// solves of a PEM frame call it twice.  This kernel is that computation,
// operation for operation, in one launch:
//
//   w = where(w < thresh, 0, w) / (sum(w) + eps)      (w = 1 without weights)
//   cs = sum_n w_n src_n,  cr = sum_n w_n ref_n
//   H_ij = sum_n (src_ni - cs_i) ((ref_nj - cr_j) w_n)
//   A = H^T H, six cyclic Jacobi sweeps over (0,1), (0,2), (1,2) -> V, s^2;
//   the descending compare-swap sort; U from H V / s with the same rank
//   tests (1e-6 s1, 1e-4 s1), Gram-Schmidt and cross-product completion;
//   the det-sign fix on V's third column; R = V U^T, t = cr - R cs.
//
// Numerics.  float32 throughout, every operation written as an explicitly
// rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn) in the plain version's association order, so the compiler
// contracts nothing into a fused multiply-add: a near-tie among the coarse
// stage's hypotheses then resolves as it does in the plain version.  The
// sums of the thread route take the order in which PyTorch's reduction
// kernel (ATen/native/cuda/Reduce.cuh) sums a dim of 3 values: along the
// points, a strided dim, (x0 + x1) + x2; along a contiguous last dim
// (x0 + x2) + x1.  The block route sums in its own order (a thread's
// points in turn, then a butterfly over the warp and the warps in turn),
// so it agrees with the plain version to rounding.
//
// What bounds it: latency more than bytes or operations.  The coarse
// solve's (16 x 6000) problems of 3 points read 6.9 MB and write 4.6 MB
// (3.4 us at 3.35 TB/s) and do about 1.3k float32 operations each (some
// 120 of them divisions and square roots, in a dependent chain); the fine
// solve's 16 problems of 2048 points read 3.1 MB, but pass through three
// block reductions and one thread's serial solve.  On an H100 the two take
// 16 and 13 us; the plain version's launches took 14-16 ms of host time.
//
// Routes (the wrapper picks by n, the points of one problem):
//   thread  n = 3 (the coarse stage's three-point hypotheses): one thread
//           a problem; its points, H, A and V stay in registers.
//   block   any n (the fine stage's 2048 correspondences): one block of
//           256 threads a problem, in three passes over the points as the
//           plain version makes them (the weights' sum; the two centroids;
//           H over the centred points: never the one-pass
//           sum w s r^T - cs cr^T, which cancels differently), each ending
//           in a block reduction; then one thread solves the 3x3.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kEps = 1e-12f;  // _EPS of ops/svd3.py
constexpr int kJacobiSweeps = 6;  // _JACOBI_SWEEPS of ops/svd3.py
constexpr int kThreadBlock = 128;
constexpr int kBlockThreads = 256;
constexpr int kWarps = kBlockThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp_min on the card: NaN passes, else the larger.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

struct Vec3 {
  float x[3];
};

__device__ __forceinline__ float dot3(const Vec3& a, const Vec3& b) {
  return add(add(mul(a.x[0], b.x[0]), mul(a.x[1], b.x[1])),
             mul(a.x[2], b.x[2]));
}

__device__ __forceinline__ Vec3 cross(const Vec3& a, const Vec3& b) {
  return {{sub(mul(a.x[1], b.x[2]), mul(a.x[2], b.x[1])),
           sub(mul(a.x[2], b.x[0]), mul(a.x[0], b.x[2])),
           sub(mul(a.x[0], b.x[1]), mul(a.x[1], b.x[0]))}};
}

// svd3.py:_norm3 and normalize.
__device__ __forceinline__ Vec3 normalize(const Vec3& u) {
  const float n = __fsqrt_rn(clamp_min(dot3(u, u), kEps));
  return {{div(u.x[0], n), div(u.x[1], n), div(u.x[2], n)}};
}

// u - d v, componentwise.
__device__ __forceinline__ Vec3 minus_scaled(const Vec3& u, float d,
                                             const Vec3& v) {
  return {{sub(u.x[0], mul(d, v.x[0])), sub(u.x[1], mul(d, v.x[1])),
           sub(u.x[2], mul(d, v.x[2]))}};
}

__device__ __forceinline__ Vec3 divided(const Vec3& u, float s) {
  const float d = clamp_min(s, kEps);
  return {{div(u.x[0], d), div(u.x[1], d), div(u.x[2], d)}};
}

// svd3.py:any_orthonormal: a unit vector orthogonal to v, crossed with the
// axis of v's smallest component (the first of equal ones).
__device__ __forceinline__ Vec3 any_orthonormal(const Vec3& v) {
  const float ax = fabsf(v.x[0]), ay = fabsf(v.x[1]), az = fabsf(v.x[2]);
  const bool use_x = ax <= ay && ax <= az;
  const bool use_y = !use_x && ay <= az;
  const Vec3 e = {{use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f,
                   use_x || use_y ? 0.0f : 1.0f}};
  return normalize(cross(v, e));
}

// svd3.py:_rot_coeffs: the rotation (c, s) that zeroes a_pq.
__device__ __forceinline__ void rot_coeffs(float app, float aqq, float apq,
                                           float& c, float& s) {
  const bool safe = fabsf(apq) > kEps;
  const float tau = div(sub(aqq, app), mul(safe ? apq : 1.0f, 2.0f));
  const float sign = tau >= 0.0f ? 1.0f : -1.0f;
  float t = div(sign, add(fabsf(tau), __fsqrt_rn(add(mul(tau, tau), 1.0f))));
  t = safe ? t : 0.0f;
  c = div(1.0f, __fsqrt_rn(add(mul(t, t), 1.0f)));
  s = mul(t, c);
}

// One rotation of svd3.py:_eigh3x3_soa in the (P, Q) plane; O is the third
// index.  a is symmetric and kept whole.
template <int P, int Q, int O>
__device__ __forceinline__ void jacobi_rotate(float (&a)[3][3],
                                              float (&v)[3][3]) {
  float c, s;
  rot_coeffs(a[P][P], a[Q][Q], a[P][Q], c, s);
  const float app = a[P][P], aqq = a[Q][Q], apq = a[P][Q];
  const float apo = a[P][O], aqo = a[Q][O];
  const float cc = mul(c, c), ss = mul(s, s), sc2 = mul(mul(s, 2.0f), c);
  a[P][P] = add(sub(mul(cc, app), mul(sc2, apq)), mul(ss, aqq));
  a[Q][Q] = add(add(mul(ss, app), mul(sc2, apq)), mul(cc, aqq));
  a[P][Q] = a[Q][P] = 0.0f;
  a[P][O] = a[O][P] = sub(mul(c, apo), mul(s, aqo));
  a[Q][O] = a[O][Q] = add(mul(s, apo), mul(c, aqo));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = v[i][P], vq = v[i][Q];
    v[i][P] = sub(mul(c, vp), mul(s, vq));
    v[i][Q] = add(mul(s, vp), mul(c, vq));
  }
}

// svd3.py:_sort3_desc's compare-swap of eigenpairs a and b.
__device__ __forceinline__ void cswap(float& wa, float& wb, Vec3& ca,
                                      Vec3& cb) {
  if (wb > wa) {
    const float w = wa;
    wa = wb;
    wb = w;
    const Vec3 c = ca;
    ca = cb;
    cb = c;
  }
}

// det_cols of ops/procrustes.py.
__device__ __forceinline__ float det_cols(const Vec3& c1, const Vec3& c2,
                                          const Vec3& c3) {
  return add(
      sub(mul(c1.x[0], sub(mul(c2.x[1], c3.x[2]), mul(c2.x[2], c3.x[1]))),
          mul(c2.x[0], sub(mul(c1.x[1], c3.x[2]), mul(c1.x[2], c3.x[1])))),
      mul(c3.x[0], sub(mul(c1.x[1], c2.x[2]), mul(c1.x[2], c2.x[1]))));
}

// H, the centroids -> R (row-major 3x3) and t, as svd3.py:svd3x3_soa and
// procrustes.py:weighted_procrustes_plain after the sums.
__device__ void solve(const float (&h)[3][3], const float (&cs)[3],
                      const float (&cr)[3], float* R_out, float* t_out) {
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = add(add(mul(h[0][i], h[0][j]), mul(h[1][i], h[1][j])),
                    mul(h[2][i], h[2][j]));
  float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
#pragma unroll 1
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    jacobi_rotate<0, 1, 2>(a, v);
    jacobi_rotate<0, 2, 1>(a, v);
    jacobi_rotate<1, 2, 0>(a, v);
  }
  float w0 = a[0][0], w1 = a[1][1], w2 = a[2][2];
  Vec3 v1 = {{v[0][0], v[1][0], v[2][0]}};
  Vec3 v2 = {{v[0][1], v[1][1], v[2][1]}};
  Vec3 v3 = {{v[0][2], v[1][2], v[2][2]}};
  cswap(w0, w1, v1, v2);
  cswap(w0, w2, v1, v3);
  cswap(w1, w2, v2, v3);

  const float s1 = __fsqrt_rn(clamp_min(w0, 0.0f));
  const float s2 = __fsqrt_rn(clamp_min(w1, 0.0f));
  const float s3 = __fsqrt_rn(clamp_min(w2, 0.0f));
  const float scale = clamp_min(s1, kEps);
  auto matvec = [&](const Vec3& x) {
    Vec3 r;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      r.x[i] = add(add(mul(h[i][0], x.x[0]), mul(h[i][1], x.x[1])),
                   mul(h[i][2], x.x[2]));
    return r;
  };

  const Vec3 e1 = {{1.0f, 0.0f, 0.0f}};
  const Vec3 u1 =
      normalize(s1 > mul(scale, 1e-6f) ? divided(matvec(v1), s1) : e1);
  const Vec3 u2_raw = s2 > mul(scale, 1e-6f) ? divided(matvec(v2), s2)
                                             : any_orthonormal(u1);
  const Vec3 u2_o = minus_scaled(u2_raw, dot3(u2_raw, u1), u1);
  const Vec3 u2 =
      dot3(u2_o, u2_o) > 1e-12f ? normalize(u2_o) : any_orthonormal(u1);
  const Vec3 u3_cross = cross(u1, u2);
  Vec3 u3 = s3 > mul(scale, 1e-4f) ? normalize(divided(matvec(v3), s3))
                                   : u3_cross;
  u3 = minus_scaled(u3, dot3(u3, u1), u1);
  u3 = minus_scaled(u3, dot3(u3, u2), u2);
  u3 = dot3(u3, u3) > 1e-12f ? normalize(u3) : u3_cross;

  // torch.sign on the card is (0 < x) - (x < 0); a zero takes +1.
  const float dd = mul(det_cols(v1, v2, v3), det_cols(u1, u2, u3));
  float d = static_cast<float>((0.0f < dd) - (dd < 0.0f));
  d = d == 0.0f ? 1.0f : d;
#pragma unroll
  for (int i = 0; i < 3; ++i) v3.x[i] = mul(v3.x[i], d);

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      row[j] = add(add(mul(v1.x[i], u1.x[j]), mul(v2.x[i], u2.x[j])),
                   mul(v3.x[i], u3.x[j]));
      R_out[3 * i + j] = row[j];
    }
    t_out[i] = sub(cr[i], add(add(mul(row[0], cs[0]), mul(row[1], cs[1])),
                              mul(row[2], cs[2])));
  }
}

constexpr int kThreadN = 3;  // the thread route's points a problem

// The thread route's two sum orders (see the head of the file): PyTorch
// sums a strided dim of 3 in turn, a contiguous one as (x0 + x2) + x1.
__device__ __forceinline__ float sum_points(const float (&x)[kThreadN]) {
  return add(add(x[0], x[1]), x[2]);
}

__device__ __forceinline__ float sum_last(const float (&x)[kThreadN]) {
  return add(add(x[0], x[2]), x[1]);
}

__global__ void __launch_bounds__(kThreadBlock)
    procrustes_thread_kernel(const float* __restrict__ src,
                             const float* __restrict__ ref,
                             const float* __restrict__ weights,
                             float* __restrict__ R_out,
                             float* __restrict__ t_out, int64_t problems,
                             float thresh, float eps) {
  constexpr int kN = kThreadN;
  const int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (p >= problems) return;
  float s[kN][3], r[kN][3], w[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[n][k] = src[(p * kN + n) * 3 + k];
      r[n][k] = ref[(p * kN + n) * 3 + k];
    }
    const float wn = weights != nullptr ? weights[p * kN + n] : 1.0f;
    w[n] = wn < thresh ? 0.0f : wn;
  }
  const float den = add(sum_last(w), eps);
#pragma unroll
  for (int n = 0; n < kN; ++n) w[n] = div(w[n], den);

  float cs[3], cr[3], x[kN];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int n = 0; n < kN; ++n) x[n] = mul(s[n][k], w[n]);
    cs[k] = sum_points(x);
#pragma unroll
    for (int n = 0; n < kN; ++n) x[n] = mul(r[n][k], w[n]);
    cr[k] = sum_points(x);
  }
  float h[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
        x[n] = mul(sub(s[n][i], cs[i]), mul(sub(r[n][j], cr[j]), w[n]));
      h[i][j] = sum_last(x);
    }
  solve(h, cs, cr, R_out + 9 * p, t_out + 3 * p);
}

// Sums each of v's K values over the block; every thread ends with the
// totals.  red holds kWarps x K floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = add(v[k], __shfl_xor_sync(kFull, v[k], off));
    if (lane == 0) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float a = red[k];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) a = add(a, red[i * K + k]);
    v[k] = a;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBlockThreads)
    procrustes_block_kernel(const float* __restrict__ src,
                            const float* __restrict__ ref,
                            const float* __restrict__ weights,
                            float* __restrict__ R_out,
                            float* __restrict__ t_out, int n, float thresh,
                            float eps) {
  __shared__ float red[kWarps * 9];
  const int64_t p = blockIdx.x;
  const float* s = src + p * n * 3;
  const float* r = ref + p * n * 3;
  const float* wp = weights != nullptr ? weights + p * n : nullptr;
  auto weight = [&](int i) {
    const float wi = wp != nullptr ? wp[i] : 1.0f;
    return wi < thresh ? 0.0f : wi;
  };

  float total[1] = {0.0f};
  for (int i = threadIdx.x; i < n; i += kBlockThreads)
    total[0] = add(total[0], weight(i));
  block_sum(total, red);
  const float den = add(total[0], eps);

  float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < n; i += kBlockThreads) {
    const float wi = div(weight(i), den);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = add(c[k], mul(s[3 * i + k], wi));
      c[3 + k] = add(c[3 + k], mul(r[3 * i + k], wi));
    }
  }
  block_sum(c, red);

  float hv[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < n; i += kBlockThreads) {
    const float wi = div(weight(i), den);
    float sc[3], rw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sc[k] = sub(s[3 * i + k], c[k]);
      rw[k] = mul(sub(r[3 * i + k], c[3 + k]), wi);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        hv[3 * a + b] = add(hv[3 * a + b], mul(sc[a], rw[b]));
  }
  block_sum(hv, red);

  if (threadIdx.x == 0) {
    const float h[3][3] = {{hv[0], hv[1], hv[2]},
                           {hv[3], hv[4], hv[5]},
                           {hv[6], hv[7], hv[8]}};
    const float cs[3] = {c[0], c[1], c[2]};
    const float cr[3] = {c[3], c[4], c[5]};
    solve(h, cs, cr, R_out + 9 * p, t_out + 3 * p);
  }
}

}  // namespace

// src, ref (problems, n, 3) float32, weights (problems, n) float32 or null
// (every weight 1), R (problems, 3, 3) and t (problems, 3) float32, all
// contiguous.  route 0: one thread a problem (n = 3); route 1: one block a
// problem (n >= 1).  Returns cudaGetLastError() after the launch.
extern "C" int procrustes_launch(const void* src, const void* ref,
                                 const void* weights, void* R, void* t,
                                 long long problems, int n, float thresh,
                                 float eps, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const float* r = static_cast<const float*>(ref);
  const float* w = static_cast<const float*>(weights);
  float* Ro = static_cast<float*>(R);
  float* to = static_cast<float*>(t);
  if (problems < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (problems == 0) return 0;
  if (route == 0 && n == kThreadN) {
    const int64_t blocks = (problems + kThreadBlock - 1) / kThreadBlock;
    procrustes_thread_kernel<<<static_cast<unsigned>(blocks), kThreadBlock, 0,
                               st>>>(s, r, w, Ro, to, problems, thresh, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == 1 && problems <= 0x7fffffffLL) {
    procrustes_block_kernel<<<static_cast<unsigned>(problems), kBlockThreads,
                              0, st>>>(s, r, w, Ro, to, n, thresh, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
