// Furthest point sampling on Hopper (sm_90a).
//
// Replaces the TPU kernel sam6d_tpu/ops/pallas/fps_kernel.py:fps_pallas
// (_fps_kernel, whole batch in one program, and _fps_kernel_rowgrid, one
// row per program).  Semantics are those of its XLA oracle
// sam6d_tpu/ops/fps.py:_fps_xla: the first index is 0, the min-distance
// field starts at +inf, and each step takes the argmax of the field with
// ties going to the lowest index (jnp.argmax).
//
// What bounds it: FPS is a chain of npoint dependent steps (each argmax
// picks the point the next step measures from), so it is latency-bound,
// not bound by bytes or operations.  One step is one pass over the row
// plus one block-wide argmax (two barriers); the roofline figure of the
// whole call is tiny next to npoint x that latency.
//
// Design: one block per row.  While 16 * N bytes fit in shared memory
// (N <= 12800 here: every per-frame call, 2048 points) the points (as
// structure of arrays) and the distance field live in shared memory for
// the whole selection loop.  Above that (the 210k-point onboarding cloud)
// the points stay in device memory and the field in a device scratch
// row; at 210k points both (3.4 MB) stay resident in the 50 MB L2.  The
// block argmax is a warp-shuffle reduction, then one across the warps.
//
// d2 is formed as ((dx*dx + dy*dy) + dz*dz) with explicitly rounded
// operations (no FMA contraction), the order _fps_xla is written in and
// runs in op by op, so the kernel picks the same index as the plain
// version at every near-tie.  (Compiled XLA on a CPU contracts the sum
// into fused multiply-adds and can pick another point at a near-tie.)

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <bool kShared>
__global__ void fps_kernel(const float* __restrict__ pts,
                           float* __restrict__ dist_scratch,
                           int64_t* __restrict__ out, int n, int npoint) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_best;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* p = pts + static_cast<int64_t>(blockIdx.x) * n * 3;
  int64_t* o = out + static_cast<int64_t>(blockIdx.x) * npoint;

  float* xs = smem;
  float* ys = smem + n;
  float* zs = smem + 2 * n;
  float* ds = kShared ? smem + 3 * n
                      : dist_scratch + static_cast<int64_t>(blockIdx.x) * n;
  for (int j = tid; j < n; j += nthreads) {
    if (kShared) {
      xs[j] = p[3 * j];
      ys[j] = p[3 * j + 1];
      zs[j] = p[3 * j + 2];
    }
    ds[j] = INFINITY;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    float lx, ly, lz;
    if (kShared) {
      lx = xs[last];
      ly = ys[last];
      lz = zs[last];
    } else {
      lx = p[3 * last];
      ly = p[3 * last + 1];
      lz = p[3 * last + 2];
    }
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < n; j += nthreads) {
      float d2;
      if (kShared) {
        d2 = sq_dist(xs[j], ys[j], zs[j], lx, ly, lz);
      } else {
        d2 = sq_dist(p[3 * j], p[3 * j + 1], p[3 * j + 2], lx, ly, lz);
      }
      const float d = fminf(ds[j], d2);
      ds[j] = d;
      if (d > bv) {  // j only grows: strict > keeps the lowest index
        bv = d;
        bi = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                  __shfl_down_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      const int nwarps = nthreads >> 5;
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                    __shfl_down_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) {
        s_best = bi;
        o[s] = bi;
      }
    }
    __syncthreads();
    last = s_best;
  }
}

}  // namespace

// pts (b, n, 3) f32, out (b, npoint) int64.  use_shared selects the
// shared-memory variant (16 * n bytes of dynamic shared memory); the
// device variant needs dist_scratch (b, n) f32.  threads: a multiple of
// 32, at most 1024.  Returns cudaGetLastError() after the launch.
extern "C" int fps_launch(const void* pts, void* dist_scratch, void* out,
                          int b, int n, int npoint, int threads,
                          int use_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  int64_t* o = static_cast<int64_t*>(out);
  if (use_shared) {
    const size_t smem = static_cast<size_t>(16) * n;
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fps_kernel<true><<<b, threads, smem, st>>>(p, nullptr, o, n, npoint);
  } else {
    fps_kernel<false><<<b, threads, 0, st>>>(
        p, static_cast<float*>(dist_scratch), o, n, npoint);
  }
  return static_cast<int>(cudaGetLastError());
}
