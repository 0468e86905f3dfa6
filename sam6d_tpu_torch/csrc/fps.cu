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
// picks the point the next step measures from), so it is bound by the
// latency of one step, not by bytes or operations.  A step is one pass
// over the row (about 13 instructions a point) and one argmax across
// everything that holds a part of the row.
//
// Design: the plan (ops/fps.py:fps_plan) picks a route by the row's size.
//
//   block    one block a row (256 or 1024 threads).  The row's points
//            live in shared memory as structure of arrays (at 256
//            threads of 8 points, or 1024 of 4, also in registers), each
//            thread's share of the distance field in registers (kPer
//            values).  The argmax of a warp is two redux.sync
//            instructions on order-preserving keys (the field's bits;
//            then the lowest index at the maximum); with
//            more than one warp, one barrier and the same over the warps'
//            candidates, in slots whose parity alternates by step so that
//            a fast warp's next candidate never overwrites a slot that a
//            slow warp is still reading.
//   cluster  one thread-block cluster a row (up to 16 blocks, one SM
//            each).  Block r holds the contiguous chunk [r c, r c + c) of
//            the row in its shared memory and its field in registers.  A
//            step: the block's candidate (one barrier); lane l of warp 0
//            stores it, with its coordinates, into slot r of block l's
//            shared memory (distributed shared memory), the slots' parity
//            alternating by step; one cluster barrier; then every warp
//            reads the C slots from its own block's shared memory and
//            picks the same winner.  No device-memory traffic in the loop,
//            and no remote load on the critical path: the remote stores
//            drain while the block waits at the barrier.
//   global   rows larger than the largest cluster holds: the points stay
//            in device memory and the field in a device scratch row, one
//            block a row (both stay resident in the 50 MB L2).
//
// Each thread owns points tid + i * kThreads, i < kPer: a block's share
// is padded to kPer * kThreads points, the padding's field starts at -inf
// (never the maximum), so the pass has no bounds test and no branch and
// the compiler interleaves the points' independent arithmetic.  Two
// running maxima (even and odd i) halve the dependent compare chain.
//
// Ties go to the lowest index everywhere: a thread visits its points in
// increasing order and keeps the first maximum, and every merge compares
// the global indices.  d2 is formed as ((dx*dx + dy*dy) + dz*dz) with
// explicitly rounded operations (no FMA contraction), the order _fps_xla
// is written in and runs in op by op, so the kernel picks the same index
// as the plain version at every near-tie.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  const bool better = ov > v || (ov == v && oi < i);
  v = better ? ov : v;
  i = better ? oi : i;
}

// A field value as a key whose unsigned order is the values' order: the
// field is >= +0 (a sum of squares) or -inf (no point), and -inf goes
// below every value.
__device__ __forceinline__ unsigned key_of(float v) {
  return v >= 0.0f ? __float_as_uint(v) : 0u;
}

// Argmax over the warp: every lane ends with the largest key and the
// lowest index that holds it.
__device__ __forceinline__ void warp_argmax(unsigned& key, int& i) {
  const unsigned top = __reduce_max_sync(kFull, key);
  i = __reduce_min_sync(kFull, key == top ? i : INT_MAX);
  key = top;
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A block's share of the row: points [base, base + cnt) into shared memory
// as x | y | z, each cap long, the padding past cnt zero.
__device__ __forceinline__ void load_soa(const float* p, int base, int cnt,
                                         int cap, float* smem) {
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const bool in = j < cnt;
    const float* q = p + 3 * static_cast<int64_t>(base + (in ? j : 0));
    smem[j] = in ? q[0] : 0.0f;
    smem[cap + j] = in ? q[1] : 0.0f;
    smem[2 * cap + j] = in ? q[2] : 0.0f;
  }
}

// A block's candidate of one step, in its own shared memory.
struct alignas(16) Slot {
  float x, y, z;
  unsigned key;
  int i;
  int pad[3];
};

// Routes "block" (kCluster false: one block a row) and "cluster" (one
// cluster of C blocks a row; block r holds points [r chunk, r chunk +
// chunk) of it).  A block's points, padded to kPer * kThreads, sit in
// shared memory; with kRegPts each thread also keeps its own in registers.
template <int kPer, bool kRegPts, int kThreads, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
    fps_kernel(const float* __restrict__ pts, int64_t* __restrict__ out,
               int n, int npoint, int chunk) {
  constexpr int kCap = kPer * kThreads;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  __shared__ unsigned red_k[2][32];
  __shared__ int red_i[2][32];
  __shared__ Slot slots[2][kMaxCluster];  // [parity][source block]
  int rank = 0, csize = 1;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    csize = static_cast<int>(cluster.num_blocks());
  }
  const int row = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* p = pts + static_cast<int64_t>(row) * n * 3;
  int64_t* o = out + static_cast<int64_t>(row) * npoint;
  const int base = rank * chunk;
  const int cnt = max(0, min(chunk, n - base));
  const float* xs = smem;
  const float* ys = smem + kCap;
  const float* zs = smem + 2 * kCap;
  load_soa(p, base, cnt, kCap, smem);
  if (rank == 0 && tid == 0) o[0] = 0;
  __syncthreads();

  float d[kPer], px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int jl = tid + i * kThreads;
    d[i] = jl < cnt ? INFINITY : -INFINITY;
    if (kRegPts) {
      px[i] = xs[jl];
      py[i] = ys[jl];
      pz[i] = zs[jl];
    }
  }
  // Lane l < C of warp 0 writes this block's candidate into block l's
  // slot `rank` (cluster route).
  Slot* peer = &slots[0][rank];
  if constexpr (kCluster) {
    peer = cg::this_cluster().map_shared_rank(&slots[0][rank],
                                              lane < csize ? lane : 0);
    // Every block of the cluster runs before any stores into another.
    cg::this_cluster().sync();
  }
  float lx = p[0], ly = p[1], lz = p[2];
  for (int s = 1; s < npoint; ++s) {
    const int par = s & 1;
    // This thread's first maximum, from two interleaved chains.
    float bv[2] = {-INFINITY, -INFINITY};
    int bi[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int jl = tid + i * kThreads;
      const float d2 = kRegPts ? sq_dist(px[i], py[i], pz[i], lx, ly, lz)
                               : sq_dist(xs[jl], ys[jl], zs[jl], lx, ly, lz);
      d[i] = fminf(d[i], d2);
      const bool gt = d[i] > bv[i & 1];  // i only grows: the first max stays
      bv[i & 1] = gt ? d[i] : bv[i & 1];
      bi[i & 1] = gt ? jl : bi[i & 1];
    }
    take_better(bv[0], bi[0], bv[1], bi[1]);
    unsigned key = key_of(bv[0]);
    int idx = bi[0] == INT_MAX ? INT_MAX : base + bi[0];
    warp_argmax(key, idx);
    if (kWarps > 1) {
      if (lane == 0) {
        red_k[par][warp] = key;
        red_i[par][warp] = idx;
      }
      __syncthreads();
      key = lane < kWarps ? red_k[par][lane] : 0u;
      idx = lane < kWarps ? red_i[par][lane] : INT_MAX;
      warp_argmax(key, idx);
    }
    if constexpr (kCluster) {
      if (warp == 0 && lane < csize) {
        const int loc = idx == INT_MAX ? 0 : idx - base;
        Slot* sl = peer + par * kMaxCluster;
        *reinterpret_cast<uint4*>(sl) = make_uint4(
            __float_as_uint(xs[loc]), __float_as_uint(ys[loc]),
            __float_as_uint(zs[loc]), key);
        sl->i = idx;
      }
      // Release this block's candidate to the cluster, acquire theirs.
      cg::this_cluster().sync();
      uint4 c = make_uint4(0u, 0u, 0u, 0u);
      int ci = INT_MAX;
      if (lane < csize) {
        c = *reinterpret_cast<const uint4*>(&slots[par][lane]);
        ci = slots[par][lane].i;
      }
      key = c.w;
      idx = ci;
      warp_argmax(key, idx);
      const int src = __ffs(__ballot_sync(kFull, ci == idx)) - 1;
      lx = __uint_as_float(__shfl_sync(kFull, c.x, src));
      ly = __uint_as_float(__shfl_sync(kFull, c.y, src));
      lz = __uint_as_float(__shfl_sync(kFull, c.z, src));
    } else {
      lx = xs[idx];
      ly = ys[idx];
      lz = zs[idx];
    }
    if (rank == 0 && tid == 0) o[s] = idx;
  }
}

// Route "global": one block a row, points and field in device memory.
__global__ void fps_global_kernel(const float* __restrict__ pts,
                                  float* __restrict__ dist_scratch,
                                  int64_t* __restrict__ out, int n,
                                  int npoint) {
  __shared__ unsigned red_k[2][32];
  __shared__ int red_i[2][32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const float* p = pts + static_cast<int64_t>(blockIdx.x) * n * 3;
  int64_t* o = out + static_cast<int64_t>(blockIdx.x) * npoint;
  float* ds = dist_scratch + static_cast<int64_t>(blockIdx.x) * n;
  for (int j = tid; j < n; j += blockDim.x) ds[j] = INFINITY;
  if (tid == 0) o[0] = 0;
  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float lx = p[3 * last], ly = p[3 * last + 1], lz = p[3 * last + 2];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < n; j += blockDim.x) {
      const float d = fminf(ds[j], sq_dist(p[3 * j], p[3 * j + 1],
                                           p[3 * j + 2], lx, ly, lz));
      ds[j] = d;
      if (d > bv) {
        bv = d;
        bi = j;
      }
    }
    unsigned key = key_of(bv);
    warp_argmax(key, bi);
    const int par = s & 1;
    if (lane == 0) {
      red_k[par][warp] = key;
      red_i[par][warp] = bi;
    }
    __syncthreads();
    key = lane < nwarps ? red_k[par][lane] : 0u;
    bi = lane < nwarps ? red_i[par][lane] : INT_MAX;
    warp_argmax(key, bi);
    if (tid == 0) o[s] = bi;
    last = bi;
  }
}

template <int kPer, bool kRegPts, int kThreads, bool kCluster>
int launch(const float* p, int64_t* o, int b, int n, int npoint, int cluster,
           cudaStream_t st) {
  const int chunk = kCluster ? (n + cluster - 1) / cluster : n;
  if (chunk > kPer * kThreads ||
      (kCluster && (cluster < 2 || cluster > kMaxCluster)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(12) * kPer * kThreads;
  auto kern = fps_kernel<kPer, kRegPts, kThreads, kCluster>;
  // The instance's attributes are set at its first launch; the clusters it
  // can place, at the first launch of each cluster size.
  static bool attrs_set = false;
  static int active_for[kMaxCluster + 1] = {0};
  int err = 0;
  if (!attrs_set) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err == 0 && kCluster)
      err = static_cast<int>(cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (err != 0) return err;
    attrs_set = true;
  }
  if (!kCluster) {
    kern<<<b, kThreads, smem, st>>>(p, o, n, npoint, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(kThreads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster that the card cannot place would never run: refuse it.
  int& active = active_for[cluster];
  if (active == 0) {
    err = static_cast<int>(
        cudaOccupancyMaxActiveClusters(&active, kern, &cfg));
    if (err != 0) return err;
    if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kern, p, o, n, npoint,
                                            chunk));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The 1024-thread instances, by points a thread (a cluster's blocks hold
// more than 4096 points each).
template <bool kCluster>
int launch_1024(const float* p, int64_t* o, int b, int n, int npoint,
                int cluster, int per, cudaStream_t st) {
  switch (per) {
    case 4:
      if constexpr (!kCluster)
        return launch<4, true, 1024, false>(p, o, b, n, npoint, 1, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 8:
      return launch<8, false, 1024, kCluster>(p, o, b, n, npoint, cluster,
                                              st);
    case 10:
      return launch<10, false, 1024, kCluster>(p, o, b, n, npoint, cluster,
                                               st);
    case 13:
      return launch<13, false, 1024, kCluster>(p, o, b, n, npoint, cluster,
                                               st);
    case 16:
      return launch<16, false, 1024, kCluster>(p, o, b, n, npoint, cluster,
                                               st);
    case 18:
      return launch<18, false, 1024, kCluster>(p, o, b, n, npoint, cluster,
                                               st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pts (b, n, 3) f32, out (b, npoint) int64; the route and its geometry
// come from ops/fps.py:fps_plan.  route 0 "block": 256 threads of 8
// points (in registers), or 1024 threads of per in {4, 8, 10, 13, 16,
// 18}; route 1 "cluster": cluster blocks a row of 1024 threads of per in
// {8, 10, 13, 16, 18}; route 2 "global": dist_scratch (b, n) f32,
// threads a block.  Returns the CUDA error of the launch; a geometry
// that no instance takes returns cudaErrorInvalidValue, a cluster that
// cannot be scheduled cudaErrorLaunchOutOfResources.
extern "C" int fps_launch(const void* pts, void* dist_scratch, void* out,
                          int b, int n, int npoint, int route, int cluster,
                          int threads, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  int64_t* o = static_cast<int64_t*>(out);
  if (route == 0 && threads == 256 && per == 8)
    return launch<8, true, 256, false>(p, o, b, n, npoint, 1, st);
  if (route == 0 && threads == 1024)
    return launch_1024<false>(p, o, b, n, npoint, 1, per, st);
  if (route == 1 && threads == 1024)
    return launch_1024<true>(p, o, b, n, npoint, cluster, per, st);
  if (route == 2 && threads % 32 == 0 && threads <= 1024) {
    fps_global_kernel<<<b, threads, 0, st>>>(
        p, static_cast<float*>(dist_scratch), o, n, npoint);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
