// Row scatter-add (the backward of a row gather) on Hopper (sm_90a), as an
// inverse index: a stable counting sort of the indices, then a gather-sum
// per target.
//
// Replaces the TPU kernel sam6d_tpu/ops/pallas/scatter_rows.py:65
// scatter_rows_pallas (kernel _scatter_rows_kernel):
//
//   out[b, n, :] = sum over q with idx[b, q] == n of dy[b, q, :]
//
// in float32; rows whose index lies outside [0, N) are dropped (the caller's
// negative padding; the TPU kernel's one-hot tile matches no row for them).
//
// Order of the sums.  Every target's rows are added one after another in
// ascending q, in float32, starting from 0.0f (bf16 -> float32 is exact), so
// two launches give the same bits, and the result equals a sequential
// float32 sum in index order (the CPU's index_add_) bit for bit.  Every
// output row is written exactly once (a target without rows as zeros), so
// the output needs no memset.
//
// Four launches a call, on the caller's stream, with no host
// synchronisation (every size follows from B, Q, N, C and the plan):
//   1. scatter_rows_count_kernel, one block a (tile of `tile` rows, b): a
//      histogram of the tile's kept rows in shared memory (N counters,
//      shared atomics), written to counts (B, tiles, N) int32.
//   2. scatter_rows_scan_kernel, one block a b: offsets (B, N + 1) int32,
//      the exclusive scan over n of the targets' totals; in place of each
//      tile's count, its base (the target's offset plus the counts of the
//      earlier tiles); zeros for the targets without rows; and unit_first
//      (B, units + 1), where the sum kernel's units of unit_rows positions
//      of perm begin.
//   3. scatter_rows_place_kernel, one block a (tile, b): the tile's keys in
//      shared memory; each warp counts its contiguous segment into a row of
//      16-bit counters (shared atomics), the counters are scanned over
//      (target, warp) into tile-local places, and each warp walks its
//      segment in order, 32 rows at a time, placing each row at its
//      target's cursor plus its rank among the lower lanes with the same
//      target (11 ballots a walk at N = 2048: one a bit of the key).  The
//      tile's rows, so sorted in shared memory, are stored to perm (B, Q)
//      int32 in that order, a target's rows from the tile side by side.
//      perm thus holds each target's rows grouped, in ascending q: a stable
//      counting sort, with no comparison and no library sort.
//   4. scatter_rows_sum_kernel<T, VEC>, one warp a unit (the targets of one
//      b whose rows start in a window of unit_rows positions of perm): the
//      warp streams the unit's rows in rounds of 32 x 4 vectors of VEC
//      bytes (32 rows of 32 bf16 channels), copied asynchronously
//      (cp.async) into a ring of three rounds in shared memory, two in
//      flight while one is added; lane c adds channel c (and c + 32, ...)
//      of each row in order and writes a target's row where its rows end.
//
// What bounds it: bytes.  At the fine-stage positional encoding's larger
// scale (B = 28, N = 2048, Q = 2048 * 64, C = 32, bf16) the function reads
// 235 MB of dy and 29 MB of indices and writes 7 MB: 0.0811 ms at 3.35 TB/s.
// This design moves more: idx read twice (58.7 MB), perm written and read
// (29.4 MB), dy (234.9 MB), out (7.3 MB) and the tile counts (4 passes of
// 3.7 MB, mostly in L2): about 345 MB, 0.103 ms.  dy is read in perm
// order, 64-byte rows at scattered addresses.
//
// Skew.  The ball query takes the first S in-radius points in scan order,
// so the lowest-index points of every neighbourhood are hit by nearly every
// neighbour: over 1200 rows a target at S = 64, one stretch of a warp's
// stream.  Each of the N query rows gives a target one hit, or more only
// when the row has fewer than S points in its radius and the target is its
// first; so on the encoding's own indices a target has about N rows at most
// (a cloud whose points all lie within the radius of each other gives S
// targets of exactly N rows each).  A target of many more rows, as when
// every row goes to one target, is one warp's stream and sets the kernel's
// time.

// The TPU kernel turned the scatter into a one-hot matmul (the TPU has no
// atomics, and sums in a fixed order); the first CUDA version added with
// float2 atomics, whose order changed from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountThreads = 256;
constexpr int kCountBatch = 8;  // index loads in flight a thread
constexpr int kScanThreads = 1024;
constexpr int kSumWarps = 8;
constexpr int kSumUnits = 4;  // vector loads a lane issues a round
constexpr int kStages = 3;  // rounds a warp of the sum kernel holds
constexpr int kMaxAcc = 4;  // channels a lane sums: C <= 128

__device__ __forceinline__ int key_of(int64_t n, int n_targets) {
  return (n >= 0 && n < n_targets) ? static_cast<int>(n) : -1;
}

__device__ __forceinline__ bool leads(unsigned peers, int lane) {
  return lane == __ffs(peers) - 1;
}

// The lanes whose key equals this lane's (keys in [-1, 2^bits)): one ballot
// for validity and one a bit of the key.
__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  const unsigned valid = __ballot_sync(kFull, key >= 0);
  unsigned peers = key >= 0 ? valid : ~valid;
  for (int i = 0; i < bits; ++i) {
    const bool set = (key >> i) & 1;
    const unsigned m = __ballot_sync(kFull, set);
    peers &= set ? m : ~m;
  }
  return peers;
}

__global__ void __launch_bounds__(kCountThreads)
    scatter_rows_count_kernel(const int64_t* __restrict__ idx,
                              int* __restrict__ counts, int q_per_batch,
                              int n_targets, int tile, int tiles) {
  extern __shared__ int hist[];  // n_targets
  const int t = blockIdx.x, b = blockIdx.y;
  for (int n = threadIdx.x; n < n_targets; n += blockDim.x) hist[n] = 0;
  __syncthreads();
  const int q0 = t * tile;
  const int q1 = min(q0 + tile, q_per_batch);
  const int64_t* row = idx + static_cast<int64_t>(b) * q_per_batch;
  for (int base = q0; base < q1; base += kCountThreads * kCountBatch) {
    int key[kCountBatch];
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      const int q = base + k * kCountThreads + threadIdx.x;
      key[k] = q < q1 ? key_of(__ldg(row + q), n_targets) : -1;
    }
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k)
      if (key[k] >= 0) atomicAdd(&hist[key[k]], 1);
  }
  __syncthreads();
  int* out = counts + (static_cast<int64_t>(b) * tiles + t) * n_targets;
  for (int n = threadIdx.x; n < n_targets; n += blockDim.x) out[n] = hist[n];
}

// Exclusive scan of x over the block (at most 1024 threads, a whole number
// of warps); *total gets the sum.
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = (warp ? warp_sums[warp - 1] : 0) + inc - x;
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is rewritten by the next scan
  return excl;
}

__global__ void __launch_bounds__(kScanThreads)
    scatter_rows_scan_kernel(int* __restrict__ counts,
                             int* __restrict__ offsets,
                             int* __restrict__ unit_first,
                             float* __restrict__ out, int n_targets, int C,
                             int tiles, int unit_rows, int units) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int b = blockIdx.x;
  int* cnt = counts + static_cast<int64_t>(b) * tiles * n_targets;
  int* off = offsets + static_cast<int64_t>(b) * (n_targets + 1);
  int carry = 0;
  for (int n0 = 0; n0 < n_targets; n0 += kScanThreads) {
    const int n = n0 + threadIdx.x;
    int total = 0;
    if (n < n_targets) {
#pragma unroll 8
      for (int t = 0; t < tiles; ++t)
        total += cnt[static_cast<int64_t>(t) * n_targets + n];
    }
    int sum;
    const int excl = carry + block_scan(total, warp_sums, &sum);
    carry += sum;
    if (n < n_targets) {
      off[n] = excl;
      int run = excl;
#pragma unroll 8
      for (int t = 0; t < tiles; ++t) {
        int* p = cnt + static_cast<int64_t>(t) * n_targets + n;
        const int c = *p;
        *p = run;
        run += c;
      }
      // Targets without rows get their zeros here: the sum kernel passes
      // over them.
      if (total == 0 && out != nullptr) {
        float2* z = reinterpret_cast<float2*>(
            out + (static_cast<int64_t>(b) * n_targets + n) * C);
        for (int i = 0; i < C / 2; ++i) z[i] = make_float2(0.0f, 0.0f);
      }
    }
  }
  if (threadIdx.x == 0) off[n_targets] = carry;
  __syncthreads();  // off is complete (the block's own global writes)
  // The sum kernel's unit j of this b (one warp) takes the targets whose
  // rows start in [j, j + 1) * unit_rows: unit_first[j] = #{n : off[n] <
  // j * unit_rows}, and unit_first[units] = N (the last unit takes the rest).
  int* first = unit_first + static_cast<int64_t>(b) * (units + 1);
  for (int j = threadIdx.x; j <= units; j += blockDim.x) {
    int lo = 0, hi = n_targets;
    if (j < units) {
      const int at = j * unit_rows;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] < at)
          lo = mid + 1;
        else
          hi = mid;
      }
    }
    first[j] = j < units ? lo : n_targets;
  }
}

// Shared memory of the placement: the tile's keys and its rows sorted by
// target (int32 each), the shift from a row's place in the tile's sorted
// list to its place in perm, one a target (int32), and a row of counters a
// warp (uint16: a tile holds at most 8192 rows).
__global__ void __launch_bounds__(256)
    scatter_rows_place_kernel(const int64_t* __restrict__ idx,
                              const int* __restrict__ bases,
                              int* __restrict__ perm, int q_per_batch,
                              int n_targets, int tile, int tiles, int bits) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  const int warps = blockDim.x >> 5;
  int* keys = smem;                  // tile
  int* sorted = keys + tile;         // tile
  int* shift = sorted + tile;        // n_targets
  // warps rows of n_targets counters, each row padded to an even count.
  const int stride = n_targets + (n_targets & 1);
  unsigned short* cur = reinterpret_cast<unsigned short*>(shift + n_targets);
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = t * tile;
  const int64_t* row = idx + static_cast<int64_t>(b) * q_per_batch;
  for (int i = threadIdx.x; i < warps * stride; i += blockDim.x) cur[i] = 0;
  for (int base = 0; base < tile; base += blockDim.x * kCountBatch) {
    int64_t v[kCountBatch];
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      const int i = base + k * blockDim.x + threadIdx.x;
      v[k] = (i < tile && q0 + i < q_per_batch) ? __ldg(row + q0 + i) : -1;
    }
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      const int i = base + k * blockDim.x + threadIdx.x;
      if (i < tile) keys[i] = key_of(v[k], n_targets);
    }
  }
  __syncthreads();
  // Each warp counts its contiguous segment of the tile into its row of
  // counters: shared atomics on the 32-bit word that holds two of them (a
  // count stays below 2^16, so no carry crosses into the other).
  const int seg = tile / warps;  // a multiple of 32
  const int* mine = keys + warp * seg;
  unsigned short* my_cur = cur + warp * stride;
  unsigned* my_words = reinterpret_cast<unsigned*>(my_cur);
  for (int j = lane; j < seg; j += 32) {
    const int key = mine[j];
    if (key >= 0) atomicAdd(my_words + (key >> 1), 1u << (16 * (key & 1)));
  }
  __syncthreads();
  // Scan over (n, warp), blockDim targets at a time: warp w then starts
  // target n at the tile-local place of its first row.
  const int* base = bases + (static_cast<int64_t>(b) * tiles + t) * n_targets;
  int kept = 0;
  for (int n0 = 0; n0 < n_targets; n0 += blockDim.x) {
    const int n = n0 + threadIdx.x;
    int total = 0;
    if (n < n_targets)
      for (int w = 0; w < warps; ++w) total += cur[w * stride + n];
    int chunk;
    int run = kept + block_scan(total, warp_sums, &chunk);
    kept += chunk;
    if (n < n_targets) {
      shift[n] = base[n] - run;
      for (int w = 0; w < warps; ++w) {
        const int c = cur[w * stride + n];
        cur[w * stride + n] = static_cast<unsigned short>(run);
        run += c;
      }
    }
  }
  __syncthreads();
  // Each warp walks its segment again, in order: the tile's rows sorted by
  // target, in ascending q within a target.
  const unsigned lower = (1u << lane) - 1u;
  for (int j = 0; j < seg; j += 32) {
    const int key = mine[j + lane];
    const unsigned peers = peers_of(key, bits);
    if (key >= 0)
      sorted[my_cur[key] + __popc(peers & lower)] = warp * seg + j + lane;
    __syncwarp();
    if (key >= 0 && leads(peers, lane)) my_cur[key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // The sorted list in order: a target's rows from this tile land side by
  // side in perm, so neighbouring threads store to neighbouring words.
  int* out = perm + static_cast<int64_t>(b) * q_per_batch;
#pragma unroll 4
  for (int i = threadIdx.x; i < kept; i += blockDim.x) {
    const int q = sorted[i];
    out[shift[keys[q]] + i] = q0 + q;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An asynchronous copy of VEC bytes from device to shared memory
// (cp.async: no register holds the data), and its group fences.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(VEC));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A round: up to `rows` consecutive entries of perm from `pos` (fewer at a
// run's end), read as 32 x kSumUnits vectors of VEC bytes.  A row's `units`
// vectors are spread over a power of two of lanes, 2^shift: a lane's k-th
// vector is part (lane + 32 k) % 2^shift of row (lane + 32 k) >> shift, and
// idle where that part is past the row's end.
template <typename T, int VEC>
struct Round {
  int row_bytes, units, shift, rows, lane;

  __device__ __forceinline__ Round(int C, int lane_) : lane(lane_) {
    row_bytes = C * static_cast<int>(sizeof(T));
    units = row_bytes / VEC;
    shift = 0;
    while ((1 << shift) < units) ++shift;
    rows = (kSumUnits * 32) >> shift;
  }
  __device__ __forceinline__ int row(int k) const {
    return (lane + 32 * k) >> shift;
  }
  __device__ __forceinline__ int part(int k) const {
    return (lane + 32 * k) & ((1 << shift) - 1);
  }
  __device__ __forceinline__ bool on(int k, int h) const {
    return row(k) < h && part(k) < units;
  }
  __device__ __forceinline__ int held(int pos, int end) const {
    return min(rows, end - pos);
  }
  __device__ __forceinline__ void load_perm(const int* pm, int pos, int end,
                                            int (&p)[kSumUnits]) const {
    const int h = held(pos, end);
#pragma unroll
    for (int k = 0; k < kSumUnits; ++k)
      if (on(k, h)) p[k] = __ldg(pm + pos + row(k));
  }
  // The round's rows straight into `slot`, asynchronously.
  __device__ __forceinline__ void issue(unsigned char* slot,
                                        const unsigned char* src, int pos,
                                        int end,
                                        const int (&p)[kSumUnits]) const {
    const int h = held(pos, end);
#pragma unroll
    for (int k = 0; k < kSumUnits; ++k)
      if (on(k, h))
        copy_async<VEC>(slot + row(k) * row_bytes + part(k) * VEC,
                        src + static_cast<int64_t>(p[k]) * row_bytes +
                            part(k) * VEC);
  }
};

// acc[a] += channel lane + 32 a of each of the slot's first h rows, in
// order.  Every lane loads, without a branch (a lane past C reads channel 0
// and its sum is never written), so the loads of eight rows go out before
// their adds, and the adds wait on each other, not on shared memory.
template <typename T>
__device__ __forceinline__ void add_rows(const T* st, int h, int C, int lane,
                                         float (&acc)[kMaxAcc]) {
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    if (32 * a >= C) continue;  // the same for the whole warp
    const int c = lane + 32 * a;
    const T* col = st + (c < C ? c : 0);
    float s = acc[a];
    int r = 0;
#pragma unroll 2
    for (; r + 8 <= h; r += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = to_float(col[(r + j) * C]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += x[j];
    }
    for (; r < h; ++r) s += to_float(col[r * C]);
    acc[a] = s;
  }
}

__device__ __forceinline__ void write_row(float* o, int C, int lane,
                                          const float (&acc)[kMaxAcc]) {
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int c = lane + 32 * a;
    if (c < C) o[c] = acc[a];
  }
}

// off[base + lane] in each lane of a warp; at(n) for a warp-uniform n <= N,
// reloaded when n leaves the window.
struct OffWindow {
  const int* off;
  int n_targets, lane, base, held;

  __device__ __forceinline__ OffWindow(const int* off_, int n, int lane_)
      : off(off_), n_targets(n), lane(lane_), base(INT_MIN / 2), held(0) {}
  __device__ __forceinline__ int at(int n) {
    if (n < base || n >= base + 32) {
      base = n;
      held = n + lane <= n_targets ? __ldg(off + n + lane) : INT_MAX;
    }
    return __shfl_sync(kFull, held, n - base);
  }
};

// The first target in [n, last) with rows, or `last`: 32 targets a ballot
// (n warp-uniform).
__device__ __forceinline__ int next_with_rows(const int* off, int n, int last,
                                              int lane) {
  for (;; n += 32) {
    const int k = n + lane;
    const bool stop = k >= last || __ldg(off + k + 1) > __ldg(off + k);
    const unsigned m = __ballot_sync(kFull, stop);
    if (m) return min(n + __ffs(m) - 1, last);
  }
}

// Each warp takes one unit: the targets of one b whose rows start in a
// window of unit_rows positions of perm (unit_first), units taken j-major.
// The warp streams the unit's rows in rounds, copied asynchronously into
// its ring of kStages rounds in shared memory, two in flight while one is
// added, their perm entries loaded two rounds ahead.  It cuts the sum at
// each target's end (offsets read through a window of 32 held in the
// lanes), writes the target's row, and passes over the targets without
// rows (the scan kernel wrote their zeros).  A target is summed by the warp
// of the unit where its rows start, however long it is.
template <typename T, int VEC>
__global__ void __launch_bounds__(kSumWarps * 32, 2)
    scatter_rows_sum_kernel(const T* __restrict__ dy,
                            const int* __restrict__ offsets,
                            const int* __restrict__ perm,
                            const int* __restrict__ unit_first,
                            float* __restrict__ out, int batch,
                            int q_per_batch, int n_targets, int C,
                            int units) {
  constexpr int kSlot = kSumUnits * 32 * VEC;  // bytes of a round
  extern __shared__ __align__(16) unsigned char ring_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = ring_all + warp * kStages * kSlot;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kSumWarps + warp;
  if (g >= static_cast<int64_t>(batch) * units) return;  // whole warp
  const Round<T, VEC> rd(C, lane);
  const int j = static_cast<int>(g / batch), b = static_cast<int>(g % batch);
  const int* off = offsets + static_cast<int64_t>(b) * (n_targets + 1);
  const int* first = unit_first + static_cast<int64_t>(b) * (units + 1);
  const int last = __ldg(first + j + 1);
  int tc = next_with_rows(off, __ldg(first + j), last, lane);  // summed now
  if (tc >= last) return;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(dy) +
                             static_cast<int64_t>(b) * q_per_batch *
                                 rd.row_bytes;
  const int* pm = perm + static_cast<int64_t>(b) * q_per_batch;
  float* ob = out + static_cast<int64_t>(b) * n_targets * C;
  OffWindow ow(off, n_targets, lane);
  const int lo = ow.at(tc), end = ow.at(last);
  int tend = ow.at(tc + 1);  // where target tc's rows end
  float acc[kMaxAcc] = {};
  // Rounds i + 1 and i + 2 in flight while round i is added (slot i % 3);
  // the perm entries of the round issued next were loaded two rounds
  // before, into one of two register sets in turn.
  static_assert(kStages == 3, "two rounds ahead");
  constexpr int kAhead = kStages - 1;
  int p0[kSumUnits], p1[kSumUnits];
  rd.load_perm(pm, lo, end, p0);
  rd.load_perm(pm, lo + rd.rows, end, p1);
  rd.issue(ring, src, lo, end, p0);
  copy_commit();
  rd.issue(ring + kSlot, src, lo + rd.rows, end, p1);
  copy_commit();
  rd.load_perm(pm, lo + kAhead * rd.rows, end, p0);
  rd.load_perm(pm, lo + (kAhead + 1) * rd.rows, end, p1);
  int slot = 0;
  for (int pos2 = lo; pos2 < end; pos2 += 2 * rd.rows) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pos = pos2 + u * rd.rows;
      if (pos >= end) break;
      int (&p)[kSumUnits] = u == 0 ? p0 : p1;
      const int ahead = slot == 0 ? kStages - 1 : slot - 1;
      rd.issue(ring + ahead * kSlot, src, pos + kAhead * rd.rows, end, p);
      copy_commit();
      rd.load_perm(pm, pos + (kAhead + 2) * rd.rows, end, p);
      copy_wait<kAhead>();  // this round's copies are done
      __syncwarp();
      const T* st = reinterpret_cast<const T*>(ring + slot * kSlot);
      const int h = rd.held(pos, end);
      for (int r = 0; r < h;) {
        const int upto = min(h, tend - pos);
        add_rows(st + r * C, upto - r, C, lane, acc);
        r = upto;
        if (pos + r < tend) continue;
        write_row(ob + static_cast<int64_t>(tc) * C, C, lane, acc);
#pragma unroll
        for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.0f;
        // The next target with rows: most often tc + 1.
        ++tc;
        tend = tc < last ? ow.at(tc + 1) : INT_MAX;
        if (tend == pos + r) {
          tc = next_with_rows(off, tc + 1, last, lane);
          tend = tc < last ? ow.at(tc + 1) : INT_MAX;
        }
      }
      __syncwarp();  // the slot is free for the round after next
      slot = slot == kStages - 1 ? 0 : slot + 1;
    }
  }
  copy_wait<0>();
}

int raise_smem_limit(const void* fn, int bytes, int* set_to) {
  if (bytes <= 48 * 1024 || bytes <= *set_to) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *set_to = bytes;
  return static_cast<int>(e);
}

struct SumArgs {
  const void* dy;
  const int* offsets;
  const int* perm;
  const int* unit_first;
  float* out;
  int B, Q, N, C, units;
};

template <typename T, int VEC>
int launch_sum(const SumArgs& a, cudaStream_t st) {
  static int smem_set = 0;
  const int smem = kSumWarps * kStages * kSumUnits * 32 * VEC;
  const int err = raise_smem_limit(
      reinterpret_cast<const void*>(scatter_rows_sum_kernel<T, VEC>), smem,
      &smem_set);
  if (err) return err;
  const int64_t warps = static_cast<int64_t>(a.B) * a.units;
  const unsigned blocks =
      static_cast<unsigned>((warps + kSumWarps - 1) / kSumWarps);
  scatter_rows_sum_kernel<T, VEC><<<blocks, kSumWarps * 32, smem, st>>>(
      static_cast<const T*>(a.dy), a.offsets, a.perm, a.unit_first, a.out,
      a.B, a.Q, a.N, a.C, a.units);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sum_vec(int vec, const SumArgs& a, cudaStream_t st) {
  if (vec == 16) return launch_sum<T, 16>(a, st);
  if (vec == 8) return launch_sum<T, 8>(a, st);
  return launch_sum<T, 4>(a, st);
}

}  // namespace

// idx (B, Q) int64; dy (B, Q, C) float32 or bfloat16 (is_bf16), rows of
// C * itemsize bytes read as `vec`-byte vectors (vec divides the row and
// dy's alignment; 4, 8 or 16); out (B, N, C) float32.  Scratch, all int32:
// counts (B, tiles, N) with tiles = ceil(Q / tile), offsets (B, N + 1),
// perm (B, Q), unit_first (B, units + 1) with units = max(1, ceil(Q /
// unit_rows)).  tile is a multiple of 32 * place_warps (place_warps a block
// of the placement kernel, 1 to 8).  With out == nullptr the call stops
// after the placement (offsets and perm only; dy is not read).  Returns
// the first nonzero cudaGetLastError() of its launches.
extern "C" int scatter_rows_launch(const void* idx, const void* dy, void* out,
                                   void* counts, void* offsets, void* perm,
                                   void* unit_first, int B, int Q, int N,
                                   int C, int tile, int place_warps,
                                   int unit_rows, int is_bf16, int vec,
                                   void* stream) {
  static int count_smem_set = 0, place_smem_set = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0) return 0;
  const int64_t* ix = static_cast<const int64_t*>(idx);
  int* cnt = static_cast<int*>(counts);
  int* off = static_cast<int*>(offsets);
  int* pm = static_cast<int*>(perm);
  int* uf = static_cast<int*>(unit_first);
  const int tiles = (Q + tile - 1) / tile;
  const int units = max(1, (Q + unit_rows - 1) / unit_rows);
  int err;
  if (tiles > 0) {
    const int smem = N * static_cast<int>(sizeof(int));
    if ((err = raise_smem_limit(
             reinterpret_cast<const void*>(scatter_rows_count_kernel), smem,
             &count_smem_set)))
      return err;
    scatter_rows_count_kernel<<<dim3(tiles, B), kCountThreads, smem, st>>>(
        ix, cnt, Q, N, tile, tiles);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  scatter_rows_scan_kernel<<<B, kScanThreads, 0, st>>>(
      cnt, off, uf, static_cast<float*>(out), N, C, tiles, unit_rows, units);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (tiles > 0) {
    const int smem = 4 * (2 * tile + N) + 2 * place_warps * (N + (N & 1));
    if ((err = raise_smem_limit(
             reinterpret_cast<const void*>(scatter_rows_place_kernel), smem,
             &place_smem_set)))
      return err;
    int bits = 0;
    while ((1 << bits) < N) ++bits;
    scatter_rows_place_kernel<<<dim3(tiles, B), place_warps * 32, smem, st>>>(
        ix, cnt, pm, Q, N, tile, tiles, bits);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (out == nullptr) return 0;
  const SumArgs a{dy, off, pm, uf, static_cast<float*>(out), B, Q, N, C,
                  units};
  return is_bf16 ? launch_sum_vec<__nv_bfloat16>(vec, a, st)
                 : launch_sum_vec<float>(vec, a, st);
}
