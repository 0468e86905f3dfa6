// Row scatter-add (the backward of a row gather) on Hopper (sm_90a).
//
// Replaces the TPU kernel sam6d_tpu/ops/pallas/scatter_rows.py:
// scatter_rows_pallas (kernel _scatter_rows_kernel):
//
//   out[b, n, :] = sum over q with idx[b, q] == n of dy[b, q, :]
//
// in float32, rows whose index lies outside [0, N) dropped (the caller's
// negative padding; the TPU kernel's one-hot tile matches no row for them).
//
// What bounds it on this card: bytes.  Each dy element is read once and
// added once; at the fine-stage positional encoding's shapes (B = 28,
// N = 2048, Q = 2048 * 64, C = 32, bf16) the call reads 235 MB of dy and
// 29 MB of indices and writes 7 MB, 0.08 ms at 3.35 TB/s.  The TPU kernel
// turned the scatter into a one-hot matmul (B * N * Q * C multiply-adds,
// 0.5 TFLOP at that shape) because the TPU has no atomics; this card does,
// so the design is the reference CUDA group_points_grad's: a zeroed float32
// output and one thread per (row, pair of channels) that adds its two
// values with one vector atomicAdd (float2, sm_90).  Neighbouring threads
// read neighbouring dy values, so the loads are coalesced; each target row
// is hit about S times from different rows, spread over the grid.
//
// The order of the float32 sums into a row follows the order in which the
// atomics land, which changes from run to run: two launches on the same
// inputs may differ in the last bits (float32 rounding of S terms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(256)
    scatter_rows_kernel(const int64_t* __restrict__ idx,
                        const T* __restrict__ dy, float* __restrict__ out,
                        int64_t rows, int q_per_batch, int n_targets,
                        int half_c) {
  // One thread per (row, channel pair); rows = B * Q.
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= rows * half_c) return;
  const int64_t row = t / half_c;
  const int c2 = static_cast<int>(t - row * half_c);
  const int64_t n = idx[row];
  if (n < 0 || n >= n_targets) return;
  const int64_t b = row / q_per_batch;
  const float2 v = load2<T>(dy + row * (2 * half_c) + 2 * c2);
  float2* dst = reinterpret_cast<float2*>(
      out + ((b * n_targets + n) * half_c + c2) * 2);
  atomicAdd(dst, v);
}

}  // namespace

// idx (B * Q) int64, dy (B * Q, C) in float32 or bfloat16 (is_bf16), out
// (B * N, C) float32, zeroed by the caller.  C even; dy and out aligned to
// 8 bytes (float2 / bf16x2 accesses).  Returns cudaGetLastError() after the
// launch.
extern "C" int scatter_rows(const void* idx, const void* dy, void* out,
                            long long rows, int q_per_batch, int n_targets,
                            int C, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int half_c = C / 2;
  const long long threads = rows * half_c;
  if (threads == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    scatter_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        ix, static_cast<const __nv_bfloat16*>(dy), o, rows, q_per_batch,
        n_targets, half_c);
  } else {
    scatter_rows_kernel<float><<<blocks, 256, 0, st>>>(
        ix, static_cast<const float*>(dy), o, rows, q_per_batch, n_targets,
        half_c);
  }
  return static_cast<int>(cudaGetLastError());
}
