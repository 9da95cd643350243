// Per-theta hit-count images for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_hit_image_kernel`
// (my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:32, called through
// `build_hit_images` at :56, `pallas_call` at :69), and with it the XLA
// one-hot build of ops/csm.py:build_hit_images that branch-and-bound runs
// once per match.
//
// What it computes, for theta t and crop cell (r, c):
//
//   out[t, r, c] = #{ b : rows[t,b] == r and cols[t,b] == c }
//
// A (theta, beam) pair whose row or column falls outside
// [0, crop_rows) x [0, crop_cols) writes nothing; the caller folds beam
// validity and the theta mask into the indices as row -1.  The counts are
// f32, exact for any count below 2^24, in the form the sweep's f32 matmul
// consumes.
//
// The TPU kernel contracts one-hot(rows)^T with one-hot(cols) on the MXU
// (bf16, exact only to 256 per cell).  Here each (theta, beam) pair simply
// adds 1 to its cell: one thread per pair, one atomicAdd.  Adds of 1.0f to
// a count below 2^24 are exact, so the result does not depend on the order
// the atomics land in.
//
// What bounds it on this card: writing the output.  At branch-and-bound's
// loop shape (T = 208, crop 448) the image stack is 208 * 448^2 * 4 B =
// 167 MB, zeroed once on the stream (~0.05 ms at 3.35 TB/s), against
// 208 * 512 = 106,496 scattered atomics.  A sparse or int8 form of the
// images, and fusing the build into the sweep, are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hit_images_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ cols,
                  float* __restrict__ out,
                  int T, int B, int crop_rows, int crop_cols) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(T) * B) return;
  const int r = rows[i];
  const int c = cols[i];
  if (r < 0 || r >= crop_rows || c < 0 || c >= crop_cols) return;
  const long long t = i / B;
  atomicAdd(out + (t * crop_rows + r) * crop_cols + c, 1.0f);
}

}  // namespace

// Zeroes `out` [T, crop_rows, crop_cols] f32 and launches the count, both
// on `stream`; returns the first CUDA error (0 on success).
extern "C" int hit_images_launch(const void* rows, const void* cols,
                                 void* out, int T, int B, int crop_rows,
                                 int crop_cols, void* stream) {
  if (T < 1 || B < 1 || crop_rows < 1 || crop_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pairs = static_cast<long long>(T) * B;
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(T) * crop_rows * crop_cols *
                       sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  hit_images_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<float*>(out), T, B, crop_rows, crop_cols);
  return static_cast<int>(cudaGetLastError());
}
