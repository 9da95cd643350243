// CSM window sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:86-146, called at :182),
// and with it the XLA sweeps on the JAX main path
// (ops/csm.py:sweep_from_hits_int8, sweep_from_hits, sweep_from_hits_at).
//
// What it computes, per (n, theta t, offset o, channel ch):
//
//   S = sum_b ok[n,t,b] * win[n, ch, hr[n,t,b] + off[o,0], hc[n,t,b] + off[o,1]]
//   out[n, t, ch, o] = float(S) * scale          (scale = float32(1/255))
//
// `win` is the u8 (prob level, observed*255) window; cells off the window
// read 0.  S < 2^24 (512 beams x 255), so the sums are exact integers and
// the result is bit-identical to the XLA forms on u8 maps.
//
// The TPU kernel builds one-hot hit images on the MXU and contracts them
// with shifted map patches.  A hit image is only a beam-count image, so on
// this card the score is the per-beam gather above: no hit image and no
// patch matrix ever exists, in shared memory or in device memory.
//
// What bounds it here: not FLOPs (one integer add per gathered byte) but
// gather latency and L2 bytes.  The window is at most 2 x 329^2 u8 for a
// frontend match (~216 KB), so it stays in L2 and each 1-byte read is an
// L1/L2 hit; the beams' cells are re-read by every block of a theta.
// Design: one block per (n, theta, chunk of (offset, channel) pairs).  The
// block stages that theta's valid beams (compacted) in shared memory once,
// then each warp reduces one (offset, channel) pair at a time: its 32
// lanes split the beams, read through the read-only cache, and combine
// with a shuffle tree.  Integer adds make the result independent of the
// order the beams are compacted and summed in.  Shared-memory tiling of
// the window, TMA and wgmma are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerWarp = 4;
constexpr int kPairsPerBlock = kWarps * kPairsPerWarp;
constexpr int kMaxBeams = 2048;

__global__ void __launch_bounds__(kThreads)
csm_sweep_kernel(const uint8_t* __restrict__ win,
                 const int32_t* __restrict__ hr,
                 const int32_t* __restrict__ hc,
                 const uint8_t* __restrict__ ok,
                 const int32_t* __restrict__ off,
                 float* __restrict__ out,
                 int T, int B, int in_r, int in_c, int n_off, float scale) {
  __shared__ int s_r[kMaxBeams];
  __shared__ int s_c[kMaxBeams];
  __shared__ int s_n;

  const int t = blockIdx.x;
  const int n = blockIdx.y;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();

  // Stage this theta's valid beams, compacted.
  const size_t tb = (static_cast<size_t>(n) * T + t) * B;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    if (ok[tb + b]) {
      const int k = atomicAdd(&s_n, 1);
      s_r[k] = hr[tb + b];
      s_c[k] = hc[tb + b];
    }
  }
  __syncthreads();
  const int nb = s_n;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(in_r) * in_c;
  const uint8_t* wn = win + static_cast<size_t>(n) * 2 * plane;
  const int pairs = 2 * n_off;
  const int p0 = blockIdx.z * kPairsPerBlock;
  const int p1 = min(pairs, p0 + kPairsPerBlock);

  for (int p = p0 + warp; p < p1; p += kWarps) {
    const int o = p >> 1;
    const int ch = p & 1;
    const int oj = off[2 * o];
    const int oi = off[2 * o + 1];
    const uint8_t* w = wn + ch * plane;
    int acc = 0;
    for (int k = lane; k < nb; k += 32) {
      const int r = s_r[k] + oj;
      const int c = s_c[k] + oi;
      if (r >= 0 && r < in_r && c >= 0 && c < in_c) {
        acc += __ldg(w + static_cast<size_t>(r) * in_c + c);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, d);
    }
    if (lane == 0) {
      out[((static_cast<size_t>(n) * T + t) * 2 + ch) * n_off + o] =
          __fmul_rn(static_cast<float>(acc), scale);
    }
  }
}

}  // namespace

extern "C" int csm_sweep_max_beams() { return kMaxBeams; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int csm_sweep_launch(const void* win, const void* hr,
                                const void* hc, const void* ok,
                                const void* off, void* out, int N, int T,
                                int B, int in_r, int in_c, int n_off,
                                float scale, void* stream) {
  if (N < 1 || T < 1 || B < 1 || B > kMaxBeams || in_r < 1 || in_c < 1 ||
      n_off < 1 || N > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (2 * n_off + kPairsPerBlock - 1) / kPairsPerBlock;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T, N, chunks);
  csm_sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(win), static_cast<const int32_t*>(hr),
      static_cast<const int32_t*>(hc), static_cast<const uint8_t*>(ok),
      static_cast<const int32_t*>(off), static_cast<float*>(out), T, B, in_r,
      in_c, n_off, scale);
  return static_cast<int>(cudaGetLastError());
}
