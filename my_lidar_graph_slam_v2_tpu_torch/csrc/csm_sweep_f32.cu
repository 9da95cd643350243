// CSM window sweep over an f32 window for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:86-146, called through
// `sweep` at :153, `pallas_call` at :182) on its own input type: an f32
// window of (prob, observed) planes.  With it go the XLA sweeps the JAX
// package runs on f32 maps and at precision "highest"
// (ops/csm.py:sweep_from_hits, sweep_from_hits_at, sweep_windows).  The u8
// window form is csm_sweep.cu.
//
// What it computes, per (candidate n, theta t, channel ch, offset o):
//
//   S = sum_b ok[n,t,b] * win[n, hr[n,t,b] + oj[o], hc[n,t,b] + oi[o], ch]
//   out[n, t, ch, o] = float(S)          (S summed in f64, rounded once)
//
// `win` is f32 [N, in_r, in_c, 2], the channels interleaved (prob,
// observed as 0/1); cells off the window read 0.  The offsets are the u8
// kernel's tiles: K tiles per candidate, tile k at origins[n, k], tile_h x
// tile_w offsets at `stride`, o = (k * tile_h + j) * tile_w + i.
//
// Exact sums.  Every f32 value >= 2^-18 is a multiple of 2^-41; a sum of
// at most kMaxBeams = 2048 such values, each <= 1, is below 2^52 of those
// units, so every partial sum is an f64 value and the f64 adds are exact
// in any order: the warp shuffles, the shared-memory pass and the plain
// version's sum (ops/csm.py:sweep_plain, an f64 torch sum) give the same
// f64 total, and one rounding gives the same f32 on every device.  The
// windows the package builds qualify (the map's probabilities, clamped to
// [1e-3, 1 - 1e-3] or levels / 255, rounded as the precision asks,
// ops/csm.py:round_window); a window with non-zero cells below 2^-18 is
// outside this guarantee.  No packed integer adds as in csm_sweep.cu:
// neither the packing nor its 2^16 bound applies to floats.
//
// What bounds it: two f64 adds per (valid beam, offset), 426 M at the
// loop detector's batch (8 candidates x 208 thetas x 512 beams x 250
// offsets), 25 us at 132 SMs x 64 FP64 lanes x 1.98 GHz; the f32 window
// (8 B per cell), beam cells and scores take less.  The design is the
// simple one, right first:
//
// - One block per (item, theta, candidate); a thread takes beams tid,
//   tid + blockDim, ... and reads their cells and masks from device
//   memory.
// - The item is 16 consecutive offsets of a tile, at any stride: a thread
//   reads each beam's 16 cells (one 8-byte load per cell) and adds both
//   channels into 32 f64 registers.  (A 4 x 4 item for stride-1 tiles,
//   as the u8 kernel has, was slower at every stride-1 shape: fewer
//   offsets per item mean more blocks re-reading the same beams;
//   `sweep_ab.py --f32`, PERF.md.)
// - The 32 sums are reduced across the warp by a reduce-scatter (31
//   shuffles of f64; lane L ends with sum L), then across the block's
//   warps in one shared-memory pass, and each output is written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxBeams = 2048;  // keeps the f64 sums exact (above)
constexpr int kOffs = 16;        // offsets per item
constexpr int kSlots = 32;       // 2 channels x kOffs, one per lane

struct SweepF32 {
  const float2* win;  // [N, in_r, in_c] cells of (prob, observed)
  const int32_t* hr;  // [N, T, B]
  const int32_t* hc;
  const uint8_t* ok;
  const int32_t* origins;  // [N, K, 2]
  float* out;              // [N, T, 2, K * tile_h * tile_w]
  int T, B, in_r, in_c, K, tile_h, tile_w, stride;
};

// v[0..2H-1] summed over the warp: afterwards lane L holds in v[0] the
// warp total of value L (as csm_sweep.cu, on f64).
template <int H>
__device__ __forceinline__ void warp_reduce_scatter(double (&v)[kSlots],
                                                    int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const double send = upper ? v[j] : v[j + H];
    const double keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) warp_reduce_scatter<H / 2>(v, lane);
}

// Reduce the block's sums; lane L of warp 0 writes channel L / kOffs at
// output offset o_of_slot (nothing where it is negative), which the
// caller computed for slot L % kOffs.
__device__ __forceinline__ void reduce_and_write(const SweepF32& a,
                                                 double (&v)[kSlots], int n,
                                                 int t, int o_of_slot) {
  __shared__ double s_part[kMaxThreads / 32][kSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce_scatter<kSlots / 2>(v, lane);
  s_part[warp][lane] = v[0];
  __syncthreads();
  if (warp != 0 || o_of_slot < 0) return;
  double sum = 0.0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    sum += s_part[w][lane];
  }
  const int n_off = a.K * a.tile_h * a.tile_w;
  const int ch = lane / kOffs;
  a.out[((static_cast<size_t>(n) * a.T + t) * 2 + ch) * n_off + o_of_slot] =
      __double2float_rn(sum);
}

__device__ __forceinline__ void add_cell(double (&v)[kSlots], int s,
                                         float2 x) {
  v[s] += static_cast<double>(x.x);
  v[kOffs + s] += static_cast<double>(x.y);
}

// blockIdx.x = k * (items per tile) + item, an item being kOffs
// consecutive offsets of the tile.
__global__ void __launch_bounds__(kMaxThreads)
sweep_f32_kernel(const SweepF32 a) {
  const int t = blockIdx.y;
  const int n = blockIdx.z;
  const int per_tile_offs = a.tile_h * a.tile_w;
  const int per_tile = (per_tile_offs + kOffs - 1) / kOffs;
  const int k = blockIdx.x / per_tile;
  const int o0 = blockIdx.x % per_tile * kOffs;
  const int used = min(kOffs, per_tile_offs - o0);
  const int j0 = o0 / a.tile_w;
  const int i0 = o0 % a.tile_w;
  const int* org = a.origins + (static_cast<size_t>(n) * a.K + k) * 2;
  const long long oj = static_cast<long long>(__ldg(org)) +
                       static_cast<long long>(j0) * a.stride;
  const long long oi = __ldg(org + 1);
  const float2* plane = a.win + static_cast<long long>(n) * a.in_r * a.in_c;
  const size_t tb = (static_cast<size_t>(n) * a.T + t) * a.B;

  double v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) v[s] = 0.0;

  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    if (!__ldg(a.ok + tb + b)) continue;
    const long long c_row = __ldg(a.hc + tb + b) + oi;
    long long r = __ldg(a.hr + tb + b) + oj;
    long long c = c_row + static_cast<long long>(i0) * a.stride;
    int i = i0;
#pragma unroll
    for (int s = 0; s < kOffs; ++s) {
      if (s < used) {
        if (r >= 0 && r < a.in_r && c >= 0 && c < a.in_c) {
          add_cell(v, s, __ldg(plane + r * a.in_c + c));
        }
        c += a.stride;
        if (++i == a.tile_w) {
          i = 0;
          c = c_row;
          r += a.stride;
        }
      }
    }
  }

  const int slot = (threadIdx.x & 31) % kOffs;
  reduce_and_write(a, v, n, t, slot < used ? k * per_tile_offs + o0 + slot
                                           : -1);
}

}  // namespace

extern "C" int csm_sweep_f32_max_beams() { return kMaxBeams; }

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int csm_sweep_f32_launch(const void* win, const void* hr,
                                    const void* hc, const void* ok,
                                    const void* origins, void* out, int N,
                                    int T, int B, int in_r, int in_c, int K,
                                    int tile_h, int tile_w, int stride,
                                    void* stream) {
  if (N < 1 || T < 1 || B < 1 || B > kMaxBeams || in_r < 1 || in_c < 1 ||
      K < 1 || tile_h < 1 || tile_w < 1 || stride < 1 || N > 65535 ||
      T > 65535 || reinterpret_cast<uintptr_t>(win) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_off = static_cast<long long>(K) * tile_h * tile_w;
  const long long per_tile =
      (static_cast<long long>(tile_h) * tile_w + kOffs - 1) / kOffs;
  const long long items = K * per_tile;
  if (n_off > 0x7fffffffll || items > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = B >= kMaxThreads ? kMaxThreads : (B + 31) / 32 * 32;

  SweepF32 a;
  a.win = static_cast<const float2*>(win);
  a.hr = static_cast<const int32_t*>(hr);
  a.hc = static_cast<const int32_t*>(hc);
  a.ok = static_cast<const uint8_t*>(ok);
  a.origins = static_cast<const int32_t*>(origins);
  a.out = static_cast<float*>(out);
  a.T = T;
  a.B = B;
  a.in_r = in_r;
  a.in_c = in_c;
  a.K = K;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.stride = stride;
  const dim3 grid(static_cast<unsigned>(items), T, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sweep_f32_kernel<<<grid, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
