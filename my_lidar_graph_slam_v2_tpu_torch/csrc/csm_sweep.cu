// CSM window sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:86-146, called at :182),
// and with it the XLA sweeps on the JAX main path
// (ops/csm.py:sweep_from_hits_int8, sweep_from_hits, sweep_from_hits_at).
//
// What it computes, per (candidate n, theta t, channel ch, offset o):
//
//   S = sum_b ok[n,t,b] * win[n, hr[n,t,b] + oj[o], hc[n,t,b] + oi[o], ch]
//   out[n, t, ch, o] = float(S) * scale          (scale = float32(1/255))
//
// `win` is the u8 window with the two channels interleaved: one 2-byte
// cell (prob level, observed * 255) per map cell; cells off the window
// read 0.  The offsets are K rectangular tiles per candidate: tile k has
// its origin at origins[n, k] and tile_h x tile_w offsets at `stride`,
// o = (k * tile_h + j) * tile_w + i -> (oj, oi) = origin + (j, i) * stride.
// S < 2^24, so the sums are exact integers and the result is bit-identical
// to the XLA forms on u8 maps.
//
// The TPU kernel builds one-hot hit images on the MXU and contracts them
// with shifted map patches.  A hit image is only a beam-count image, so on
// this card the score is the per-beam gather above: no hit image and no
// patch matrix exists, in shared memory or in device memory.
//
// What bounds it: one 32-bit add per (valid beam, offset), both channels
// packed in it (below), 213 M at the loop detector's batch (8 candidates
// x 208 thetas x 512 beams x 250 offsets), 13 us at 132 SMs x 64 INT32
// lanes; the bytes (window, beam cells, scores, 15 MB there) take about a
// third of that.  What an
// earlier, per-(offset, channel) warp design lost to: every block of a
// theta re-staged its beams through a shared atomic counter, every
// (beam, offset, channel) was a separate 1-byte scattered load, and every
// output paid a 5-step shuffle tree.  The design here:
//
// - A thread owns kBeams beams (b = tid, tid + blockDim, ...; 1, 2 or 4)
//   and loads all their cells and masks at once, straight from device
//   memory, coalesced: no staging, no shared atomics, one round trip; a
//   masked beam adds nothing.  The launcher gives a thread more beams
//   (fewer threads, less reduction per beam) only while the grid still
//   has 32 warps for each SM, so small sweeps get many short threads.
// - One block per (item, theta, candidate).  For a stride-1 tile the item
//   is a 5x5 sub-tile: a thread reads each beam's 5x5 neighbourhood once,
//   as 5 row segments of 5 cells (one aligned 16-byte load, two where the
//   segment crosses a 16-byte boundary), and adds all 25 offsets, both
//   channels, in registers.  For a strided tile the
//   item is 32 consecutive offsets, one 2-byte load each (no neighbourhood
//   to share).
// - Both channels ride in one register: a cell (p, o) is widened with one
//   byte permute to p | o << 16 and added with one integer add.  A
//   warp's 128 beams stay below 2^16 per half (128 * 255), so the halves
//   never carry.
// - The 25 (or 32) packed sums are reduced across the warp by a
//   reduce-scatter (31 shuffles; lane L ends with value L), then across
//   the block's warps in one shared-memory pass (unpacked to 32 bits), and
//   each output is written once by one lane.
// - Items x thetas x candidates give 128 blocks for the frontend's fine
//   sweep (T 32, 4 sub-tiles; 512 threads of one beam each), 832 for its
//   dense re-run and 16,640 for the loop batch (128 threads of 4 beams),
//   so N = 1 and N = 8 both fill the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxBeamsPerThread = 4;  // 32 lanes x 4 beams x 255 < 2^16
constexpr int kMaxBeams = 2048;
constexpr int kWarpsToFill = 132 * 32;  // resident warps wanted on the card
constexpr int kSub = 5;     // a stride-1 item: kSub x kSub offsets
constexpr int kSlots = 32;  // values a warp reduces per item, one per lane

struct Sweep {
  const uint8_t* win;  // [N, in_r, in_c, 2]
  const int32_t* hr;   // [N, T, B]
  const int32_t* hc;
  const uint8_t* ok;
  const int32_t* origins;  // [N, K, 2]
  float* out;              // [N, T, 2, K * tile_h * tile_w]
  int T, B, in_r, in_c, K, tile_h, tile_w, stride;
  long long cells;  // N * in_r * in_c
  float scale;
};

// The 2-byte cell in the low (high) half of x, widened to p | o << 16.
__device__ __forceinline__ uint32_t lo_cell(uint32_t x) {
  return __byte_perm(x, 0u, 0x4140);
}
__device__ __forceinline__ uint32_t hi_cell(uint32_t x) {
  return __byte_perm(x, 0u, 0x4342);
}

// v[0..2H-1] summed over the warp: afterwards lane L holds in v[0] the
// warp total of value L.  Each step halves the values a lane holds: it
// keeps the half its lane bit H selects and sends the other half to its
// partner.  (Recursion on H keeps every index a constant, so v stays in
// registers.)
template <int H>
__device__ __forceinline__ void warp_reduce_scatter(uint32_t (&v)[kSlots],
                                                    int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const uint32_t send = upper ? v[j] : v[j + H];
    const uint32_t keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) warp_reduce_scatter<H / 2>(v, lane);
}

// Reduce the block's packed sums and write value L (lane L of warp 0) to
// output offset o_of_lane (nothing where it is negative).
__device__ __forceinline__ void reduce_and_write(const Sweep& a,
                                                 uint32_t (&v)[kSlots], int n,
                                                 int t, int o_of_lane) {
  __shared__ uint32_t s_part[kMaxThreads / 32][kSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce_scatter<kSlots / 2>(v, lane);
  s_part[warp][lane] = v[0];
  __syncthreads();
  if (warp != 0 || o_of_lane < 0) return;
  uint32_t prob = 0, obs = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const uint32_t x = s_part[w][lane];
    prob += x & 0xffffu;
    obs += x >> 16;
  }
  const int n_off = a.K * a.tile_h * a.tile_w;
  float* out = a.out + (static_cast<size_t>(n) * a.T + t) * 2 * n_off;
  out[o_of_lane] = __fmul_rn(static_cast<float>(prob), a.scale);
  out[n_off + o_of_lane] = __fmul_rn(static_cast<float>(obs), a.scale);
}

// The cells (plus the tile origin) and the mask of the thread's kBeams
// beams, loaded together; beams past B are masked.
template <int kBeams>
struct Beams {
  int r[kBeams], c[kBeams];
  unsigned ok = 0;
  __device__ __forceinline__ Beams(const Sweep& a, int n, int t, int oj,
                                   int oi) {
    const size_t tb = (static_cast<size_t>(n) * a.T + t) * a.B;
#pragma unroll
    for (int u = 0; u < kBeams; ++u) {
      const int b = threadIdx.x + u * blockDim.x;
      r[u] = oj;
      c[u] = oi;
      if (b < a.B) {
        r[u] += __ldg(a.hr + tb + b);
        c[u] += __ldg(a.hc + tb + b);
        ok |= (__ldg(a.ok + tb + b) ? 1u : 0u) << u;
      }
    }
  }
};

// Stride-1 tiles: blockIdx.x = k * (sub-tiles per tile) + sub-tile.
template <int kBeams>
__global__ void __launch_bounds__(kMaxThreads)
sweep_rows_kernel(const Sweep a) {
  const int t = blockIdx.y;
  const int n = blockIdx.z;
  const int sub_x = (a.tile_w + kSub - 1) / kSub;
  const int per_tile = sub_x * ((a.tile_h + kSub - 1) / kSub);
  const int k = blockIdx.x / per_tile;
  const int sj = (blockIdx.x % per_tile) / sub_x * kSub;
  const int si = (blockIdx.x % per_tile) % sub_x * kSub;
  const int rows = min(kSub, a.tile_h - sj);
  const int cols = min(kSub, a.tile_w - si);
  const int* org = a.origins + (static_cast<size_t>(n) * a.K + k) * 2;
  const int oj = __ldg(org) + sj;
  const int oi = __ldg(org + 1) + si;
  const long long plane = static_cast<long long>(n) * a.in_r * a.in_c;
  const uint4* win16 = reinterpret_cast<const uint4*>(a.win);
  const uint16_t* win2 = reinterpret_cast<const uint16_t*>(a.win);

  uint32_t v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) v[s] = 0;

  const Beams<kBeams> beams(a, n, t, oj, oi);
#pragma unroll
  for (int u = 0; u < kBeams; ++u) {
    if (!(beams.ok >> u & 1u)) continue;
    const int r = beams.r[u];
    const int c = beams.c[u];
    const long long g = plane + static_cast<long long>(r) * a.in_c + c;
    const long long g_last = g + static_cast<long long>(rows - 1) * a.in_c;
    if (r >= 0 && r + rows <= a.in_r && c >= 0 && c + cols <= a.in_c &&
        (g_last & ~7ll) + 16 <= a.cells) {
      // Each row: the 8 cells from g & ~7 in one aligned 16-byte load, and
      // the next 8 where the 5 cells run past them; words w0, w1, w2 from
      // the pair of cells that holds cell g on, shifted by a cell where g
      // is odd, so that x0, x1, x2 hold cells 0-1, 2-3, 4.  Cells of unused
      // columns or rows are read but never written.
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        if (jj < rows) {
          const long long gj = g + static_cast<long long>(jj) * a.in_c;
          const int s = gj & 7;
          const uint4 p = __ldg(win16 + (gj >> 3));
          uint4 q = make_uint4(0u, 0u, 0u, 0u);
          if (s > 3) q = __ldg(win16 + (gj >> 3) + 1);
          const int w = s >> 1;
          const uint32_t w0 = w == 0 ? p.x : w == 1 ? p.y : w == 2 ? p.z : p.w;
          const uint32_t w1 = w == 0 ? p.y : w == 1 ? p.z : w == 2 ? p.w : q.x;
          const uint32_t w2 = w == 0 ? p.z : w == 1 ? p.w : w == 2 ? q.x : q.y;
          const uint32_t sh = (s & 1) * 16;
          const uint32_t x0 = __funnelshift_r(w0, w1, sh);
          const uint32_t x1 = __funnelshift_r(w1, w2, sh);
          const uint32_t x2 = w2 >> sh;
          v[jj * kSub + 0] += lo_cell(x0);
          v[jj * kSub + 1] += hi_cell(x0);
          v[jj * kSub + 2] += lo_cell(x1);
          v[jj * kSub + 3] += hi_cell(x1);
          v[jj * kSub + 4] += lo_cell(x2);
        }
      }
    } else {
      // The neighbourhood crosses the window's edge: cell by cell.
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
#pragma unroll
        for (int ii = 0; ii < kSub; ++ii) {
          const int rr = r + jj;
          const int cc = c + ii;
          if (jj < rows && ii < cols && rr >= 0 && rr < a.in_r && cc >= 0 &&
              cc < a.in_c) {
            v[jj * kSub + ii] += lo_cell(
                __ldg(win2 + plane + static_cast<long long>(rr) * a.in_c + cc));
          }
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int dj = lane / kSub;
  const int di = lane % kSub;
  const int o = (lane < kSub * kSub && dj < rows && di < cols)
                    ? (k * a.tile_h + sj + dj) * a.tile_w + si + di
                    : -1;
  reduce_and_write(a, v, n, t, o);
}

// Tiles at any stride: blockIdx.x = k * (items per tile) + item, an item
// being kSlots consecutive offsets of the tile.
template <int kBeams>
__global__ void __launch_bounds__(kMaxThreads)
sweep_cells_kernel(const Sweep a) {
  const int t = blockIdx.y;
  const int n = blockIdx.z;
  const int per_tile_offs = a.tile_h * a.tile_w;
  const int per_tile = (per_tile_offs + kSlots - 1) / kSlots;
  const int k = blockIdx.x / per_tile;
  const int o0 = blockIdx.x % per_tile * kSlots;
  const int used = min(kSlots, per_tile_offs - o0);
  const int j0 = o0 / a.tile_w;
  const int i0 = o0 % a.tile_w;
  const int* org = a.origins + (static_cast<size_t>(n) * a.K + k) * 2;
  const int oj = __ldg(org) + j0 * a.stride;
  const int oi = __ldg(org + 1);
  const long long plane = static_cast<long long>(n) * a.in_r * a.in_c;
  const uint16_t* win2 = reinterpret_cast<const uint16_t*>(a.win);

  uint32_t v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) v[s] = 0;

  const Beams<kBeams> beams(a, n, t, oj, oi);
#pragma unroll
  for (int u = 0; u < kBeams; ++u) {
    if (!(beams.ok >> u & 1u)) continue;
    const int c_row = beams.c[u];
    int r = beams.r[u];
    int i = i0;
    int c = c_row + i0 * a.stride;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < used) {
        if (r >= 0 && r < a.in_r && c >= 0 && c < a.in_c) {
          v[s] += lo_cell(
              __ldg(win2 + plane + static_cast<long long>(r) * a.in_c + c));
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

  const int lane = threadIdx.x & 31;
  reduce_and_write(a, v, n, t, lane < used ? k * per_tile_offs + o0 + lane : -1);
}

}  // namespace

extern "C" int csm_sweep_max_beams() { return kMaxBeams; }

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int csm_sweep_launch(const void* win, const void* hr,
                                const void* hc, const void* ok,
                                const void* origins, void* out, int N, int T,
                                int B, int in_r, int in_c, int K, int tile_h,
                                int tile_w, int stride, float scale,
                                void* stream) {
  if (N < 1 || T < 1 || B < 1 || B > kMaxBeams || in_r < 1 || in_c < 1 ||
      K < 1 || tile_h < 1 || tile_w < 1 || stride < 1 || N > 65535 ||
      T > 65535 || reinterpret_cast<uintptr_t>(win) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_off = static_cast<long long>(K) * tile_h * tile_w;
  const bool rows = stride == 1;
  const long long per_tile =
      rows ? static_cast<long long>((tile_h + kSub - 1) / kSub) *
                 ((tile_w + kSub - 1) / kSub)
           : (static_cast<long long>(tile_h) * tile_w + kSlots - 1) / kSlots;
  const long long items = K * per_tile;
  if (n_off > 0x7fffffffll || items > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Beams per thread: the fewest that fit in kMaxThreads, doubled while
  // the grid keeps kWarpsToFill warps; a whole number of warps a block.
  const long long blocks = items * T * N;
  auto warps = [B](int per) { return (B + 32 * per - 1) / (32 * per); };
  int per = 1;
  while (warps(per) * 32 > kMaxThreads) per *= 2;
  while (per < kMaxBeamsPerThread && blocks * warps(2 * per) >= kWarpsToFill) {
    per *= 2;
  }
  const int threads = warps(per) * 32;

  Sweep a;
  a.win = static_cast<const uint8_t*>(win);
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
  a.cells = static_cast<long long>(N) * in_r * in_c;
  a.scale = scale;
  const dim3 grid(static_cast<unsigned>(items), T, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per * (rows ? 1 : -1)) {
    case 1: sweep_rows_kernel<1><<<grid, threads, 0, s>>>(a); break;
    case 2: sweep_rows_kernel<2><<<grid, threads, 0, s>>>(a); break;
    case 4: sweep_rows_kernel<4><<<grid, threads, 0, s>>>(a); break;
    case -1: sweep_cells_kernel<1><<<grid, threads, 0, s>>>(a); break;
    case -2: sweep_cells_kernel<2><<<grid, threads, 0, s>>>(a); break;
    case -4: sweep_cells_kernel<4><<<grid, threads, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
