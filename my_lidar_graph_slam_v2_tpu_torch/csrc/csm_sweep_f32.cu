// CSM window sweep over an f32 window for Hopper (sm_90a), on exact
// fixed-point integer sums.
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
//   out[n, t, ch, o] = float(S)          (S exact, rounded once)
//
// `win` is f32 [N, in_r, in_c, 2], the channels interleaved (prob in
// [0, 1], observed as 0/1); cells off the window read 0.  The offsets are
// the u8 kernel's tiles: K tiles per candidate, tile k at origins[n, k],
// tile_h x tile_w offsets at `stride`, o = (k * tile_h + j) * tile_w + i.
//
// Two kernels, one after the other on the caller's stream:
//
// - pack_f32_kernel turns each cell into one u64, m | obs << 56, with
//   m = prob * 2^41 rounded to an integer (to nearest, ties to even) and
//   obs = (observed != 0).  It is the only float-to-integer conversion;
//   the sweep adds integers.  Its plain version is
//   ops/csm.py:pack_f32_window_plain.
// - sweep_f32_rows_kernel / sweep_f32_cells_kernel: csm_sweep.cu's items
//   and launcher over the packed cells, one 64-bit integer add per
//   (beam, offset) for both channels.
//
// Why the integer sums are exact.  Every f32 value v >= 2^-18 is a
// multiple of 2^-41 (its last significand bit is worth 2^(e - 23) with
// e >= -18), so m = v * 2^41 is an exact integer, at most 2^41 for v <= 1.
// A warp adds at most 32 lanes x 4 beams = 128 cells: sum m <= 2^48 stays
// below bit 56, and the observed count (<= 128) fits in bits 56-63 with no
// carry ever reaching it (csm_sweep.cu's 128 * 255 < 2^16, one size up).
// The block's warps are unpacked and summed apart: at most kMaxBeams = 2048
// beams give sum m <= 2^52, exact in an f64, so
// float(double(sum m) * 2^-41) is the exact sum rounded once: the f64 sum
// the plain version takes (ops/csm.py:sweep_plain), bit for bit, in any
// beam order.  A non-zero prob below 2^-18 packs to the nearest integer
// m; the plain version rounds its window the same way before its f64 sum
// (ops/csm.py:round_to_fixed_point, which changes no value from 2^-18 up),
// so the two agree on every window.  A prob outside [0, 1] is outside the
// guarantee.
//
// What bounds it: two 32-bit integer ops per (valid beam, offset) (the
// 64-bit add), 426 M at the loop detector's batch (8 candidates x 208
// thetas x 512 beams x 250 offsets), 25 us at 132 SMs x 64 INT32 lanes x
// 1.98 GHz; or the bytes (the f32 window, 8 B per cell, beam cells and
// scores).  What the earlier, f64 form of this kernel lost to, and what
// the design here does about it:
//
// 1. It converted each cell's two floats to f64 before its adds (two
//    F2F.F64.F32 per (beam, offset), a quarter of the rate of the f64
//    adds).  Here the pack converts each cell once per call, and the
//    sweep's inner loop holds no conversion at all.
// 2. It read one 8-byte cell per (beam, offset), 16 consecutive offsets
//    an item at any stride.  Here a stride-1 tile takes csm_sweep.cu's
//    5 x 5 item: a thread reads each beam's 5 x 5 neighbourhood once, as
//    5 row segments of 5 cells in 3 aligned 16-byte loads each (2 cells a
//    load), and adds all 25 offsets; a neighbourhood that crosses the
//    window's edge goes cell by cell.  A strided tile takes 32
//    consecutive offsets an item, one 8-byte load each.
// 3. It gave every thread one beam in blocks of up to 512 threads.  Here
//    a thread owns kBeams = 1, 2 or 4 beams (Beams<kBeams>), which also
//    keeps a warp at <= 128 beams, chosen by csm_sweep.cu's launcher rule
//    (more beams a thread only while the grid keeps 32 warps for each SM)
//    but for one case: at 88-96 registers an SM holds a single block of
//    512 threads, so a grid that rule runs in at most two waves of
//    resident blocks takes the kBeams with the fewest waves (the occupancy
//    query).  The frontend's coarse sweep, 208 blocks, then runs in one
//    wave of 256-thread blocks, not two of 512, and takes 8-9 % less time
//    (sweep_ab.py --f32 on an H100).
//
// The 25 (or 32) u64 sums are reduced across the warp by a reduce-scatter
// (31 shuffles of u64; lane L ends with value L), then across the block's
// warps in one shared-memory pass that unpacks each warp's word into sum m
// (u64) and sum obs (u32), and each output is written once by one lane.
// Registers (nvcc 12.8, -Xptxas -v, sm_90a): the rows kernel 64 / 90 / 96
// at 1 / 2 / 4 beams a thread, the cells kernel 88 / 88 / 94, the pack 12;
// no spills, 4 KB of shared memory.  cuobjdump -sass finds no F2F.F64.F32
// in any of them (the f64 form before: 32 in its one kernel).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kMaxThreads = 512;
constexpr int kMaxBeamsPerThread = 4;  // 32 lanes x 4 beams: no carry
constexpr int kMaxBeams = 2048;        // sum m <= 2^52: exact in an f64
constexpr int kWarpsToFill = 132 * 32;  // resident warps wanted on the card
constexpr int kSub = 5;     // a stride-1 item: kSub x kSub offsets
constexpr int kSlots = 32;  // values a warp reduces per item, one per lane
constexpr int kPackThreads = 256;
constexpr u64 kObs = 1ull << 56;  // the observed count's unit
constexpr u64 kSumMask = kObs - 1;

struct SweepF32 {
  const u64* win;     // [N, in_r, in_c] packed cells (pack_f32_kernel)
  const int32_t* hr;  // [N, T, B]
  const int32_t* hc;
  const uint8_t* ok;
  const int32_t* origins;  // [N, K, 2]
  float* out;              // [N, T, 2, K * tile_h * tile_w]
  int T, B, in_r, in_c, K, tile_h, tile_w, stride;
  long long cells;  // N * in_r * in_c
};

// One u64 per cell of the f32 window: m | obs << 56 (above).  The product
// prob * 2^41 is exact in f32 (a power-of-two scale); the conversion
// rounds it to an integer only below 2^-18.
__global__ void __launch_bounds__(kPackThreads)
pack_f32_kernel(const float2* __restrict__ win, u64* __restrict__ packed,
                long long cells) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (i >= cells) return;
  const float2 x = __ldg(win + i);
  packed[i] = __float2ull_rn(x.x * 0x1p41f) | (x.y != 0.0f ? kObs : 0ull);
}

// v[0..2H-1] summed over the warp: afterwards lane L holds in v[0] the
// warp total of value L (as csm_sweep.cu, on u64).
template <int H>
__device__ __forceinline__ void warp_reduce_scatter(u64 (&v)[kSlots],
                                                    int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const u64 send = upper ? v[j] : v[j + H];
    const u64 keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) warp_reduce_scatter<H / 2>(v, lane);
}

// Reduce the block's packed sums and write value L (lane L of warp 0) to
// output offset o_of_lane (nothing where it is negative): each warp's word
// unpacked into sum m and the observed count, summed over the warps, and
// sum m rounded once.
__device__ __forceinline__ void reduce_and_write(const SweepF32& a,
                                                 u64 (&v)[kSlots], int n,
                                                 int t, int o_of_lane) {
  __shared__ u64 s_part[kMaxThreads / 32][kSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce_scatter<kSlots / 2>(v, lane);
  s_part[warp][lane] = v[0];
  __syncthreads();
  if (warp != 0 || o_of_lane < 0) return;
  u64 m = 0;
  uint32_t obs = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const u64 x = s_part[w][lane];
    m += x & kSumMask;
    obs += static_cast<uint32_t>(x >> 56);
  }
  const int n_off = a.K * a.tile_h * a.tile_w;
  float* out = a.out + (static_cast<size_t>(n) * a.T + t) * 2 * n_off;
  out[o_of_lane] = __double2float_rn(static_cast<double>(m) * 0x1p-41);
  out[n_off + o_of_lane] = static_cast<float>(obs);
}

// The cells (plus the tile origin) and the mask of the thread's kBeams
// beams, loaded together; beams past B are masked (as csm_sweep.cu).
template <int kBeams>
struct Beams {
  int r[kBeams], c[kBeams];
  unsigned ok = 0;
  __device__ __forceinline__ Beams(const SweepF32& a, int n, int t, int oj,
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
sweep_f32_rows_kernel(const SweepF32 a) {
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
  const ulonglong2* win16 = reinterpret_cast<const ulonglong2*>(a.win);

  u64 v[kSlots];
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
        ((g_last + 4) | 1) < a.cells) {
      // Each row: the 3 aligned pairs of cells from the pair that holds
      // cell g on (cells g .. g + 5, or g - 1 .. g + 4 where g is odd), of
      // which cells g .. g + 4 are added.  Cells of unused columns or rows
      // are read but never written.
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        if (jj < rows) {
          const long long gj = g + static_cast<long long>(jj) * a.in_c;
          const ulonglong2* p = win16 + (gj >> 1);
          const ulonglong2 p0 = __ldg(p);
          const ulonglong2 p1 = __ldg(p + 1);
          const ulonglong2 p2 = __ldg(p + 2);
          const bool odd = gj & 1;
          v[jj * kSub + 0] += odd ? p0.y : p0.x;
          v[jj * kSub + 1] += odd ? p1.x : p0.y;
          v[jj * kSub + 2] += odd ? p1.y : p1.x;
          v[jj * kSub + 3] += odd ? p2.x : p1.y;
          v[jj * kSub + 4] += odd ? p2.y : p2.x;
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
            v[jj * kSub + ii] +=
                __ldg(a.win + plane + static_cast<long long>(rr) * a.in_c + cc);
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
sweep_f32_cells_kernel(const SweepF32 a) {
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

  u64 v[kSlots];
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
          v[s] += __ldg(a.win + plane + static_cast<long long>(r) * a.in_c + c);
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

// Blocks of `threads` threads of the rows (or cells) kernel at `per` beams
// a thread that one SM holds at once (0 where the query fails).
int blocks_per_sm(int per, int threads, bool rows) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (per * (rows ? 1 : -1)) {
    case 1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, sweep_f32_rows_kernel<1>, threads, 0); break;
    case 2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, sweep_f32_rows_kernel<2>, threads, 0); break;
    case 4: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, sweep_f32_rows_kernel<4>, threads, 0); break;
    case -1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, sweep_f32_cells_kernel<1>, threads, 0); break;
    case -2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, sweep_f32_cells_kernel<2>, threads, 0); break;
    case -4: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, sweep_f32_cells_kernel<4>, threads, 0); break;
  }
  return e == cudaSuccess ? n : 0;
}

}  // namespace

extern "C" int csm_sweep_f32_max_beams() { return kMaxBeams; }

// Packs the f32 window `win` ([cells] of (prob, observed), 8-byte aligned)
// into `packed` ([cells] u64) on `stream`; returns cudaGetLastError().
extern "C" int csm_sweep_f32_pack_launch(const void* win, void* packed,
                                         long long cells, void* stream) {
  const long long blocks = (cells + kPackThreads - 1) / kPackThreads;
  if (cells < 1 || blocks > 0x7fffffffll ||
      reinterpret_cast<uintptr_t>(win) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_f32_kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0, s>>>(
      static_cast<const float2*>(win), static_cast<u64*>(packed), cells);
  return static_cast<int>(cudaGetLastError());
}

// Sweeps the packed window `packed` ([N, in_r, in_c] u64, 16-byte aligned,
// from csm_sweep_f32_pack_launch on the same stream).  Launches on
// `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int csm_sweep_f32_launch(const void* packed, const void* hr,
                                    const void* hc, const void* ok,
                                    const void* origins, void* out, int N,
                                    int T, int B, int in_r, int in_c, int K,
                                    int tile_h, int tile_w, int stride,
                                    void* stream) {
  if (N < 1 || T < 1 || B < 1 || B > kMaxBeams || in_r < 1 || in_c < 1 ||
      K < 1 || tile_h < 1 || tile_w < 1 || stride < 1 || N > 65535 ||
      T > 65535 || reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
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
  // Beams per thread: csm_sweep.cu's rule first (the fewest that fit in
  // kMaxThreads, doubled while the grid keeps kWarpsToFill warps).  Where
  // that grid runs in at most two waves of resident blocks, the 1, 2 or 4
  // that runs it in the fewest instead (ties to fewer beams a thread).
  const long long blocks = items * T * N;
  auto warps = [B](int per) { return (B + 32 * per - 1) / (32 * per); };
  int sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  auto waves = [&](int p) {
    const int resident = blocks_per_sm(p, warps(p) * 32, rows);
    const long long slots =
        static_cast<long long>(sms) * (resident > 0 ? resident : 1);
    return (blocks + slots - 1) / slots;
  };
  int per = 1;
  while (warps(per) * 32 > kMaxThreads) per *= 2;
  const int least = per;
  while (per < kMaxBeamsPerThread && blocks * warps(2 * per) >= kWarpsToFill) {
    per *= 2;
  }
  long long fewest = waves(per);
  if (fewest <= 2) {
    for (int p = least; p <= kMaxBeamsPerThread; p *= 2) {
      const long long w = waves(p);
      if (w < fewest || (w == fewest && p < per)) {
        per = p;
        fewest = w;
      }
    }
  }
  const int threads = warps(per) * 32;

  SweepF32 a;
  a.win = static_cast<const u64*>(packed);
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
  const dim3 grid(static_cast<unsigned>(items), T, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per * (rows ? 1 : -1)) {
    case 1: sweep_f32_rows_kernel<1><<<grid, threads, 0, s>>>(a); break;
    case 2: sweep_f32_rows_kernel<2><<<grid, threads, 0, s>>>(a); break;
    case 4: sweep_f32_rows_kernel<4><<<grid, threads, 0, s>>>(a); break;
    case -1: sweep_f32_cells_kernel<1><<<grid, threads, 0, s>>>(a); break;
    case -2: sweep_f32_cells_kernel<2><<<grid, threads, 0, s>>>(a); break;
    case -4: sweep_f32_cells_kernel<4><<<grid, threads, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
