// Damped Gauss-Newton scan refinement and its covariance for Hopper
// (sm_90a): one block per match, the whole loop on chip.
//
// Replaces no Pallas kernel: the JAX package leaves this computation to
// XLA (my_lidar_graph_slam_v2_tpu/ops/gauss_newton.py:gn_refine and
// covariance).  Its plain PyTorch version (ops/gauss_newton.py:refine on
// the CPU) issues ~2,300 small device ops per match, and the host's
// dispatch of those ops, not the device, held the frontend match and the
// loop detector's final matcher back.  This kernel computes what one
// match needs after the search in one launch:
//
//   cost0            the initial cost (ops/gauss_newton.py:cost: each
//                    residual squared in f32, the squares summed in f64)
//   pose, cost, it   the max_iterations masked damped-GN steps of
//                    gn_refine: solve (H + lambda I) step = b, accept the
//                    step when the cost falls, halve or quadruple lambda,
//                    stop on max_iterations or a small accepted change
//   cov              scale * H^-1 of the H kept at the final pose, which
//                    is what covariance(pose) evaluates afresh
//
// The same bits as the plain version.  Every f32 + - * / below is one
// IEEE op rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn:
// nvcc never contracts them into FMAs), in the plain version's order.  The
// trig is f64 cos/sin rounded to f32 (utils/devmath.py); each entry of
// (W K)^T K, K = [gx, gy, gt, 1 - value] per beam, is a sum of exact f64
// products rounded to f32 once (devmath.matmul); the 3x3 solves and the
// inverse are f64 LU with partial pivoting in LAPACK getrf/getrs's order,
// rounded to f32 once (devmath.solve, devmath.inv).  An f32-to-i32 cast
// gives INT_MIN out of range, as the CPU's does.  The f64 reductions run
// in a fixed order with no atomics, so a run gives the same bits as the
// last.
//
// What bounds it on this card: latency, not bytes or operations.  One
// evaluation reads, per beam, a range, an angle, a mask byte and four
// corners of the raster and of its observed mask (<= 20 B per beam from
// L2), and does ~60 f32 ops, an f64 cos and sin and 11 f64 products.  At
// 512 beams and 11 evaluations that is ~110 KB and ~0.5 MFLOP: well under
// a microsecond of the card's bandwidth or f64 rate.  The evaluations form
// a serial chain (each step needs the last evaluation's sums and one
// thread's 3x3 solve), so the time is 11 block reductions and 11 small
// f64 solves back to back.  The design keeps that chain in one block: the
// state (pose, lambda, H, b, cost) stays in thread 0's registers, the
// evaluated pose is passed through shared memory, a converged match stops
// early (a frozen state would change no further), and the host issues one
// launch in place of the chain of ops.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The upper triangle of the symmetric 4x4 (W K)^T K, then the initial
// cost's sum of squares.
constexpr int kEntries = 10;
constexpr int kSums = kEntries + 1;
// f32(1 / 255), ops/quant.py:INV255.
constexpr float kInv255 = 0x1.010102p-8f;

// Output layout (f32 [16]): pose, cost, iterations (i32 bits),
// covariance row-major, initial cost, one unused.
constexpr int kOutPose = 0;
constexpr int kOutCost = 3;
constexpr int kOutIters = 4;
constexpr int kOutCov = 5;
constexpr int kOutCost0 = 14;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// f32 -> i32 truncation as x86's cvttss2si (the CPU's cast): INT_MIN for
// NaN and out of range, where CUDA's own cast saturates.
__device__ __forceinline__ int to_i32(float v) {
  return (v >= -2147483648.0f && v < 2147483648.0f) ? static_cast<int>(v)
                                                     : INT_MIN;
}

__device__ __forceinline__ float dequant(uint8_t v) {
  return mul(static_cast<float>(v), kInv255);
}
__device__ __forceinline__ float dequant(float v) { return v; }

// One corner of the bilinear read (ops/gauss_newton.py:_bilinear_values):
// the clamped cell's probability where it is observed and (r, c) lies on
// the raster, else 0.5.
template <typename P>
__device__ __forceinline__ float corner(const P* __restrict__ prob,
                                        const uint8_t* __restrict__ observed,
                                        int rows, int cols, int r, int c) {
  const bool inside = r >= 0 && r < rows && c >= 0 && c < cols;
  const long long idx =
      static_cast<long long>(min(max(r, 0), rows - 1)) * cols +
      min(max(c, 0), cols - 1);
  const float p = dequant(prob[idx]);
  return (observed[idx] != 0 && inside) ? p : 0.5f;
}

struct Inputs {
  int rows, cols, beams;
  const float* ranges;
  const float* angles;
  const uint8_t* mask;
  const uint8_t* observed;
  const float* offset;
  float res, inv_res;
};

// The sums of one evaluation at `pose` (ops/gauss_newton.py:
// hessian_and_residual, and cost when `with_cost0`): every thread strides
// over the beams, accumulates its f64 products, the warps reduce by
// shuffles and thread 0 adds the warps' partials in order.  Only thread
// 0's `total` is set.  Ends with every thread past its last read of
// `pose`.
template <typename P>
__device__ void evaluate(const P* __restrict__ prob, const Inputs& in,
                         const float* pose, bool with_cost0,
                         double (*partial)[kSums], double* total) {
  const float px = pose[0], py = pose[1], pt = pose[2];
  const float ox = in.offset[0], oy = in.offset[1];
  double acc[kSums];
#pragma unroll
  for (int e = 0; e < kSums; ++e) acc[e] = 0.0;
  for (int b = threadIdx.x; b < in.beams; b += kThreads) {
    const float range = in.ranges[b];
    const float ang = add(pt, in.angles[b]);
    const float cs = static_cast<float>(cos(static_cast<double>(ang)));
    const float sn = static_cast<float>(sin(static_cast<double>(ang)));
    const float hx = add(px, mul(range, cs));
    const float hy = add(py, mul(range, sn));
    const float fcol = sub(__fdiv_rn(sub(hx, ox), in.res), 0.5f);
    const float frow = sub(__fdiv_rn(sub(hy, oy), in.res), 0.5f);
    const float r0 = floorf(frow);
    const float c0 = floorf(fcol);
    const float dr = sub(frow, r0);
    const float dc = sub(fcol, c0);
    const int rc0 = max(to_i32(r0), 0);
    const int cc0 = max(to_i32(c0), 0);
    const int rc1 = min(rc0 + 1, in.rows - 1);
    const int cc1 = min(cc0 + 1, in.cols - 1);
    const float m00 = corner(prob, in.observed, in.rows, in.cols, rc0, cc0);
    const float m01 = corner(prob, in.observed, in.rows, in.cols, rc1, cc0);
    const float m10 = corner(prob, in.observed, in.rows, in.cols, rc0, cc1);
    const float m11 = corner(prob, in.observed, in.rows, in.cols, rc1, cc1);
    const float udr = sub(1.0f, dr);
    const float udc = sub(1.0f, dc);
    const float value =
        add(mul(dr, add(mul(dc, m11), mul(udc, m01))),
            mul(udr, add(mul(dc, m10), mul(udc, m00))));
    const float grad_x = add(mul(dr, sub(m11, m01)), mul(udr, sub(m10, m00)));
    const float grad_y = add(mul(dc, sub(m11, m10)), mul(udc, sub(m01, m00)));
    const float gx = mul(grad_x, in.inv_res);
    const float gy = mul(grad_y, in.inv_res);
    const float rx = sub(hx, px);
    const float ry = sub(hy, py);
    const float gt = add(mul(-ry, gx), mul(rx, gy));
    const float k[4] = {gx, gy, gt, sub(1.0f, value)};
    const bool valid = in.mask[b] != 0;
    const float m = valid ? 1.0f : 0.0f;
    // (W K)^T K as devmath.matmul forms it: the f32 product K * mask,
    // times K, each product exact in f64.
    int e = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double kw = static_cast<double>(mul(k[i], m));
#pragma unroll
      for (int j = i; j < 4; ++j) {
        acc[e++] += kw * static_cast<double>(k[j]);
      }
    }
    if (with_cost0) {
      const float err = valid ? k[3] : 0.0f;
      acc[kEntries] += static_cast<double>(mul(err, err));
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kSums; ++e) {
    double v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) partial[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int e = 0; e < kSums; ++e) {
      double t = partial[0][e];
      for (int w = 1; w < kWarps; ++w) t += partial[w][e];
      total[e] = t;
    }
  }
}

// LU with partial pivoting of a 3x3 in place, as LAPACK's getrf: the
// first row of largest |a| pivots, the column below a nonzero pivot is
// scaled by its reciprocal, the trailing block updated.
__device__ void lu3(double a[3][3], int piv[3]) {
  for (int j = 0; j < 3; ++j) {
    int p = j;
    double best = fabs(a[j][j]);
    for (int i = j + 1; i < 3; ++i) {
      if (fabs(a[i][j]) > best) {
        best = fabs(a[i][j]);
        p = i;
      }
    }
    piv[j] = p;
    if (p != j) {
      for (int k = 0; k < 3; ++k) {
        const double t = a[j][k];
        a[j][k] = a[p][k];
        a[p][k] = t;
      }
    }
    if (a[j][j] != 0.0) {
      if (fabs(a[j][j]) >= 2.2250738585072014e-308) {
        const double r = 1.0 / a[j][j];
        for (int i = j + 1; i < 3; ++i) a[i][j] *= r;
      } else {
        for (int i = j + 1; i < 3; ++i) a[i][j] /= a[j][j];
      }
    }
    for (int i = j + 1; i < 3; ++i) {
      for (int k = j + 1; k < 3; ++k) a[i][k] -= a[i][j] * a[j][k];
    }
  }
}

// Solve with lu3's factors, as LAPACK's getrs: the row swaps, the unit
// lower solve, then the upper solve by columns (no skip of zero entries,
// so a zero pivot gives inf or NaN).
__device__ void lu3_solve(const double a[3][3], const int piv[3],
                          double x[3]) {
  for (int j = 0; j < 3; ++j) {
    if (piv[j] != j) {
      const double t = x[j];
      x[j] = x[piv[j]];
      x[piv[j]] = t;
    }
  }
  for (int j = 0; j < 3; ++j) {
    for (int i = j + 1; i < 3; ++i) x[i] -= a[i][j] * x[j];
  }
  for (int j = 2; j >= 0; --j) {
    x[j] /= a[j][j];
    for (int i = 0; i < j; ++i) x[i] -= a[i][j] * x[j];
  }
}

// (H + lambda I)^-1 b in f64, rounded to f32 (devmath.solve of the f32
// sum H + lambda * eye).
__device__ void damped_step(const float H[3][3], const float b[3], float lam,
                            float step[3]) {
  double a[3][3], x[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      a[i][j] = static_cast<double>(
          add(H[i][j], mul(lam, i == j ? 1.0f : 0.0f)));
    }
    x[i] = static_cast<double>(b[i]);
  }
  int piv[3];
  lu3(a, piv);
  lu3_solve(a, piv, x);
  for (int i = 0; i < 3; ++i) step[i] = static_cast<float>(x[i]);
}

// scale * H^-1 (covariance: devmath.inv, the f32 result times scale).
__device__ void scaled_inverse(const float H[3][3], float scale,
                               float* out) {
  double a[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) a[i][j] = static_cast<double>(H[i][j]);
  }
  int piv[3];
  lu3(a, piv);
  for (int c = 0; c < 3; ++c) {
    double x[3] = {0.0, 0.0, 0.0};
    x[c] = 1.0;
    lu3_solve(a, piv, x);
    for (int r = 0; r < 3; ++r) {
      out[r * 3 + c] = mul(static_cast<float>(x[r]), scale);
    }
  }
}

// H [3x3], b [3] and the cost from the 10 entries of (W K)^T K, each
// rounded to f32 once.
__device__ void unpack(const double* total, float H[3][3], float b[3],
                       float* cost) {
  float m[4][4];
  int e = 0;
  for (int i = 0; i < 4; ++i) {
    for (int j = i; j < 4; ++j) {
      m[i][j] = m[j][i] = static_cast<float>(total[e++]);
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) H[i][j] = m[i][j];
    b[i] = m[i][3];
  }
  *cost = m[3][3];
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
gauss_newton_kernel(const P* __restrict__ prob, Inputs in,
                    const float* __restrict__ pose0,
                    int max_iterations, float threshold, float lambda0,
                    float scale, float* __restrict__ out) {
  __shared__ double partial[kWarps][kSums];
  __shared__ float pose_s[3];
  __shared__ int done_s;
  double total[kSums];
  // The state, live in thread 0 only.
  float p[3], H[3][3], b[3], cur = 0.0f, lam = lambda0;
  int it = 0;
  bool done = false;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) pose_s[i] = p[i] = pose0[i];
  }
  __syncthreads();
  evaluate(prob, in, pose_s, true, partial, total);
  if (threadIdx.x == 0) {
    unpack(total, H, b, &cur);
    out[kOutCost0] = static_cast<float>(total[kEntries]);
  }
  for (int k = 0; k < max_iterations; ++k) {
    if (threadIdx.x == 0) {
      if (!done) {
        float step[3];
        damped_step(H, b, lam, step);
        for (int i = 0; i < 3; ++i) pose_s[i] = add(p[i], step[i]);
      }
      done_s = done;
    }
    __syncthreads();
    // Once the stop test has held the plain loop's state stays frozen,
    // so the remaining steps would change nothing.
    if (done_s) break;
    evaluate(prob, in, pose_s, false, partial, total);
    if (threadIdx.x == 0) {
      float Hn[3][3], bn[3], cn;
      unpack(total, Hn, bn, &cn);
      const bool accept = cn < cur;
      const int it_new = it + 1;
      const bool stop = it_new >= max_iterations ||
                        (accept && fabsf(sub(cur, cn)) < threshold);
      if (accept) {
        for (int i = 0; i < 3; ++i) {
          p[i] = pose_s[i];
          b[i] = bn[i];
          for (int j = 0; j < 3; ++j) H[i][j] = Hn[i][j];
        }
        cur = cn;
        // torch.clamp keeps a NaN
        const float half = mul(lam, 0.5f);
        lam = half < 1e-8f ? 1e-8f : half;
      } else {
        const float quad = mul(lam, 4.0f);
        lam = quad > 1e6f ? 1e6f : quad;
      }
      it = it_new;
      done = stop;
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) out[kOutPose + i] = p[i];
    out[kOutCost] = cur;
    reinterpret_cast<int*>(out)[kOutIters] = it;
    scaled_inverse(H, scale, out + kOutCov);
  }
}

}  // namespace

// One match: `prob` [rows, cols] u8 (prob_is_f32 == 0) or f32, `observed`
// [rows, cols] bool, ranges / angles f32 [beams], mask bool [beams],
// pose0 f32 [3] (map-local sensor pose), offset f32 [2]; `out` f32 [16]
// (layout above).  Launches one block on `stream`; returns the launch's
// CUDA error (0 on success).
extern "C" int gauss_newton_launch(
    const void* prob, int prob_is_f32, const void* observed, int rows,
    int cols, const void* ranges, const void* angles, const void* mask,
    int beams, const void* pose0, const void* offset, float res,
    float inv_res, int max_iterations, float threshold, float lambda0,
    float scale, void* out, void* stream) {
  if (rows < 1 || cols < 1 || beams < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  in.rows = rows;
  in.cols = cols;
  in.beams = beams;
  in.ranges = static_cast<const float*>(ranges);
  in.angles = static_cast<const float*>(angles);
  in.mask = static_cast<const uint8_t*>(mask);
  in.observed = static_cast<const uint8_t*>(observed);
  in.offset = static_cast<const float*>(offset);
  in.res = res;
  in.inv_res = inv_res;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p0 = static_cast<const float*>(pose0);
  float* o = static_cast<float*>(out);
  if (prob_is_f32) {
    gauss_newton_kernel<float><<<1, kThreads, 0, s>>>(
        static_cast<const float*>(prob), in, p0, max_iterations, threshold,
        lambda0, scale, o);
  } else {
    gauss_newton_kernel<uint8_t><<<1, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(prob), in, p0, max_iterations, threshold,
        lambda0, scale, o);
  }
  return static_cast<int>(cudaGetLastError());
}
