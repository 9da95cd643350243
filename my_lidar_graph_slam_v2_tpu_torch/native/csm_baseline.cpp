// CPU baseline: real-time correlative scan matching, reference algorithm.
//
// A faithful re-statement (not a copy) of the reference's software CSM
// path (scan_matcher_correlative.cpp:116-368 + the sliding-window-max
// precompute of grid_map_builder.cpp:917-1065), written as a standalone
// C module so the benchmark harness can compare the TPU kernel against an
// honest optimized-CPU implementation of the same algorithm:
//   - coarse map: per-cell max over a low_res x low_res window
//   - search: theta outer loop with per-theta beam cell precompute,
//     coarse (x, y) sweep with running-max pruning, fine descend into
//     winning blocks.
// Build: g++ -O3 -shared -fPIC -o libcsm_baseline.so csm_baseline.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sliding-window max (anchored at the cell, extending to higher indices),
// separable rows-then-cols; prob map with 0 = unknown.
void precompute_coarse_map(const float* prob, float* coarse, int rows,
                           int cols, int win) {
  std::vector<float> tmp(static_cast<size_t>(rows) * cols);
  for (int c = 0; c < cols; ++c) {
    for (int r = 0; r < rows; ++r) {
      float m = 0.0f;
      const int hi = r + win < rows ? r + win : rows;
      for (int k = r; k < hi; ++k) {
        const float v = prob[static_cast<size_t>(k) * cols + c];
        if (v > m) m = v;
      }
      tmp[static_cast<size_t>(r) * cols + c] = m;
    }
  }
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < cols; ++c) {
      float m = 0.0f;
      const int hi = c + win < cols ? c + win : cols;
      for (int k = c; k < hi; ++k) {
        const float v = tmp[static_cast<size_t>(r) * cols + k];
        if (v > m) m = v;
      }
      coarse[static_cast<size_t>(r) * cols + c] = m;
    }
  }
}

static inline void score_at(const float* map, int rows, int cols,
                            const int* ri, const int* ci, int n, int ox,
                            int oy, double* sum_out, int* known_out) {
  double s = 0.0;
  int known = 0;
  for (int i = 0; i < n; ++i) {
    const int r = ri[i] + oy;
    const int c = ci[i] + ox;
    if (r < 0 || r >= rows || c < 0 || c >= cols) continue;
    const float p = map[static_cast<size_t>(r) * cols + c];
    if (p != 0.0f) {
      s += p;
      ++known;
    }
  }
  *sum_out = s;
  *known_out = known;
}

// Correlative search. Returns best (x_cells, y_cells, t_index) offsets and
// the normalized best score. Steps: step_x = step_y = resolution,
// step_theta passed in. Window: +-win_x/win_y cells, +-win_t theta steps.
double correlative_search(const float* fine, const float* coarse, int rows,
                          int cols, const float* ranges, const float* angles,
                          int n_beams, double sx, double sy, double stheta,
                          double resolution, double off_x, double off_y,
                          int win_x, int win_y, int win_t, double step_theta,
                          int low_res, double score_thresh,
                          double known_thresh, int* best_out) {
  std::vector<int> ri(n_beams), ci(n_beams);
  double score_max = score_thresh;
  int bx = -win_x, by = -win_y, bt = -win_t;
  const double inv_res = 1.0 / resolution;
  for (int t = -win_t; t <= win_t; ++t) {
    const double th = stheta + step_theta * t;
    for (int i = 0; i < n_beams; ++i) {
      const double a = th + angles[i];
      const double hx = sx + ranges[i] * std::cos(a);
      const double hy = sy + ranges[i] * std::sin(a);
      ci[i] = static_cast<int>(std::floor((hx - off_x) * inv_res));
      ri[i] = static_cast<int>(std::floor((hy - off_y) * inv_res));
    }
    for (int x = -win_x; x <= win_x; x += low_res) {
      for (int y = -win_y; y <= win_y; y += low_res) {
        double s;
        int known;
        score_at(coarse, rows, cols, ri.data(), ci.data(), n_beams, x, y, &s,
                 &known);
        const double ns = s / n_beams;
        const double kr = static_cast<double>(known) / n_beams;
        if (ns <= score_max || kr <= known_thresh) continue;
        for (int fx = x; fx < x + low_res; ++fx) {
          for (int fy = y; fy < y + low_res; ++fy) {
            double fs;
            int fk;
            score_at(fine, rows, cols, ri.data(), ci.data(), n_beams, fx, fy,
                     &fs, &fk);
            const double fns = fs / n_beams;
            if (score_max < fns) {
              score_max = fns;
              bx = fx;
              by = fy;
              bt = t;
            }
          }
        }
      }
    }
  }
  best_out[0] = bx;
  best_out[1] = by;
  best_out[2] = bt;
  return score_max;
}

}  // extern "C"
