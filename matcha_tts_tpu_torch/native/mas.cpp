// Monotonic Alignment Search on the host CPU.
//
// The Glow-TTS recurrence, reading only column y-1:
//
//   dp[x, y] = value[x, y] + max(dp[x, y-1]   if x <  y else -inf,
//                                dp[x-1, y-1] if x >  0 else
//                                (0 if y == 0 else -inf))
//
// Backtrack steps down on index == y or a strictly better down-neighbour.
// The same function as the numpy oracle `ops/mas.py::maximum_path_numpy`
// and the card's kernel (`csrc/mas.cu`): a host counterpart for a machine
// without a card, and a third implementation to hold the two against.
//
// Built by `native/build.py` (g++ -O3 -shared -fPIC -std=c++17, with
// -fopenmp where the compiler takes it: one item a thread).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr float kNeg = -1e30f;
}

extern "C" {

// paths:    (b, t_x, t_y) float32, zero-initialized by caller; overwritten
//           with the one-hot path.
// values:   (b, t_x, t_y) float32 log-prior (const).
// t_xs/t_ys: per-item valid lengths (int32).
void maximum_path_batch(float* paths, const float* values,
                        const int32_t* t_xs, const int32_t* t_ys,
                        int32_t b, int32_t t_x_max, int32_t t_y_max) {
  const int64_t stride_b = (int64_t)t_x_max * t_y_max;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int32_t i = 0; i < b; ++i) {
    float* path = paths + (int64_t)i * stride_b;           // row-major (x, y)
    const float* value = values + (int64_t)i * stride_b;
    const int32_t tx = t_xs[i];
    const int32_t ty = t_ys[i];
    if (tx <= 0 || ty <= 0) continue;

    std::vector<float> dp((int64_t)tx * ty, kNeg);

    // forward DP (true Glow-TTS recurrence; both reads from column y-1)
    for (int32_t y = 0; y < ty; ++y) {
      const int32_t x_lo = std::max(0, tx + y - ty);
      const int32_t x_hi = std::min(tx, y + 1);
      for (int32_t x = x_lo; x < x_hi; ++x) {
        const float stay =
            (x < y) ? dp[(int64_t)x * ty + (y - 1)] : kNeg;
        const float down =
            (x == 0) ? ((y == 0) ? 0.0f : kNeg)
                     : dp[(int64_t)(x - 1) * ty + (y - 1)];
        dp[(int64_t)x * ty + y] =
            std::max(stay, down) + value[(int64_t)x * t_y_max + y];
      }
    }

    // backtrack: step down on index == y or a strictly better neighbor.
    // The y > 0 guard keeps the dp reads in-bounds for degenerate inputs
    // with tx > ty (index can still be > 0 at y == 0, and the decision at
    // y == 0 is discarded anyway).
    int32_t index = tx - 1;
    for (int32_t y = ty - 1; y >= 0; --y) {
      path[(int64_t)index * t_y_max + y] = 1.0f;
      if (index > 0 && y > 0 &&
          (index == y || dp[(int64_t)(index - 1) * ty + (y - 1)] >
                             dp[(int64_t)index * ty + (y - 1)])) {
        --index;
      }
    }
  }
}

}  // extern "C"
