// edsnet_native: host-side exact solvers backing the preprocessing path.
//
// The port's own copy of edsnet_tpu/native/src/edsnet_native.cpp, built by
// edsnet_torch/native.py with g++ into edsnet_torch/kernels/_build/.
//
// The reference consumes ortools' C++ knapsack branch-and-bound
// (reference: src/helpers/vsumm_helper.py:26-45) and NumPy loops for the KTS
// change-point DP (reference: src/kts/cpd_nonlin.py).  This library provides
// first-party C++ equivalents, exposed over a plain C ABI and loaded from
// Python via ctypes.
//
// Exactness: values/weights are integers, so branch-and-bound and dense DP
// agree on the optimum; we use Horowitz–Sahni style B&B with a fractional
// (Dantzig) upper bound, which is fast and O(n) memory.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 0/1 knapsack, exact branch & bound.
// values/weights: n items (>=0).  out_selected: n bytes, 1 = packed.
// Returns the optimal total value.
// ---------------------------------------------------------------------------
int64_t eds_knapsack(const int64_t* values, const int64_t* weights, int32_t n,
                     int64_t capacity, uint8_t* out_selected) {
  std::memset(out_selected, 0, n);
  if (n <= 0 || capacity <= 0) return 0;

  // Sort item ids by value density, descending; zero-weight items with
  // positive value are always taken.
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    // compare v_a / w_a > v_b / w_b without division: v_a * w_b > v_b * w_a
    // (handle w == 0 as infinite density)
    const int64_t wa = weights[a], wb = weights[b];
    if (wa == 0 || wb == 0) {
      if (wa == 0 && wb == 0) return values[a] > values[b];
      return wa == 0;
    }
    const __int128 lhs = (__int128)values[a] * wb;
    const __int128 rhs = (__int128)values[b] * wa;
    if (lhs != rhs) return lhs > rhs;
    return a < b;
  });

  std::vector<int64_t> v(n), w(n);
  for (int32_t i = 0; i < n; ++i) {
    v[i] = values[order[i]];
    w[i] = weights[order[i]];
  }

  std::vector<uint8_t> cur(n, 0), best(n, 0);
  int64_t best_value = -1;

  // iterative DFS with explicit stack: state = (depth, decision pending)
  struct Frame {
    int32_t depth;
    uint8_t phase;  // 0 = try take, 1 = try skip, 2 = unwind
  };
  std::vector<Frame> stack;
  stack.push_back({0, 0});
  int64_t cur_value = 0, cur_weight = 0;

  auto upper_bound = [&](int32_t depth, int64_t value, int64_t room) {
    // Dantzig bound: greedy + fractional next item.
    double ub = (double)value;
    for (int32_t i = depth; i < n && room > 0; ++i) {
      if (v[i] <= 0) continue;
      if (w[i] <= room) {
        room -= w[i];
        ub += (double)v[i];
      } else {
        ub += (double)v[i] * (double)room / (double)w[i];
        break;
      }
    }
    return ub;
  };

  while (!stack.empty()) {
    Frame& f = stack.back();
    const int32_t d = f.depth;
    if (d == n) {
      if (cur_value > best_value) {
        best_value = cur_value;
        best = cur;
      }
      stack.pop_back();
      continue;
    }
    if (f.phase == 0) {
      f.phase = 1;
      // prune
      if (upper_bound(d, cur_value, capacity - cur_weight) <=
          (double)best_value) {
        stack.pop_back();
        continue;
      }
      if (cur_weight + w[d] <= capacity && v[d] > 0) {
        cur[d] = 1;
        cur_value += v[d];
        cur_weight += w[d];
        stack.push_back({d + 1, 0});
      }
      continue;
    }
    if (f.phase == 1) {
      f.phase = 2;
      if (cur[d]) {  // undo the take branch
        cur[d] = 0;
        cur_value -= v[d];
        cur_weight -= w[d];
      }
      stack.push_back({d + 1, 0});
      continue;
    }
    stack.pop_back();
  }

  for (int32_t i = 0; i < n; ++i)
    if (best[i]) out_selected[order[i]] = 1;
  return best_value < 0 ? 0 : best_value;
}

// ---------------------------------------------------------------------------
// KTS change-point DP (reference: src/kts/cpd_nonlin.py:29-92).
// J: (n x n) row-major scatter matrix.  Fills:
//   scores: (m+1) objective values I[k, n]
//   path:   (m+1) x (n+1) backtrack table (int32), only if backtrack != 0
// ---------------------------------------------------------------------------
void eds_kts_dp(const double* J, int32_t n, int32_t m, int32_t lmin,
                int32_t lmax, int32_t backtrack, double* scores,
                int32_t* path) {
  const double INF = 1e101;
  std::vector<double> I((size_t)(m + 1) * (n + 1), INF);
  auto Iat = [&](int32_t k, int32_t l) -> double& {
    return I[(size_t)k * (n + 1) + l];
  };
  auto Jat = [&](int32_t t, int32_t l) { return J[(size_t)t * n + l]; };

  for (int32_t l = lmin; l < lmax && l <= n; ++l) Iat(0, l) = Jat(0, l - 1);

  for (int32_t k = 1; k <= m; ++k) {
    for (int32_t l = (k + 1) * lmin; l <= n; ++l) {
      const int32_t tmin = std::max(k * lmin, l - lmax);
      const int32_t tmax = l - lmin + 1;
      double bestv = INF;
      int32_t bestt = 0;
      for (int32_t t = tmin; t < tmax; ++t) {
        const double c = Jat(t, l - 1) + Iat(k - 1, t);
        if (c < bestv) {
          bestv = c;
          bestt = t;
        }
      }
      Iat(k, l) = bestv;
      if (backtrack) path[(size_t)k * (n + 1) + l] = bestt;
    }
  }
  for (int32_t k = 0; k <= m; ++k) scores[k] = Iat(k, n);
}

}  // extern "C"
