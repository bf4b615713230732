// Rectangular linear assignment problem (LAP) solver.
//
// Shortest-augmenting-path algorithm with dual potentials (the classic
// Jonker-Volgenant / Hungarian scheme, O(n^2 m)), for cost matrices with
// n_rows <= n_cols. Used by the cluster->class matching step of the
// zero-shot clustering accuracy path (the reference relies on scipy's C++
// linear_sum_assignment; reference: src/utils.py:380-405).
//
// Build:  g++ -O2 -shared -fPIC -o liblapjv.so lapjv.cpp

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: row-major [n_rows x n_cols], n_rows <= n_cols.
// out_col4row: length n_rows, receives the matched column of each row.
// Returns 0 on success, -1 on bad arguments.
int lap_solve_f64(const double* cost, int64_t n_rows, int64_t n_cols,
                  int64_t* out_col4row) {
  if (n_rows <= 0 || n_cols < n_rows) return -1;
  const double INF = std::numeric_limits<double>::infinity();

  // 1-indexed potentials and matching, column 0 is the virtual source.
  std::vector<double> u(n_rows + 1, 0.0), v(n_cols + 1, 0.0);
  std::vector<int64_t> match(n_cols + 1, 0);  // match[j] = row matched to col j
  std::vector<int64_t> way(n_cols + 1, 0);

  for (int64_t i = 1; i <= n_rows; ++i) {
    match[0] = i;
    int64_t j0 = 0;
    std::vector<double> minv(n_cols + 1, INF);
    std::vector<char> used(n_cols + 1, 0);
    do {
      used[j0] = 1;
      const int64_t i0 = match[j0];
      double delta = INF;
      int64_t j1 = -1;
      const double* row = cost + (i0 - 1) * n_cols;
      for (int64_t j = 1; j <= n_cols; ++j) {
        if (used[j]) continue;
        const double cur = row[j - 1] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 < 0) return -1;  // unreachable for finite costs
      for (int64_t j = 0; j <= n_cols; ++j) {
        if (used[j]) {
          u[match[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (match[j0] != 0);
    // augment along the alternating path
    do {
      const int64_t j1 = way[j0];
      match[j0] = match[j1];
      j0 = j1;
    } while (j0);
  }

  for (int64_t j = 1; j <= n_cols; ++j) {
    if (match[j] > 0) out_col4row[match[j] - 1] = j - 1;
  }
  return 0;
}

}  // extern "C"
