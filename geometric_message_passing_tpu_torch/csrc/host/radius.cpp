// Native cell-list radius graph.  Host-side, O(n) for bounded
// density: points hash into cells of side r; neighbors live in the 3^d
// adjacent cells.  Semantics mirror ops/radius_graph.py::radius_graph_plain:
// directed edges (i, j) with ||pos_i - pos_j|| <= r, optional self-loop
// exclusion, per-node batch isolation, optional nearest-k cap.
//
// C ABI (ctypes): returns the TOTAL edge count; writes min(count, cap)
// edges.  Callers retry with a larger buffer when count > cap.

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

inline uint64_t mix(uint64_t h, uint64_t v) {
  h ^= v + 0x9E3779B97F4A7C15ULL + (h << 6) + (h >> 2);
  return h;
}

}  // namespace

extern "C" {

long gmp_radius_graph(const double* pos, long n, long d, double r,
                      const long* batch, int loop, long max_nb,
                      int* out_rows, int* out_cols, long cap) {
  if (n <= 0 || d <= 0) return 0;
  const double rr = r > 1e-12 ? r : 1e-12;
  const double r2 = r * r;

  std::vector<int64_t> cell(static_cast<size_t>(n) * d);
  for (long i = 0; i < n; ++i)
    for (long k = 0; k < d; ++k)
      // divide (not multiply-by-inverse): the numpy twin uses pos / r, and
      // a 1-ulp difference at a cell boundary would change the candidate
      // enumeration order, breaking element-exact parity
      cell[i * d + k] = static_cast<int64_t>(std::floor(pos[i * d + k] / rr));

  auto cell_hash = [&](long bi, const int64_t* c) -> uint64_t {
    uint64_t h = mix(0x12345678ULL, static_cast<uint64_t>(bi));
    for (long k = 0; k < d; ++k) h = mix(h, static_cast<uint64_t>(c[k]));
    return h;
  };

  std::unordered_map<uint64_t, std::vector<int>> buckets;
  buckets.reserve(static_cast<size_t>(n) * 2);
  for (long i = 0; i < n; ++i)
    buckets[cell_hash(batch ? batch[i] : 0, &cell[i * d])].push_back(
        static_cast<int>(i));

  // 3^d neighbor offsets, same enumeration order as the numpy meshgrid
  long n_off = 1;
  for (long k = 0; k < d; ++k) n_off *= 3;
  std::vector<int64_t> off(static_cast<size_t>(n_off) * d);
  for (long o = 0; o < n_off; ++o) {
    long rem = o;
    for (long k = d - 1; k >= 0; --k) {
      off[o * d + k] = rem % 3 - 1;
      rem /= 3;
    }
  }

  long count = 0;
  std::vector<int64_t> nc(d);
  std::vector<std::pair<double, int>> cand;  // (dist2, j) per node
  for (long i = 0; i < n; ++i) {
    const long bi = batch ? batch[i] : 0;
    cand.clear();
    for (long o = 0; o < n_off; ++o) {
      for (long k = 0; k < d; ++k) nc[k] = cell[i * d + k] + off[o * d + k];
      auto it = buckets.find(cell_hash(bi, nc.data()));
      if (it == buckets.end()) continue;
      for (int j : it->second) {
        // hash buckets can collide: confirm the cell + batch really match
        if ((batch ? batch[j] : 0) != bi) continue;
        bool same = true;
        for (long k = 0; k < d; ++k)
          if (cell[j * d + k] != nc[k]) { same = false; break; }
        if (!same) continue;
        if (!loop && j == i) continue;
        double d2 = 0.0;
        for (long k = 0; k < d; ++k) {
          const double t = pos[static_cast<long>(j) * d + k] - pos[i * d + k];
          d2 += t * t;
        }
        if (d2 <= r2) cand.emplace_back(d2, j);
      }
    }
    if (max_nb >= 0 && static_cast<long>(cand.size()) > max_nb) {
      std::stable_sort(cand.begin(), cand.end(),
                       [](const std::pair<double, int>& a,
                          const std::pair<double, int>& b) {
                         return a.first < b.first;
                       });
      cand.resize(static_cast<size_t>(max_nb));
    }
    for (const auto& pr : cand) {
      if (count < cap) {
        out_rows[count] = static_cast<int>(i);
        out_cols[count] = pr.second;
      }
      ++count;
    }
  }
  return count;
}

}  // extern "C"
