// Strict left-to-right tail sums of a float64 table for many starts,
// several starts at once.
//
// out[i] = arr[s] + arr[s+1] + ... + arr[n-1] with s = max(starts[i], 0),
// accumulated left to right from +0.0 in double precision: the order of
// the reference GRAFIMO's numba ``.sum()`` and of the scalar
// ``seq_tail_sums`` in ``native/graphite.cpp``, which this file gives bit
// for bit.  A start at ``n`` or above gives +0.0.
//
// The order leaves no partial sum to share between two starts, but the
// chains of different starts are independent.  Starts are taken in
// ascending order, ``kLanes`` at a time; a group sweeps j once from its
// smallest start to n - 1 and adds arr[j] to every lane.  A lane whose
// start is still ahead of j adds +0.0 to its +0.0 accumulator, which
// leaves it +0.0; from its start on it makes the scalar loop's adds in
// the scalar loop's order.  Once j passes the group's largest start,
// every lane adds arr[j].  The lane loops are written for the compiler
// to vectorise (-O3 -march=native; no reassociation is asked for or
// needed).  A group of one start runs the scalar loop.  ``counts[0]`` and
// ``counts[1]`` gain the groups summed in lanes and the starts summed alone.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

// sixteen 256-bit (or eight 512-bit) registers of independent add chains,
// more than an add's latency at two vector adds a cycle needs.  On two
// Sapphire Rapids hosts (g++ 13, -march=native) the tail sums of a JASPAR
// motif's 3,700 occupied bins took 0.72 and 0.69 ms with 64 lanes, 0.81
// and 0.69 ms with 32
constexpr int64_t kLanes = 64;

double scalar_tail(const double* arr, int64_t n, int64_t s) {
  double acc = 0.0;
  for (int64_t j = s; j < n; ++j) acc += arr[j];
  return acc;
}

// one group of kLanes starts, ascending, each in [0, n]
void lane_tails(const double* arr, int64_t n, const int64_t* s,
                double* acc) {
  for (int64_t l = 0; l < kLanes; ++l) acc[l] = 0.0;
  const int64_t ramp_end = s[kLanes - 1];
  for (int64_t j = s[0]; j < ramp_end; ++j) {
    const double v = arr[j];
    for (int64_t l = 0; l < kLanes; ++l) acc[l] += (j >= s[l]) ? v : 0.0;
  }
  for (int64_t j = ramp_end; j < n; ++j) {
    const double v = arr[j];
    for (int64_t l = 0; l < kLanes; ++l) acc[l] += v;
  }
}

}  // namespace

extern "C" {

int64_t tail_sum_lanes() { return kLanes; }

void lane_tail_sums(const double* arr, int64_t n, const int64_t* starts,
                    int64_t m, double* out, int64_t* counts) {
  std::vector<int64_t> clamped(m);
  for (int64_t i = 0; i < m; ++i)
    clamped[i] = std::min(std::max<int64_t>(starts[i], 0), n);
  std::vector<int64_t> order(m);
  std::iota(order.begin(), order.end(), 0);
  if (!std::is_sorted(clamped.begin(), clamped.end()))
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return clamped[a] < clamped[b];
    });
  int64_t s[kLanes];
  double acc[kLanes];
  for (int64_t g = 0; g < m; g += kLanes) {
    const int64_t size = std::min(kLanes, m - g);
    if (size == 1) {
      out[order[g]] = scalar_tail(arr, n, clamped[order[g]]);
      ++counts[1];
      continue;
    }
    // a short last group repeats its largest start in the idle lanes
    for (int64_t l = 0; l < kLanes; ++l)
      s[l] = clamped[order[g + std::min(l, size - 1)]];
    lane_tails(arr, n, s, acc);
    ++counts[0];
    for (int64_t l = 0; l < size; ++l) out[order[g + l]] = acc[l];
  }
}

}  // extern "C"
