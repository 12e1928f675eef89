// Native host-side planners of the PyTorch port.
//
// The KAISA greedy longest-processing-time assignment
// (kfac/assignment.py:226-318 of the original library) and the bucket
// column packer, with a C ABI reached through ctypes
// (kfac_pytorch_tpu_torch/_native/__init__.py).  Each has a Python twin
// (kfac_pytorch_tpu_torch/assignment.py, parallel/bucketing.py) that
// tests/test_torch_native.py holds output-identical to it.  The same
// algorithm as the JAX package's copy of this file, kept here so the
// port builds its own.
//
// Build (done at first use): g++ -O3 -shared -fPIC -std=c++17
//   -o libkfac_planner.so kfac_planner.cc

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// KAISA greedy longest-processing-time constrained assignment
// (kfac/assignment.py:226-318).
//
// Inputs:
//   n_layers, n_factors: dense [n_layers, n_factors] cost matrix;
//     entries < 0 mark absent factors.
//   tie_rank: [n_layers, n_factors] tiebreak rank for equal-cost factors
//     within a layer (higher = earlier), encoding the reference's
//     sort-by-(cost, name)-descending.
//   groups: [n_groups, group_size] worker ranks, rows sorted ascending,
//     rows ordered by their minimum rank (the caller guarantees both).
//   colocate: all factors of a layer on one worker when nonzero.
// Output:
//   out: [n_layers, n_factors] assigned worker rank (-1 for absent).
// Returns 0 on success.
int kfac_greedy_assignment(
    int32_t n_layers,
    int32_t n_factors,
    const double* costs,
    const int32_t* tie_rank,
    int32_t n_groups,
    int32_t group_size,
    const int32_t* groups,
    int32_t world_size,
    int32_t colocate,
    int32_t* out) {
  if (n_layers < 0 || n_factors <= 0 || n_groups <= 0 || group_size <= 0 ||
      world_size <= 0) {
    return 1;
  }
  std::vector<double> worker_loads(world_size, 0.0);
  std::vector<double> summed(n_layers, 0.0);
  for (int32_t l = 0; l < n_layers; ++l) {
    for (int32_t f = 0; f < n_factors; ++f) {
      double c = costs[l * n_factors + f];
      out[l * n_factors + f] = -1;
      if (c >= 0) summed[l] += c;
    }
  }
  // Layers in descending summed cost; stable to preserve insertion
  // order on ties, matching Python's sorted(..., reverse=True).
  std::vector<int32_t> order(n_layers);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return summed[a] > summed[b];
  });

  for (int32_t li : order) {
    // Least-loaded worker group (first on ties, like list.index(min)).
    int32_t best_g = 0;
    double best_load = 0.0;
    for (int32_t g = 0; g < n_groups; ++g) {
      double load = 0.0;
      for (int32_t i = 0; i < group_size; ++i) {
        load += worker_loads[groups[g * group_size + i]];
      }
      if (g == 0 || load < best_load) {
        best_load = load;
        best_g = g;
      }
    }
    const int32_t* group = groups + best_g * group_size;
    if (colocate) {
      int32_t min_w = group[0];
      for (int32_t i = 1; i < group_size; ++i) {
        if (worker_loads[group[i]] < worker_loads[min_w]) min_w = group[i];
      }
      worker_loads[min_w] += summed[li];
      for (int32_t f = 0; f < n_factors; ++f) {
        if (costs[li * n_factors + f] >= 0) out[li * n_factors + f] = min_w;
      }
    } else {
      // Factors in descending (cost, tie_rank).
      std::vector<int32_t> forder;
      for (int32_t f = 0; f < n_factors; ++f) {
        if (costs[li * n_factors + f] >= 0) forder.push_back(f);
      }
      std::stable_sort(
          forder.begin(), forder.end(), [&](int32_t a, int32_t b) {
            double ca = costs[li * n_factors + a];
            double cb = costs[li * n_factors + b];
            if (ca != cb) return ca > cb;
            return tie_rank[li * n_factors + a] > tie_rank[li * n_factors + b];
          });
      for (int32_t f : forder) {
        int32_t min_w = group[0];
        for (int32_t i = 1; i < group_size; ++i) {
          if (worker_loads[group[i]] < worker_loads[min_w]) min_w = group[i];
        }
        worker_loads[min_w] += costs[li * n_factors + f];
        out[li * n_factors + f] = min_w;
      }
    }
  }
  return 0;
}

// Bucket column packing (kfac_pytorch_tpu_torch/parallel/bucketing.py):
// buckets arrive in descending per-slot cost order; within each bucket,
// layers (already sorted by the caller) go one-by-one to the currently
// least-loaded column (lowest index on ties).
//
// Inputs:
//   n_buckets, bucket_sizes: layers per bucket, in bucket order.
//   bucket_costs: per-slot cost of each bucket.
//   n_cols: gradient-worker columns.
// Output:
//   out_cols: flat [sum(bucket_sizes)] column index per layer, in the
//     same order the layers were passed.
int kfac_bucket_columns(
    int32_t n_buckets,
    const int32_t* bucket_sizes,
    const double* bucket_costs,
    int32_t n_cols,
    int32_t* out_cols) {
  if (n_buckets < 0 || n_cols <= 0) return 1;
  std::vector<double> col_loads(n_cols, 0.0);
  int64_t idx = 0;
  for (int32_t b = 0; b < n_buckets; ++b) {
    double cost = bucket_costs[b];
    for (int32_t i = 0; i < bucket_sizes[b]; ++i) {
      int32_t best = 0;
      for (int32_t c = 1; c < n_cols; ++c) {
        if (col_loads[c] < col_loads[best]) best = c;
      }
      out_cols[idx++] = best;
      col_loads[best] += cost;
    }
  }
  return 0;
}

}  // extern "C"
