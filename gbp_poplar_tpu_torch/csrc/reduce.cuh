// The per-output bodies of H3's two-pass sum over permuted segments
// (csrc/reduce.cu), on scalars, so that the host build of the tests runs
// them too. Both sum in one fixed order, so the result is the same from
// run to run: inside a chunk a variable's run in ascending edge order (in
// slices of 32 values where it spans several), then its runs in ascending
// chunk order, then the prior.
#pragma once

#include <stdint.h>

namespace gbp {

// Pass 1 works on a chunk's values gathered into their sorted order
// (variable, then edge), ``sorted``, with one pad word after every SLICE
// values, so that the lanes of a warp summing consecutive slices read
// consecutive banks: value p sits at sorted[pad(p)].
constexpr int SLICE = 32;

__device__ __forceinline__ int pad(int p) { return p + p / SLICE; }

// The sum of sorted values p = begin, ..., end - 1, in order.
__device__ __forceinline__ float run_sum(const float* sorted, int begin,
                                         int end) {
  float acc = 0.0f;
#pragma unroll 4
  for (int p = begin; p < end; ++p) acc = acc + sorted[pad(p)];
  return acc;
}

// Step 1: the sum of one slice of n <= SLICE values (``vals`` =
// &sorted[pad(q * SLICE)]), in order: the same adds as run_sum over the
// slice's positions.
__device__ __forceinline__ float slice_sum(const float* vals, int n) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < SLICE; ++j)
    if (j < n) acc = acc + vals[j];
  return acc;
}

// Step 2: the sum of one variable's run, sorted positions [begin, end):
// within one slice, its values in order; across slices, the values in its
// first slice, then the sums ``full`` of the slices it covers whole, then
// the values in its last slice. A long run (at the Venice shape a chunk
// holds ~11 cameras, runs of up to ~2,800 edges) costs one add per slice.
__device__ __forceinline__ float chunk_run_sum(const float* sorted,
                                               const float* full, int begin,
                                               int end) {
  if (end <= begin) return 0.0f;
  const int q1 = begin / SLICE, q2 = (end - 1) / SLICE;
  if (q1 == q2) return run_sum(sorted, begin, end);
  float acc = run_sum(sorted, begin, (q1 + 1) * SLICE);
#pragma unroll 8
  for (int q = q1 + 1; q < q2; ++q) acc = acc + full[q];
  return acc + run_sum(sorted, q2 * SLICE, end);
}

// Pass 2: ``prior`` (if given) plus the partial sums of one variable's
// runs, ``partial[runs[j]]`` for j = begin, ..., end - 1 (its runs in
// ascending chunk order).
__device__ __forceinline__ float combine_runs(const float* partial,
                                              const int* runs, int begin,
                                              int end, const float* prior) {
  float acc = 0.0f;
#pragma unroll 4
  for (int j = begin; j < end; ++j) acc = acc + partial[runs[j]];
  return prior ? *prior + acc : acc;
}

}  // namespace gbp
