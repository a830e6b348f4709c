// Deterministic CSR segmented sum (H3): out[c][v] = prior[c][v] + the sum
// of planes[c][e] over variable v's edges.
//
// Replaces gbp_poplar_tpu/ops/reduce_kernel.py::_reduce_kernel with
// blocked_reduce / combine_partials, and the fused sweep kernel's
// reduction epilogue with combine_grid_any. Every output is summed in one
// fixed order, so the result is the same from run to run. Bound: bytes,
// one pass over the rows (plus the edges' index) and the per-variable
// outputs.
//
// Contiguous segments (landmarks: variable v's edges are ptr[v] ...
// ptr[v+1] - 1 of the landmark-sorted order), in ascending edge order:
//   group == 1:  one thread per (component, variable), a sequential sum;
//                consecutive threads take consecutive variables.
//   group == 32: one warp per (component, variable) for long segments;
//                lane l sums the edges j = ptr[v] + l + 32k in order, and a
//                butterfly of shuffles (the same on every lane, since
//                a + b == b + a) combines the 32 lane sums.
//
// Permuted segments (cameras, the coarse groups, the GN/LM per-camera
// sums) go by their chunk plan (core/factor_graph.chunk_plan), in two
// passes:
//   reduce_chunks:  one block per (chunk of K = 8,192 edges, group of
//                   components), the groups of one chunk next to each
//                   other, so its plan stays in L2; two blocks per SM.
//                   Per component row the block bulk-copies the chunk's K
//                   values into shared memory, gathers them into the
//                   chunk's sorted order, and writes one partial sum per
//                   run (a variable's edges in the chunk).
//   reduce_combine: one thread per (component, variable), consecutive
//                   threads on consecutive variables, sums the variable's
//                   run partials in ascending chunk order and adds the
//                   prior (reduce.cuh combine_runs).
// Traffic: each row once, the plan (2 B per edge, 8 B per run) from L2,
// and 4 B per run and component of partials, written and read: a chunk of
// the landmark-sorted edges holds the runs of a handful of cameras, so
// the partials are a small fraction of the 537 MB of rows at the Venice
// shape. Shared memory: 84,000 B per block.
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "reduce.cuh"

namespace gbp {

__global__ void reduce_seq(const float* __restrict__ planes,
                           long long stride, int comp,
                           const int* __restrict__ ptr, int n_var,
                           const float* __restrict__ prior,
                           float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)comp * n_var) return;
  const int c = (int)(t / n_var);
  const int v = (int)(t % n_var);
  const float* row = planes + c * stride;
  float acc = 0.0f;
  const int end = ptr[v + 1];
  for (int j = ptr[v]; j < end; ++j) acc = acc + row[j];
  out[t] = prior ? prior[t] + acc : acc;
}

__global__ void reduce_warp(const float* __restrict__ planes,
                            long long stride, int comp,
                            const int* __restrict__ ptr, int n_var,
                            const float* __restrict__ prior,
                            float* __restrict__ out) {
  const long long t =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (t >= (long long)comp * n_var) return;   // whole warp exits together
  const int c = (int)(t / n_var);
  const int v = (int)(t % n_var);
  const float* row = planes + c * stride;
  float acc = 0.0f;
  const int end = ptr[v + 1];
  for (int j = ptr[v] + lane; j < end; j += 32) acc = acc + row[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[t] = prior ? prior[t] + acc : acc;
}

constexpr int RC_THREADS = 512;   // threads of a pass-1 block
constexpr int RC_PER_SM = 2;      // pass-1 blocks resident on an SM

// Pass 1: one block per (chunk k, group of ``rows_per_block`` components).
// Shared memory: the barrier, the chunk's sorted offsets (``ord``), the
// slice sums, a row buffer of chunk + 4 words (``tile``) and the row's
// values in sorted order (``sorted``, padded: reduce.cuh). Per row i:
//   1. thread 0 has bulk-copied the row's 16-byte-aligned body into the
//      tile (the threads copy its ragged ends word by word: a row of a
//      plane whose stride is not a multiple of 4 words starts misaligned,
//      its word j goes to tile word j + a, a = the misalignment, so the
//      body lands aligned); the offsets came with the first row;
//   2. the threads gather sorted[pad(p)] = tile[ord[p]], consecutive
//      threads on consecutive positions, and start row i + 1's copy into
//      the tile, which overlaps steps 3 and 4 (and the other block on the
//      SM overlaps this one's gather);
//   3. each thread sums a slice of 32 sorted values (slice_sum);
//   4. each thread sums one run from its ends and the whole slices between
//      them (chunk_run_sum) and writes partial[c][run].
// Summing slices in place had each lane read positions 32 apart; a
// camera's edges recur at a fixed stride in a chunk, so all lanes hit one
// bank. The padded sorted copy keeps every step's reads on distinct banks
// or in order.
__global__ void __launch_bounds__(RC_THREADS, RC_PER_SM)
reduce_chunks(const float* __restrict__ planes, long long stride, int comp,
              int rows_per_block, const int16_t* __restrict__ order,
              const int* __restrict__ chunk_runs,
              const int* __restrict__ run_start, int n_listed, int chunk,
              int n_runs, float* __restrict__ partial) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int16_t* ord = reinterpret_cast<int16_t*>(smem + 16);
  float* full = reinterpret_cast<float*>(smem + 16 + chunk * 2);
  float* tile = full + chunk / SLICE;
  float* sorted = tile + chunk + 4;
  const int n_groups = (comp + rows_per_block - 1) / rows_per_block;
  const int k = blockIdx.x / n_groups;
  const int c0 = (blockIdx.x % n_groups) * rows_per_block;
  const int rows = min(rows_per_block, comp - c0);
  const long long e0 = (long long)k * chunk;
  const int count = (int)min((long long)chunk, n_listed - e0);
  const int ord_bulk = (count * 2) & ~15;         // bytes of offsets by bulk
  const int r0 = chunk_runs[k], r1 = chunk_runs[k + 1];
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init_fence();
  }
  __syncthreads();

  auto row_src = [&](int i) { return planes + (c0 + i) * stride + e0; };
  auto shift = [&](int i) {
    return (int)((reinterpret_cast<uintptr_t>(row_src(i)) / 4) % 4);
  };
  // start row i's copy into the tile (every thread calls this)
  auto issue = [&](int i) {
    const float* src = row_src(i);
    const int a = shift(i);
    const int head = min((4 - a) % 4, count);
    const int body = (count - head) / 4 * 4;
    float* dst = tile + a;
    if (threadIdx.x == 0) {
      const int offs = i == 0 ? ord_bulk : 0;
      fence_proxy_async();
      mbar_arrive_expect(bar, body * 4 + offs);
      if (body > 0) bulk_load(dst + head, src + head, body * 4, bar);
      if (offs > 0) bulk_load(ord, order + e0, offs, bar);
    }
    for (int j = threadIdx.x; j < head; j += blockDim.x) dst[j] = src[j];
    for (int j = head + body + threadIdx.x; j < count; j += blockDim.x)
      dst[j] = src[j];
  };

  issue(0);
  for (int j = ord_bulk / 2 + threadIdx.x; j < count; j += blockDim.x)
    ord[j] = order[e0 + j];
  for (int i = 0; i < rows; ++i) {
    mbar_wait(bar, i & 1);
    __syncthreads();                     // the ends the threads copied
    const float* t = tile + shift(i);
    for (int q = threadIdx.x; q < count; q += blockDim.x)
      sorted[pad(q)] = t[ord[q]];
    __syncthreads();                     // the tile is free again
    if (i + 1 < rows) issue(i + 1);
    for (int q = threadIdx.x; q * SLICE < count; q += blockDim.x)
      full[q] = slice_sum(sorted + pad(q * SLICE),
                          min(SLICE, count - q * SLICE));
    __syncthreads();
    float* out = partial + (long long)(c0 + i) * n_runs;
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x)
      out[r] = chunk_run_sum(sorted, full, run_start[r],
                             r + 1 < r1 ? run_start[r + 1] : count);
  }
}

__global__ void reduce_combine(const float* __restrict__ partial, int comp,
                               int n_runs, const int* __restrict__ var_ptr,
                               const int* __restrict__ var_runs, int n_var,
                               const float* __restrict__ prior,
                               float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)comp * n_var) return;
  const long long c = t / n_var;
  const int v = (int)(t % n_var);
  out[t] = combine_runs(partial + c * n_runs, var_runs, var_ptr[v],
                        var_ptr[v + 1], prior ? prior + t : nullptr);
}

}  // namespace gbp

extern "C" int gbp_reduce_launch(const float* planes, long long stride,
                                 int comp, const int* ptr, int n_var, const float* prior, float* out,
                                 int group, void* stream) {
  const long long n = (long long)comp * n_var;
  if (n <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1) {
    const long long blocks = (n + threads - 1) / threads;
    gbp::reduce_seq<<<(unsigned)blocks, threads, 0, s>>>(
        planes, stride, comp, ptr, n_var, prior, out);
  } else if (group == 32) {
    const long long blocks = (n * 32 + threads - 1) / threads;
    gbp::reduce_warp<<<(unsigned)blocks, threads, 0, s>>>(
        planes, stride, comp, ptr, n_var, prior, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

namespace gbp {
// Pass 1's dynamic shared memory per block (bytes): the barrier, the
// chunk's offsets and slice sums, the row buffer and the padded sorted
// copy.
static int chunks_smem(int chunk) {
  return 16 + chunk * 2 + chunk / SLICE * 4 + (chunk + 4) * 4
         + (chunk + chunk / SLICE) * 4;
}

// Components per pass-1 block: the split of the ``comp`` rows into groups
// that minimises (waves of blocks over the block slots) x (rows per block
// + 1, the first row's copy being the one not overlapped).
static int rows_per_block(int comp, int n_chunks, int slots) {
  int best = comp;
  long long best_cost = -1;
  for (int g = 1; g <= comp; ++g) {
    const int rpb = (comp + g - 1) / g;
    const long long blocks = (long long)n_chunks * ((comp + rpb - 1) / rpb);
    const long long cost = (blocks + slots - 1) / slots * (rpb + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rpb;
    }
  }
  return best;
}
}  // namespace gbp

extern "C" int gbp_reduce_chunks_smem(int chunk) {
  return gbp::chunks_smem(chunk);
}

extern "C" int gbp_reduce_chunks_launch(
    const float* planes, long long stride, int comp, const int16_t* order,
    const int* chunk_runs, const int* run_start, const int* var_ptr,
    const int* var_runs, int n_var, int n_listed, int chunk, int n_chunks,
    int n_runs, float* partial, const float* prior, float* out,
    void* stream) {
  if ((long long)comp * n_var <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    static int smem_set[gbp::MAX_DEVICES] = {0};
    const int smem = gbp::chunks_smem(chunk);
    int dev = 0, sms = 0;
    cudaError_t err = gbp::device_sms(&dev, &sms);
    if (err == cudaSuccess)
      err = gbp::smem_opt_in(gbp::reduce_chunks, smem, dev, smem_set);
    if (err != cudaSuccess) return (int)err;
    const int rpb = gbp::rows_per_block(comp, n_chunks, gbp::RC_PER_SM * sms);
    const int groups = (comp + rpb - 1) / rpb;
    gbp::reduce_chunks<<<(unsigned)((long long)n_chunks * groups),
                         gbp::RC_THREADS, smem, s>>>(
        planes, stride, comp, rpb, order, chunk_runs, run_start, n_listed,
        chunk, n_runs, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)comp * n_var;
  const int threads = 256;
  gbp::reduce_combine<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        s>>>(partial, comp, n_runs, var_ptr, var_runs, n_var,
                             prior, out);
  return (int)cudaGetLastError();
}
