// Per-variable belief tables (H2), both kinds in one launch:
// [eta | packed Lambda | mean | valid | 0] per camera (36 floats) and per
// landmark (16 floats), row-major [V, width] so the fused sweep (H1) reads
// a variable's row with aligned 16-byte loads.
//
// Replaces gbp_poplar_tpu/ops/table_kernel.py::_kernel (build_lmk_table)
// and the camera-side XLA glue of core/gbp.py::_make_tables. The row of
// one variable is csrc/table.cuh's table_row.
//
// Bound on the H100: bytes (read 27 or 9 floats, write 36 or 16 per
// variable): 4.8 us at the Ladybug shape, 30 us at Venice, for both kinds.
// The camera side is tiny (a few thousand variables) but each of its
// threads runs a serial 6x6 Cholesky and two triangular solves with IEEE
// divides and square roots; the landmark side is the bytes.
//
// Design: one launch for both kinds (one host call and one launch per
// build instead of two). Blocks of 128 variables; the camera blocks come
// first in the grid, so their serial chains start at once and run beside
// the landmark blocks. A block stages its rows in shared memory (row
// stride padded so that the 16-byte stores of a phase of 8 lanes fall in
// distinct banks) and writes them out as consecutive 16-byte vectors
// across its threads: the block's part of the table is one contiguous
// range, written coalesced. Each thread writing its own row instead took
// 25 % longer at the Venice shape (PERF.md).
#include "table.cuh"

namespace gbp {

constexpr int TABLE_THREADS = 128;   // variables per block

// Row stride of a block's staged rows, in floats: the width, or the width
// + 4 where width / 4 is even, so that lane t's row starts 16 * odd * t
// bytes from lane 0's and 8 lanes' 16-byte stores hit 8 distinct bank
// quads.
__host__ __device__ constexpr int staged_stride(int w) {
  return (w / 4) % 2 ? w : w + 4;
}

template <int D, int W>
__device__ __forceinline__ void table_block(const float* __restrict__ bel,
                                            int n_var,
                                            float* __restrict__ tbl,
                                            int block, float* staged) {
  constexpr int S = staged_stride(W);
  const int v0 = block * TABLE_THREADS;
  const int v = v0 + threadIdx.x;
  if (v < n_var) {
    float row[W];
    table_row<D, W>(bel, n_var, v, row);
    float4* dst = reinterpret_cast<float4*>(staged + threadIdx.x * S);
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      dst[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                           row[4 * q + 3]);
  }
  __syncthreads();
  const int rows = min(TABLE_THREADS, n_var - v0);
  float4* out = reinterpret_cast<float4*>(tbl + (size_t)v0 * W);
  for (int f = threadIdx.x; f < rows * (W / 4); f += TABLE_THREADS) {
    const int r = f / (W / 4), q = f % (W / 4);
    out[f] = *reinterpret_cast<const float4*>(staged + r * S + 4 * q);
  }
}

__global__ void __launch_bounds__(TABLE_THREADS)
table_kernel(const float* __restrict__ cam_bel, int n_cam,
             float* __restrict__ cam_tbl, const float* __restrict__ lmk_bel,
             int n_lmk, float* __restrict__ lmk_tbl, int cam_blocks) {
  __shared__ __align__(16) float staged[TABLE_THREADS
                                        * staged_stride(CAM_WIDTH)];
  static_assert(staged_stride(LMK_WIDTH) <= staged_stride(CAM_WIDTH),
                "the landmark rows fit the camera rows' buffer");
  if ((int)blockIdx.x < cam_blocks)
    table_block<6, CAM_WIDTH>(cam_bel, n_cam, cam_tbl, blockIdx.x, staged);
  else
    table_block<3, LMK_WIDTH>(lmk_bel, n_lmk, lmk_tbl,
                              blockIdx.x - cam_blocks, staged);
}

}  // namespace gbp

// Both tables in one launch; a kind with no variables (n = 0) gets no
// blocks.
extern "C" int gbp_tables_launch(const float* cam_bel, int n_cam,
                                 float* cam_tbl, const float* lmk_bel,
                                 int n_lmk, float* lmk_tbl, void* stream) {
  const int t = gbp::TABLE_THREADS;
  const int cam_blocks = (n_cam + t - 1) / t;
  const int blocks = cam_blocks + (n_lmk + t - 1) / t;
  if (blocks == 0) return 0;
  gbp::table_kernel<<<blocks, t, 0, (cudaStream_t)stream>>>(
      cam_bel, n_cam, cam_tbl, lmk_bel, n_lmk, lmk_tbl, cam_blocks);
  return (int)cudaGetLastError();
}
