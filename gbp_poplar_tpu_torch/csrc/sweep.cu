// The per-edge GBP sweep, in place on the packed edge state: the fused
// sweep (H1) and the unfused sweep (H4).
//
// H1 replaces gbp_poplar_tpu/ops/sweep_kernel.py::_fused_kernel (reached
// from sweep_fused_pallas and sweep_fused_packed). One thread per edge:
// load the edge's camera and landmark table rows by index (16-byte vector
// loads), run edge_math (csrc/edge_math.cuh) against the edge's column of
// the packed [109, E] state, and write the column, the damping counter and
// the robust flag back. Bound: bytes, about 1 KB per edge per sweep; the
// plane layout keeps every packed-row access coalesced across a warp.
//
// H4 replaces gbp_poplar_tpu/ops/sweep_kernel.py::_kernel (reached from
// sweep_edge_math_pallas, the unfused pipeline): the same per-edge body on
// belief planes gathered per edge beforehand (csrc/gather.cu), with the
// adjacent means solved per edge (planes.cuh belief_mean) instead of read
// from tables. Bound: bytes, the packed state plus 144 B of gathered
// planes per edge, all coalesced.
//
// The per-variable message sums are csrc/reduce.cu's.
#include <stdint.h>

#include "edge_math.cuh"

namespace gbp {

template <int W>
__device__ __forceinline__ void load_row(const float* tbl, int row,
                                         float out[W]) {
  const float4* src = reinterpret_cast<const float4*>(tbl + (size_t)row * W);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 v = __ldg(src + q);
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_intr(const SweepParams& p,
                                          const float* intr, int e,
                                          int n_edges, float in[3]) {
  in[0] = in[1] = in[2] = 0.0f;
  if (p.flags & F_HAS_INTR) {
    in[0] = intr[e];
    in[1] = intr[n_edges + e];
    in[2] = intr[2 * n_edges + e];
  }
}

__global__ void __launch_bounds__(128)
sweep_kernel(const SweepParams p, float* __restrict__ pk,
             int* __restrict__ dc, uint8_t* __restrict__ rb,
             const int* __restrict__ active,
             const float* __restrict__ meas,
             const float* __restrict__ meas_var,
             const float* __restrict__ intr,
             const int* __restrict__ cam_idx,
             const int* __restrict__ lmk_idx,
             const float* __restrict__ cam_tbl,
             const float* __restrict__ lmk_tbl, int n_edges) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  float bc[CAM_WIDTH], bl[LMK_WIDTH], in[3];
  load_row<CAM_WIDTH>(cam_tbl, cam_idx[e], bc);
  load_row<LMK_WIDTH>(lmk_tbl, lmk_idx[e], bl);
  load_intr(p, intr, e, n_edges, in);
  const EdgeColumn col{pk + e, (long long)n_edges};
  int count = dc[e];
  uint8_t robust = rb[e];
  edge_math_tables(p, col, count, robust, active[e] > 0, bc, bl, meas[e],
                   meas[n_edges + e], meas_var[e], in);
  dc[e] = count;
  rb[e] = robust;
}

__global__ void __launch_bounds__(128)
sweep_planes_kernel(const SweepParams p, float* __restrict__ pk,
                    int* __restrict__ dc, uint8_t* __restrict__ rb,
                    const int* __restrict__ active,
                    const float* __restrict__ meas,
                    const float* __restrict__ meas_var,
                    const float* __restrict__ intr,
                    const float* __restrict__ bc,
                    const float* __restrict__ bl, int n_edges) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  float in[3];
  load_intr(p, intr, e, n_edges, in);
  const EdgeColumn col{pk + e, (long long)n_edges};
  int count = dc[e];
  uint8_t robust = rb[e];
  edge_math_gathered(p, col, count, robust, active[e] > 0, bc + e, bl + e,
                     (long long)n_edges, meas[e], meas[n_edges + e],
                     meas_var[e], in);
  dc[e] = count;
  rb[e] = robust;
}

}  // namespace gbp

extern "C" int gbp_sweep_launch(const gbp::SweepParams* params, float* pk,
                                int* dc, uint8_t* rb, const int* active,
                                const float* meas, const float* meas_var,
                                const float* intr, const int* cam_idx,
                                const int* lmk_idx, const float* cam_tbl,
                                const float* lmk_tbl, int n_edges,
                                void* stream) {
  if (n_edges <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_edges + threads - 1) / threads;
  gbp::sweep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *params, pk, dc, rb, active, meas, meas_var, intr, cam_idx, lmk_idx,
      cam_tbl, lmk_tbl, n_edges);
  return (int)cudaGetLastError();
}

extern "C" int gbp_sweep_planes_launch(const gbp::SweepParams* params,
                                       float* pk, int* dc, uint8_t* rb,
                                       const int* active, const float* meas,
                                       const float* meas_var,
                                       const float* intr, const float* bc,
                                       const float* bl, int n_edges,
                                       void* stream) {
  if (n_edges <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_edges + threads - 1) / threads;
  gbp::sweep_planes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *params, pk, dc, rb, active, meas, meas_var, intr, bc, bl, n_edges);
  return (int)cudaGetLastError();
}
