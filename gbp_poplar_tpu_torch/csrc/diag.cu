// The per-sweep telemetry (H6): the five sums of diagnostics over all
// edges, from the belief tables H2 builds after the sweep.
//
// Replaces what the JAX package computes in each lax.scan body of its
// solve (gbp_poplar_tpu/core/gbp.py::diagnostics and reprojection_error,
// one XLA fusion there; no Pallas kernel): the means gathered per edge,
// the projection, the residual norm, the validity mask and five sums.
// The per-edge and per-block bodies are csrc/diag.cuh's.
//
// Bound on the H100: bytes. Per edge two ids, the measurement, activity,
// damping counter and robust flag (25 B; 12 more with per-edge intrinsics,
// 1 with a bad mask), and per variable its mean and flag from the tables
// (28 B a camera, 16 B a landmark): 8.9 us at the Ladybug shape. The
// projection's float operations take a smaller part of that at the card's
// float32 rate, but its sin, cos, divisions and square roots are many
// instructions each, so the kernel needs much of the card's instruction rate.
//
// Design: one launch over a grid that fills the card (diag.cuh's
// partition: 4 edges a thread, blocks of 256). A thread reads the ids of
// its 4 edges before any table row, so the row gathers that depend on them
// are in flight together: latency, not bandwidth, limited the two-pass
// version of this kernel, whose threads walked 8 edges one after another.
// The rotation R(w) of a camera's mean, most of the projection's sin, cos
// and divisions, is computed once per distinct camera of a warp's edges
// where they have at most 32 (WarpRotations). A block sums its threads by
// warp shuffles in a fixed order and its 8 warps in order, writes its
// partial, and takes a ticket; the block that draws the last ticket adds
// all partials in block order with the same tree, reading them from L2
// (a fold by the first warp alone, the others leaving early, ran slower).
// So the sums are the same bits from run to run whichever block finishes
// last. The ticket (atomicInc with gridDim.x - 1) wraps back to 0, ready
// for the next launch; it belongs to the launch's owner
// (ops/diag_kernel.DiagLaunch), which zeroes it once. The plain version
// (ops/diag_kernel.edge_sums_reference) solves the means, gathers and
// projects in about 400 separate PyTorch operations (415 by torch.profiler
// on an H100, 375 device launches).
#include <cuda_runtime.h>

#include "block_sums.cuh"
#include "diag.cuh"

namespace gbp {
namespace {

// diag.cuh's PerEdgeRotations shared across a warp: where the warp's
// edges (32 lanes x DIAG_EDGES_PER_THREAD) have at most 32 distinct
// cameras (about 7 at the Ladybug shape, whose edges run by landmark),
// lane j computes the j-th distinct camera's rotation once and each edge
// reads its camera's from that lane by shuffles; with more (cameras in no
// order, as at the Venice shape) every lane computes its own. ``cams`` is
// the warp's 32 ints of shared memory.
struct WarpRotations {
  int* cams;
  float r[3][3];                          // lane j's camera's rotation
  int slot[DIAG_EDGES_PER_THREAD];        // the lane holding edge k's
  bool shared;

  __device__ __forceinline__ void prepare(const DiagArgs& a,
                                          const int ci[]) {
    const unsigned lane = threadIdx.x & 31;
    int distinct = 0;
#pragma unroll
    for (int k = 0; k < DIAG_EDGES_PER_THREAD; ++k) {
      // the lanes of edge k that share its camera, the lowest leading
      const unsigned peers = __match_any_sync(FULL_WARP, ci[k]);
      const unsigned leader = __ffs(peers) - 1;
      const unsigned leaders = __ballot_sync(FULL_WARP, lane == leader);
      slot[k] = distinct + __popc(leaders & ((1u << leader) - 1));
      if (lane == leader && slot[k] < 32) cams[slot[k]] = ci[k];
      distinct += __popc(leaders);
    }
    shared = distinct <= 32;
    if (!shared) return;
    __syncwarp();
    const int cam = (int)lane < distinct ? cams[lane] : ci[0];
    so3_exp(a.cam_tbl + (long long)cam * CAM_WIDTH + CAM_MU + 3, r);
  }

  __device__ __forceinline__ void get(const DiagArgs& a, int k, int ci,
                                      float out[3][3]) const {
    if (!shared) {
      so3_exp(a.cam_tbl + (long long)ci * CAM_WIDTH + CAM_MU + 3, out);
      return;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[i][j] = __shfl_sync(FULL_WARP, r[i][j], slot[k]);
  }
};

}  // namespace

__global__ void __launch_bounds__(DIAG_THREADS)
diag_sums(const DiagArgs a, double* partial, unsigned* ticket,
          double* __restrict__ out) {
  __shared__ double warp[DIAG_WARPS][DIAG_SUMS];
  __shared__ int cams[DIAG_WARPS][32];
  __shared__ bool last;
  double acc[DIAG_SUMS];
  diag_thread_edges(a, blockIdx.x, threadIdx.x, acc,
                    WarpRotations{cams[threadIdx.x >> 5]});
  block_sums<DIAG_SUMS>(acc, warp);
  if (!last_block<DIAG_SUMS>(acc, partial, ticket, &last)) return;
  thread_partials<DIAG_SUMS>(L2Reads{partial}, gridDim.x, threadIdx.x, acc);
  block_sums<DIAG_SUMS>(acc, warp);
  if (threadIdx.x == 0) diag_finish(acc, out);
}

}  // namespace gbp

// The grid's blocks (and partials per sum) for n_edges edges.
extern "C" long long gbp_diag_blocks(long long n_edges) {
  return gbp::diag_blocks(n_edges);
}

// One launch on ``stream``: ``partial`` holds DIAG_SUMS x
// gbp_diag_blocks(n_edges) doubles, ``ticket`` one unsigned that is 0
// before the launch and is left 0 after it, ``out`` the DIAG_SUMS results
// (zeros without edges).
extern "C" int gbp_diag_launch(const gbp::DiagArgs* args, double* partial,
                               unsigned* ticket, double* out, void* stream) {
  const long long blocks = gbp::diag_blocks(args->n_edges);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gbp::diag_sums<<<(unsigned)blocks, gbp::DIAG_THREADS, 0,
                   (cudaStream_t)stream>>>(*args, partial, ticket, out);
  return (int)cudaGetLastError();
}
