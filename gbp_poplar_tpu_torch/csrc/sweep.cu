// The per-edge GBP sweep, in place on the packed edge state: the fused
// sweep (H1) and the unfused sweep (H4).
//
// H1 replaces gbp_poplar_tpu/ops/sweep_kernel.py::_fused_kernel (reached
// from sweep_fused_pallas and sweep_fused_packed): per edge, the camera
// and landmark table rows by index, edge_math (csrc/edge_math.cuh) on the
// edge's column of the packed [109, E] state, the column, the damping
// counter and the robust flag written back.
//
// Bound on the H100: bytes. An edge reads and writes its 109 packed rows
// and its counter and flag, and reads 7 constant words (10 with per-edge
// intrinsics): 906 B per edge, plus the tables once (~10 MB at the
// Ladybug shape, 64 MB at Venice); 0.30 ms at the Ladybug shape and 1.36
// ms at Venice at 3.35 TB/s. Its ~1,900 float operations per edge take a
// quarter of that at the card's float32 rate. What held the per-thread
// design at 30 % of the bound was latency: 254 registers leave 8 warps on
// an SM, and each thread issued its 109 loads one at a time, spread through
// the edge math, so an SM kept only a few KB in flight.
//
// Design: persistent blocks, one per SM, of H1_WARPS warps. Each warp owns
// a ring of H1_STAGES stages in shared memory and walks over tiles of 32
// edges (one per lane): tiles w, w + W, w + 2W, ... for global warp w of W.
// A stage holds a tile's 109 packed rows and its counter, flag, activity,
// measurement, variance, camera and landmark ids (and intrinsics), as
// 1-D bulk copies (cp.async.bulk, csrc/bulk.cuh) of 128 B per row, issued
// by the warp's lanes, their bytes counted by the stage's mbarrier. While
// a warp computes one tile, its next H1_STAGES - 1 tiles are in flight
// without a register or an instruction of the warp's threads; the warps of
// an SM keep H1_WARPS * 15 KB in flight, against the ~25 KB per SM that
// Little's law asks at 3.35 TB/s and ~1 us of latency. The edge math reads
// its column from the stage (TileColumn), writes new values straight to
// global memory (coalesced per row across the warp; nothing waits on
// them), and parks the 54 new factor values in the stage instead of in
// registers until the message phase. A stage is refilled only after its
// warp has read it (__syncwarp), so each mbarrier is waited on by one warp
// for one phase at a time and its parity is the tile's round.
//
// Budget: a stage is 119 rows x 32 x 4 B + 32 B = 15,264 B; 7 warps x 2
// stages = 213,696 B (213,808 B with the barriers) of the 232,448 a block
// may have, so one block per SM; 8 warps x 2 stages (244,352 B) or 7 x 3
// (320,712 B) do not fit, and fewer warps with more stages ran slower
// (PERF.md);
// 224 threads x 255 registers = 57,120 of the SM's 65,536, so the build's
// register count (the [build] lines) does not limit the warps: shared
// memory does. Tiles that are partial (the last one) or whose rows are
// not 16-byte aligned (E not a multiple of 4: edge_pad_multiple = 1) are
// copied into the stage by each lane for its own edge, in the kernel.
//
// The arithmetic is edge_math's, operation for operation, with -fmad=false:
// H1 gives the same bits as the per-thread kernel did and as H4.
//
// H4 replaces gbp_poplar_tpu/ops/sweep_kernel.py::_kernel (reached from
// sweep_edge_math_pallas, the unfused pipeline): the same per-edge body on
// belief planes gathered per edge beforehand (csrc/gather.cu), with the
// adjacent means solved per edge (planes.cuh belief_mean) instead of read
// from tables, one thread per edge, the column read and written in place
// in global memory (EdgeColumn). Bound: bytes, the packed state plus 144 B
// of gathered planes per edge, all coalesced.
//
// The per-variable message sums are csrc/reduce.cu's.
#include <stdint.h>

#include "bulk.cuh"
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

constexpr int H1_WARPS = 7;   // warps per block, one block per SM
constexpr int H1_STAGES = 2;  // stages in each warp's ring
constexpr int H1_T = 32;      // edges per tile, one per lane

// A stage: rows of H1_T 4-byte words (the packed rows, then the per-edge
// inputs; ids and the counter as int bits), then the robust flags.
enum : int {
  S_DC = PACK_ROWS, S_ACTIVE, S_MEAS_U, S_MEAS_V, S_MEAS_VAR, S_CAM, S_LMK,
  S_INTR, S_WORDS = S_INTR + 3,
};
constexpr int S_RB = S_WORDS * H1_T * 4;          // byte offset of the flags
constexpr int STAGE_BYTES = S_RB + H1_T;
static_assert(STAGE_BYTES % 16 == 0, "stages must stay 16-byte aligned");
constexpr int H1_SMEM =
    H1_WARPS * H1_STAGES * (STAGE_BYTES + (int)sizeof(uint64_t));

struct SweepArgs {
  float* pk;
  int* dc;
  uint8_t* rb;
  const int* active;
  const float* meas;
  const float* meas_var;
  const float* intr;
  const int* cam_idx;
  const int* lmk_idx;
  const float* cam_tbl;
  const float* lmk_tbl;
  long long n;                // edges
  int n_words;                // word rows staged: S_INTR, or S_WORDS
  int bulk_ok;                // every row start 16-byte aligned
};

// global source of stage word row r
__device__ __forceinline__ const float* word_row(const SweepArgs& a, int r) {
  if (r < PACK_ROWS) return a.pk + r * a.n;
  switch (r) {
    case S_DC: return reinterpret_cast<const float*>(a.dc);
    case S_ACTIVE: return reinterpret_cast<const float*>(a.active);
    case S_MEAS_U: return a.meas;
    case S_MEAS_V: return a.meas + a.n;
    case S_MEAS_VAR: return a.meas_var;
    case S_CAM: return reinterpret_cast<const float*>(a.cam_idx);
    case S_LMK: return reinterpret_cast<const float*>(a.lmk_idx);
    default: return a.intr + (r - S_INTR) * a.n;
  }
}

// whether the tile starting at edge e0 goes by bulk copies: whole, with
// every row start 16-byte aligned
__device__ __forceinline__ bool tile_bulk(const SweepArgs& a, long long e0) {
  return a.bulk_ok && e0 + H1_T <= a.n;
}

// Arm ``bar`` for the tile and start its copies into ``stage`` (the whole
// warp calls this). A tile that cannot go by bulk copies arms the barrier
// with 0 bytes, so its phase completes at once, and its lanes copy their
// own columns in sweep_kernel.
__device__ __forceinline__ void stage_tile(const SweepArgs& a, long long tile,
                                           uint8_t* stage, uint64_t* bar,
                                           int lane) {
  const long long e0 = tile * H1_T;
  const bool bulk = tile_bulk(a, e0);
  if (lane == 0)
    mbar_arrive_expect(bar, bulk ? a.n_words * H1_T * 4 + H1_T : 0);
  if (!bulk) return;
  for (int r = lane; r <= a.n_words; r += 32) {
    if (r < a.n_words)
      bulk_load(stage + r * H1_T * 4, word_row(a, r) + e0, H1_T * 4, bar);
    else
      bulk_load(stage + S_RB, a.rb + e0, H1_T, bar);
  }
}

__global__ void __launch_bounds__(H1_WARPS * 32, 1)
sweep_kernel(const SweepParams p, const SweepArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* stages = smem + warp * H1_STAGES * STAGE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + H1_WARPS * H1_STAGES * STAGE_BYTES)
                   + warp * H1_STAGES;
  const long long n_tiles = (a.n + H1_T - 1) / H1_T;
  const long long first = (long long)blockIdx.x * H1_WARPS + warp;
  const long long step = (long long)gridDim.x * H1_WARPS;
  if (lane == 0) {
    for (int s = 0; s < H1_STAGES; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
  }
  __syncwarp();
  for (int s = 0; s < H1_STAGES; ++s)
    if (first + s * step < n_tiles)
      stage_tile(a, first + s * step, stages + s * STAGE_BYTES, &bars[s],
                 lane);
  int i = 0;
  for (long long tile = first; tile < n_tiles; tile += step, ++i) {
    const int s = i % H1_STAGES;
    uint8_t* stage = stages + s * STAGE_BYTES;
    float* w = reinterpret_cast<float*>(stage);
    const int* wi = reinterpret_cast<const int*>(stage);
    mbar_wait(&bars[s], (i / H1_STAGES) & 1);
    const long long e0 = tile * H1_T;
    const long long e = e0 + lane;
    if (e < a.n) {
      if (!tile_bulk(a, e0)) {              // this lane's own column
        for (int r = 0; r < a.n_words; ++r)
          w[r * H1_T + lane] = word_row(a, r)[e];
        stage[S_RB + lane] = a.rb[e];
      }
      float bc[CAM_WIDTH], bl[LMK_WIDTH], in[3] = {0.0f, 0.0f, 0.0f};
      load_row<CAM_WIDTH>(a.cam_tbl, wi[S_CAM * H1_T + lane], bc);
      load_row<LMK_WIDTH>(a.lmk_tbl, wi[S_LMK * H1_T + lane], bl);
      if (p.flags & F_HAS_INTR) {
#pragma unroll
        for (int k = 0; k < 3; ++k) in[k] = w[(S_INTR + k) * H1_T + lane];
      }
      const TileColumn col{w + lane, H1_T, a.pk + e, a.n};
      int count = wi[S_DC * H1_T + lane];
      uint8_t robust = stage[S_RB + lane];
      edge_math_tables(p, col, count, robust,
                       wi[S_ACTIVE * H1_T + lane] > 0, bc, bl,
                       w[S_MEAS_U * H1_T + lane], w[S_MEAS_V * H1_T + lane],
                       w[S_MEAS_VAR * H1_T + lane], in);
      a.dc[e] = count;
      a.rb[e] = robust;
    }
    // every lane is done with the stage before it is refilled
    fence_proxy_async();
    __syncwarp();
    if (tile + H1_STAGES * step < n_tiles)
      stage_tile(a, tile + H1_STAGES * step, stage, &bars[s], lane);
  }
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
  static int smem_set[gbp::MAX_DEVICES] = {0};
  int dev = 0, sms = 0;
  cudaError_t err = gbp::device_sms(&dev, &sms);
  if (err == cudaSuccess)
    err = gbp::smem_opt_in(gbp::sweep_kernel, gbp::H1_SMEM, dev, smem_set);
  if (err != cudaSuccess) return (int)err;
  gbp::SweepArgs a;
  a.pk = pk;
  a.dc = dc;
  a.rb = rb;
  a.active = active;
  a.meas = meas;
  a.meas_var = meas_var;
  a.intr = intr;
  a.cam_idx = cam_idx;
  a.lmk_idx = lmk_idx;
  a.cam_tbl = cam_tbl;
  a.lmk_tbl = lmk_tbl;
  a.n = n_edges;
  const bool has_intr = params->flags & gbp::F_HAS_INTR;
  a.n_words = has_intr ? gbp::S_WORDS : gbp::S_INTR;
  const uintptr_t bases = (uintptr_t)pk | (uintptr_t)dc | (uintptr_t)rb
                          | (uintptr_t)active | (uintptr_t)meas
                          | (uintptr_t)meas_var | (uintptr_t)cam_idx
                          | (uintptr_t)lmk_idx
                          | (has_intr ? (uintptr_t)intr : 0);
  a.bulk_ok = (bases % 16 == 0) && (n_edges % 4 == 0);
  const long long tiles = (n_edges + gbp::H1_T - 1) / gbp::H1_T;
  const long long want = (tiles + gbp::H1_WARPS - 1) / gbp::H1_WARPS;
  const int blocks = (int)(want < sms ? want : sms);
  gbp::sweep_kernel<<<blocks, gbp::H1_WARPS * 32, gbp::H1_SMEM,
                      (cudaStream_t)stream>>>(*params, a);
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

// H1's launch shape, for the build report: warps per block, stages per
// warp, dynamic shared memory per block (bytes).
extern "C" void gbp_sweep_config(int* warps, int* stages, int* smem) {
  *warps = gbp::H1_WARPS;
  *stages = gbp::H1_STAGES;
  *smem = gbp::H1_SMEM;
}
