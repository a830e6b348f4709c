// The per-edge GBP sweep, in place on the packed edge state: the fused
// sweep (H1) and the unfused sweep (H4), on one tile machinery.
//
// H1 replaces gbp_poplar_tpu/ops/sweep_kernel.py::_fused_kernel (reached
// from sweep_fused_pallas and sweep_fused_packed): per edge, the camera
// and landmark table rows by index, edge_math (csrc/edge_math.cuh) on the
// edge's column of the packed [109, E] state, the column, the damping
// counter and the robust flag written back.
//
// H4 replaces gbp_poplar_tpu/ops/sweep_kernel.py::_kernel (reached from
// sweep_edge_math_pallas, the unfused pipeline): the same per-edge body on
// belief planes gathered per edge beforehand (csrc/gather.cu), with the
// adjacent means solved per edge (planes.cuh belief_mean, as the table
// build solves them per variable) instead of read from tables.
//
// Bound on the H100: bytes. An edge reads and writes its 109 packed rows
// and its counter and flag, and reads 5 constant words (8 with per-edge
// intrinsics): 898 B per edge; H1 reads two ids and the tables once more
// (~10 MB at the Ladybug shape, 64 MB at Venice), H4 144 B of gathered
// planes per edge. At 3.35 TB/s: H1 0.30 ms at the Ladybug shape and 1.36
// ms at Venice, H4 1.55 ms at Venice. Their ~1,900 (H4 ~2,200) float
// operations per edge take a quarter of that at the card's float32 rate.
// What held the one-thread-per-edge design at 30 % of the bound was
// latency: over 200 registers leave 8 warps on an SM, and each thread
// issued its 109 loads one at a time, spread through the edge math, so an
// SM kept only a few KB in flight.
//
// Design: persistent blocks, one per SM, of WARPS warps. Each warp
// owns a ring of STAGES stages in shared memory and walks over tiles of 32
// edges (one per lane): tiles w, w + W, w + 2W, ... for global warp w of W.
// A stage holds a tile's 109 packed rows, its counter, activity,
// measurement and variance, the kernel's own rows (below) and the robust
// flags, as 1-D bulk copies (cp.async.bulk, csrc/bulk.cuh) of 128 B per
// row, issued by the warp's lanes, their bytes counted by the stage's
// mbarrier. While a warp computes one tile, its next STAGES - 1 tiles are
// in flight without a register or an instruction of the warp's threads;
// the warps of an SM keep ~100 KB in flight, against the ~25 KB per SM
// that Little's law asks at 3.35 TB/s and ~1 us of latency. The edge math
// reads its column from the stage (TileColumn), writes new values straight
// to global memory (coalesced per row across the warp; nothing waits on
// them), and parks the 54 new factor values in the stage instead of in
// registers until the message phase. A stage is refilled only after its
// warp has read it (__syncwarp), so each mbarrier is waited on by one warp
// for one phase at a time and its parity is the tile's round.
//
// The kernels' own rows: H1 stages the camera and landmark ids (and the
// intrinsics) and reads the two table rows by index with 16-byte loads
// (consecutive edges share a landmark and a handful of cameras, so these
// hit in L1/L2). H4 stages the intrinsics (PlaneTiles below); each lane
// issues its 36 gathered belief values as independent loads, coalesced
// across the warp, before it waits for the stage.
//
// Budget: 232,448 B of dynamic shared memory per block, so one block per
// SM; the warps per block are as many as 2 stages each allow, and fewer
// warps with more stages ran slower (PERF.md). Registers do not limit the
// warps (at most 224 threads x 255 = 57,120 of the SM's 65,536): shared
// memory does. Tiles that are partial (the last one) or whose rows are not
// 16-byte aligned (E not a multiple of 4: edge_pad_multiple = 1) are
// copied into the stage by each lane for its own edge, in the kernel.
//
// The arithmetic is edge_math's, operation for operation, with -fmad=false:
// H1 and H4 give the same bits as each other and as the plain version.
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

constexpr int TILE = 32;      // edges per tile, one per lane
constexpr int STAGES = 2;     // stages in each warp's ring
constexpr int WARPS = 7;      // warps per block (both kernels)

// The word rows every stage starts with (TILE 4-byte words each; the
// counter as int bits): the packed rows, then the per-edge inputs both
// sweeps read. Each kernel's own rows follow; the robust flags close the
// stage.
enum : int {
  S_DC = PACK_ROWS, S_ACTIVE, S_MEAS_U, S_MEAS_V, S_MEAS_VAR, S_COMMON,
};
constexpr int MAX_ROWS = 10;  // word rows after the packed ones, at most

// The operands both sweeps share. ``rows[k]`` is the source of word row
// PACK_ROWS + k, in the kernel's stage order (set by its launcher), so a
// lane finds the source of any row without a branch.
struct EdgeArgs {
  float* pk;
  int* dc;
  uint8_t* rb;
  const void* rows[MAX_ROWS];
  long long n;                // edges
  int n_words;                // word rows staged
  int bulk_ok;                // every staged row start 16-byte aligned

  __device__ __forceinline__ const float* word_row(int r) const {
    return r < PACK_ROWS ? pk + r * n
                         : static_cast<const float*>(rows[r - PACK_ROWS]);
  }
};

// H1's tiles: the ids and the intrinsics staged (the intrinsics rows only
// where the problem has them), the table rows read by index.
struct TableTiles : EdgeArgs {
  enum : int { S_CAM = S_COMMON, S_LMK, S_INTR, WORDS = S_INTR + 3 };
  static constexpr int RB = WORDS * TILE * 4;     // offset of the flags
  static constexpr int STAGE_BYTES = RB + TILE;
  const float* cam_tbl;
  const float* lmk_tbl;
  struct Early {};

  __device__ __forceinline__ void early(long long, Early&) const {}
  __device__ __forceinline__ void edge(const SweepParams& p,
                                       const TileColumn& col,
                                       const float* w, const Early&,
                                       int& count, uint8_t& robust,
                                       bool act, float mu, float mv,
                                       float mvar) const {
    const int* wi = reinterpret_cast<const int*>(w);
    float bc[CAM_WIDTH], bl[LMK_WIDTH], in[3] = {0.0f, 0.0f, 0.0f};
    load_row<CAM_WIDTH>(cam_tbl, wi[S_CAM * TILE], bc);
    load_row<LMK_WIDTH>(lmk_tbl, wi[S_LMK * TILE], bl);
    if (p.flags & F_HAS_INTR) {
#pragma unroll
      for (int k = 0; k < 3; ++k) in[k] = w[(S_INTR + k) * TILE];
    }
    edge_math_tables(p, col, count, robust, act, bc, bl, mu, mv, mvar, in);
  }
};

// H4's tiles: the intrinsics staged; the 36 gathered belief values loaded
// by each lane before it waits for the stage (coalesced across the warp).
// Staging them too would leave room for 6 warps, not 7, and ran slower
// (PERF.md).
struct PlaneTiles : EdgeArgs {
  enum : int { S_INTR = S_COMMON, WORDS = S_INTR + 3 };
  static constexpr int RB = WORDS * TILE * 4;
  static constexpr int STAGE_BYTES = RB + TILE;
  const float* bc;
  const float* bl;
  struct Early {
    float bc[CAM_COMP], bl[LMK_COMP];
  };

  __device__ __forceinline__ void early(long long e, Early& x) const {
#pragma unroll
    for (int i = 0; i < CAM_COMP; ++i) x.bc[i] = bc[i * n + e];
#pragma unroll
    for (int i = 0; i < LMK_COMP; ++i) x.bl[i] = bl[i * n + e];
  }
  __device__ __forceinline__ void edge(const SweepParams& p,
                                       const TileColumn& col,
                                       const float* w, const Early& x,
                                       int& count, uint8_t& robust,
                                       bool act, float mu, float mv,
                                       float mvar) const {
    float in[3] = {0.0f, 0.0f, 0.0f};
    if (p.flags & F_HAS_INTR) {
#pragma unroll
      for (int k = 0; k < 3; ++k) in[k] = w[(S_INTR + k) * TILE];
    }
    edge_math_gathered(p, col, count, robust, act, x.bc, x.bl, mu, mv, mvar,
                       in);
  }
};

template <class Tiles>
constexpr int tiles_smem() {
  return WARPS * STAGES * (Tiles::STAGE_BYTES + (int)sizeof(uint64_t));
}

// whether the tile starting at edge e0 goes by bulk copies: whole, with
// every row start 16-byte aligned
template <class Tiles>
__device__ __forceinline__ bool tile_bulk(const Tiles& a, long long e0) {
  return a.bulk_ok && e0 + TILE <= a.n;
}

// Arm ``bar`` for the tile and start its copies into ``stage`` (the whole
// warp calls this). A tile that cannot go by bulk copies arms the barrier
// with 0 bytes, so its phase completes at once, and its lanes copy their
// own columns in walk_tiles.
template <class Tiles>
__device__ __forceinline__ void stage_tile(const Tiles& a, long long tile,
                                           uint8_t* stage, uint64_t* bar,
                                           int lane) {
  const long long e0 = tile * TILE;
  const bool bulk = tile_bulk(a, e0);
  if (lane == 0)
    mbar_arrive_expect(bar, bulk ? a.n_words * TILE * 4 + TILE : 0);
  if (!bulk) return;
  for (int r = lane; r <= a.n_words; r += 32) {
    if (r < a.n_words)
      bulk_load(stage + r * TILE * 4, a.word_row(r) + e0, TILE * 4, bar);
    else
      bulk_load(stage + Tiles::RB, a.rb + e0, TILE, bar);
  }
}

// The body of both sweep kernels: each warp walks its tiles through its
// ring of stages and runs the kernel's per-edge body on each lane's edge.
template <class Tiles>
__device__ __forceinline__ void walk_tiles(const SweepParams& p,
                                           const Tiles& a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int SB = Tiles::STAGE_BYTES;
  static_assert(SB % 16 == 0, "stages must stay 16-byte aligned");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* stages = smem + warp * STAGES * SB;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + WARPS * STAGES * SB)
      + warp * STAGES;
  const long long n_tiles = (a.n + TILE - 1) / TILE;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  const long long step = (long long)gridDim.x * WARPS;
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
  }
  __syncwarp();
  for (int s = 0; s < STAGES; ++s)
    if (first + s * step < n_tiles)
      stage_tile(a, first + s * step, stages + s * SB, &bars[s], lane);
  int i = 0;
  for (long long tile = first; tile < n_tiles; tile += step, ++i) {
    const int s = i % STAGES;
    uint8_t* stage = stages + s * SB;
    float* w = reinterpret_cast<float*>(stage);
    const int* wi = reinterpret_cast<const int*>(stage);
    const long long e0 = tile * TILE;
    const long long e = e0 + lane;
    typename Tiles::Early early;
    if (e < a.n) a.early(e, early);
    mbar_wait(&bars[s], (i / STAGES) & 1);
    if (e < a.n) {
      if (!tile_bulk(a, e0)) {              // this lane's own column
        for (int r = 0; r < a.n_words; ++r)
          w[r * TILE + lane] = a.word_row(r)[e];
        stage[Tiles::RB + lane] = a.rb[e];
      }
      const TileColumn col{w + lane, TILE, a.pk + e, a.n};
      int count = wi[S_DC * TILE + lane];
      uint8_t robust = stage[Tiles::RB + lane];
      a.edge(p, col, w + lane, early, count, robust,
             wi[S_ACTIVE * TILE + lane] > 0, w[S_MEAS_U * TILE + lane],
             w[S_MEAS_V * TILE + lane], w[S_MEAS_VAR * TILE + lane]);
      a.dc[e] = count;
      a.rb[e] = robust;
    }
    // every lane is done with the stage before it is refilled
    fence_proxy_async();
    __syncwarp();
    if (tile + STAGES * step < n_tiles)
      stage_tile(a, tile + STAGES * step, stage, &bars[s], lane);
  }
}

__global__ void __launch_bounds__(WARPS * 32, 1)
sweep_kernel(const SweepParams p, const TableTiles a) {
  walk_tiles(p, a);
}

__global__ void __launch_bounds__(WARPS * 32, 1)
sweep_planes_kernel(const SweepParams p, const PlaneTiles a) {
  walk_tiles(p, a);
}

// The operands both sweeps share, and the sources of the word rows after
// the packed ones (``n_rows`` of ``rows``, in the kernel's stage order).
inline void set_edge_args(EdgeArgs& a, float* pk, int* dc, uint8_t* rb,
                          int n_edges, const void* const* rows, int n_rows) {
  a.pk = pk;
  a.dc = dc;
  a.rb = rb;
  a.n = n_edges;
  a.n_words = PACK_ROWS + n_rows;
  a.bulk_ok = aligned16(pk) && aligned16(rb) && n_edges % 4 == 0;
  for (int k = 0; k < MAX_ROWS; ++k) {
    a.rows[k] = k < n_rows ? rows[k] : nullptr;
    a.bulk_ok = a.bulk_ok && (k >= n_rows || aligned16(rows[k]));
  }
}

// One block per SM (fewer when there are fewer tiles than warps), each
// with the kernel's dynamic shared memory.
template <class Tiles>
int launch_tiles(void (*kernel)(const SweepParams, const Tiles),
                 const SweepParams* params, const Tiles& a, int* smem_set,
                 void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err == cudaSuccess)
    err = smem_opt_in(kernel, tiles_smem<Tiles>(), dev, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (a.n + TILE - 1) / TILE;
  const long long want = (tiles + WARPS - 1) / WARPS;
  const int blocks = (int)(want < sms ? want : sms);
  kernel<<<blocks, WARPS * 32, tiles_smem<Tiles>(),
           (cudaStream_t)stream>>>(*params, a);
  return (int)cudaGetLastError();
}

}  // namespace gbp

extern "C" int gbp_sweep_launch(const gbp::SweepParams* params, float* pk,
                                int* dc, uint8_t* rb, const int* active,
                                const float* meas, const float* meas_var,
                                const float* intr, const int* cam_idx,
                                const int* lmk_idx, const float* cam_tbl,
                                const float* lmk_tbl, int n_edges,
                                void* stream) {
  using gbp::TableTiles;
  static_assert(TableTiles::WORDS - gbp::PACK_ROWS <= gbp::MAX_ROWS, "rows");
  if (n_edges <= 0) return 0;
  static int smem_set[gbp::MAX_DEVICES] = {0};
  const bool has_intr = params->flags & gbp::F_HAS_INTR;
  const void* rows[] = {dc, active, meas, meas + n_edges, meas_var, cam_idx,
                        lmk_idx, intr,
                        has_intr ? intr + n_edges : nullptr,
                        has_intr ? intr + 2 * n_edges : nullptr};
  TableTiles a;
  gbp::set_edge_args(a, pk, dc, rb, n_edges, rows,
                     (has_intr ? TableTiles::WORDS : TableTiles::S_INTR)
                         - gbp::PACK_ROWS);
  a.cam_tbl = cam_tbl;
  a.lmk_tbl = lmk_tbl;
  return gbp::launch_tiles(gbp::sweep_kernel, params, a, smem_set, stream);
}

extern "C" int gbp_sweep_planes_launch(const gbp::SweepParams* params,
                                       float* pk, int* dc, uint8_t* rb,
                                       const int* active, const float* meas,
                                       const float* meas_var,
                                       const float* intr, const float* bc,
                                       const float* bl, int n_edges,
                                       void* stream) {
  using gbp::PlaneTiles;
  static_assert(PlaneTiles::WORDS - gbp::PACK_ROWS <= gbp::MAX_ROWS, "rows");
  if (n_edges <= 0) return 0;
  static int smem_set[gbp::MAX_DEVICES] = {0};
  const bool has_intr = params->flags & gbp::F_HAS_INTR;
  const void* rows[] = {dc, active, meas, meas + n_edges, meas_var, intr,
                        has_intr ? intr + n_edges : nullptr,
                        has_intr ? intr + 2 * n_edges : nullptr};
  PlaneTiles a;
  gbp::set_edge_args(a, pk, dc, rb, n_edges, rows,
                     (has_intr ? PlaneTiles::WORDS : PlaneTiles::S_INTR)
                         - gbp::PACK_ROWS);
  a.bc = bc;
  a.bl = bl;
  return gbp::launch_tiles(gbp::sweep_planes_kernel, params, a, smem_set,
                           stream);
}

// H1's and H4's launch shapes, for the build report: warps per block,
// stages per warp, and each kernel's dynamic shared memory per block
// (bytes; their stages differ only in their own rows).
extern "C" void gbp_sweep_config(int* warps, int* stages, int* smem_h1,
                                 int* smem_h4) {
  *warps = gbp::WARPS;
  *stages = gbp::STAGES;
  *smem_h1 = gbp::tiles_smem<gbp::TableTiles>();
  *smem_h4 = gbp::tiles_smem<gbp::PlaneTiles>();
}
