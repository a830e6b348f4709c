"""Factor-graph data structures: static graph tensors + the solver state.

The PyTorch counterpart of ``gbp_poplar_tpu/core/factor_graph.py``, in the
same plane layout (edge/variable axis last):
  - per-edge vectors [d, E]; symmetric matrices packed lower-triangular
    row-major (6x6 -> [21, E], 3x3 -> [6, E]); the 6x3 cross block full
    row-major [18, E];
  - per-variable arrays mirror this with C/L as the trailing axis.

Three differences of form, none of content:
  - the twelve f32 edge-state fields are row views of ONE packed [109, E]
    tensor (``GBPState.pk``, rows in ``EDGE_PACK_FIELDS`` order), so the
    sweep kernel has one signature and updates the state in place;
  - beliefs and priors are [27, C] / [9, L] tensors (eta rows first, then
    the packed Lambda rows), with ``cam_eta`` etc. as row views;
  - the graph carries CSR offsets (and, where the edges are not already in
    variable order, a stable permutation) per variable kind for the
    deterministic segmented sum (ops/reduce_kernel.py) instead of the JAX
    package's one-hot and window indexes.

The state is mutable: a sweep updates ``pk``, ``damping_count`` and
``robust`` in place and replaces the belief tensors. ``GBPState.clone``
gives an independent copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GBPConfig
from ..ops import planes as pl
from ..utils import priors as priors_lib
from ..utils.balio import BAProblem
from ..utils.flags import SlamFlags, ba_flags

CAM_DOF = 6
LMK_DOF = 3
CAM_COMP = CAM_DOF + pl.N_SYM6      # 27: eta | packed Lambda
LMK_COMP = LMK_DOF + pl.N_SYM3      # 9

# Packed edge state: the twelve f32 fields, in this row order (the JAX
# package's core/gbp.EDGE_PACK_FIELDS). The camera messages (rows 54..80)
# and the landmark messages (rows 81..89) are each one contiguous block,
# which the reduction reads directly.
EDGE_PACK_FIELDS = (
    ("f_eta_c", 6), ("f_eta_l", 3), ("f_lam_cc", 21), ("f_lam_cl", 18),
    ("f_lam_ll", 6), ("msg_c_eta", 6), ("msg_c_lam", 21),
    ("msg_l_eta", 3), ("msg_l_lam", 6), ("damping", 1),
    ("mu", 9), ("lin_mu", 9),
)
EDGE_PACK_ROWS = sum(n for _, n in EDGE_PACK_FIELDS)          # 109
EDGE_PACK_OFFSETS = {}
_o = 0
for _name, _n in EDGE_PACK_FIELDS:
    EDGE_PACK_OFFSETS[_name] = (_o, _o + _n)
    _o += _n
del _o, _name, _n
MSG_CAM_ROWS = (EDGE_PACK_OFFSETS["msg_c_eta"][0],
                EDGE_PACK_OFFSETS["msg_c_lam"][1])            # (54, 81)
MSG_LMK_ROWS = (EDGE_PACK_OFFSETS["msg_l_eta"][0],
                EDGE_PACK_OFFSETS["msg_l_lam"][1])            # (81, 90)

# GBPState field names of the JAX package, in its order.
STATE_FIELDS = (
    "cam_eta", "cam_lam", "lmk_eta", "lmk_lam",
    "cam_prior_eta", "cam_prior_lam", "lmk_prior_eta", "lmk_prior_lam",
    "f_eta_c", "f_eta_l", "f_lam_cc", "f_lam_cl", "f_lam_ll",
    "msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam",
    "damping", "damping_count", "mu", "lin_mu", "robust", "active",
    "cam_weaken", "lmk_weaken",
)
GRAPH_FIELDS = ("cam_idx", "lmk_idx", "meas", "meas_var", "k", "intr",
                "cam_scaling", "lmk_scaling", "first_kf", "first_uv")


# The chunk plan of a permuted segmented sum (ops/reduce_kernel.py, H3's
# two-pass sum): the listed edges cut into chunks of PLAN_CHUNK edges (two
# blocks of the kernel, 84,000 B of shared memory each, share an SM), each
# chunk's edges sorted by variable into runs; pass 1 writes one partial
# sum per run, so the partials do not grow with the number of variables.
PLAN_CHUNK = 8192


@dataclasses.dataclass
class ChunkPlan:
    """The listed edges cut into chunks of ``chunk`` consecutive edge ids.
    Inside chunk k (edges k*chunk ...), ``order[k*chunk:(k+1)*chunk]``
    lists the chunk-local offsets of its edges sorted stably by variable:
    one run per variable present, its edges in ascending order. The runs
    are numbered by (chunk, variable): chunk k's are ``chunk_runs[k] ...
    chunk_runs[k+1] - 1``, run r starts at position ``run_start[r]`` of
    its chunk's slice of ``order`` and ends where the next run of the
    chunk starts (or at the chunk's end). Variable v's runs, in ascending
    chunk order, are ``var_runs[var_ptr[v]:var_ptr[v+1]]``."""

    chunk: int
    order: torch.Tensor               # [n] int16 chunk-local offsets
    chunk_runs: torch.Tensor          # [n_chunks + 1] int32
    run_start: torch.Tensor           # [R] int32
    var_ptr: torch.Tensor             # [V + 1] int32
    var_runs: torch.Tensor            # [R] int32

    @property
    def n_chunks(self) -> int:
        return self.chunk_runs.shape[0] - 1

    @property
    def n_runs(self) -> int:
        return self.run_start.shape[0]


def chunk_plan(ids: np.ndarray, n_var: int, device) -> ChunkPlan:
    """The chunk plan of edges whose variables are ``ids`` (in edge
    order)."""
    chunk = PLAN_CHUNK
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    n_chunks = -(-n // chunk)
    cid = np.arange(n, dtype=np.int64) // chunk
    key = cid * n_var + ids
    srt = np.argsort(key, kind="stable")
    order = srt % chunk
    skey = key[srt]
    first = np.ones(n, bool)
    first[1:] = skey[1:] != skey[:-1]
    starts = np.flatnonzero(first)                 # global sorted positions
    run_chunk = cid[srt[starts]]
    run_var = ids[srt[starts]]
    chunk_runs = np.searchsorted(run_chunk, np.arange(n_chunks + 1))
    var_runs = np.argsort(run_var, kind="stable")  # runs by (var, chunk)
    var_ptr = np.searchsorted(run_var[var_runs], np.arange(n_var + 1))

    def i32(x):
        return torch.tensor(np.asarray(x).astype(np.int32), device=device)

    return ChunkPlan(
        chunk=chunk,
        order=torch.tensor(order.astype(np.int16), device=device),
        chunk_runs=i32(chunk_runs), run_start=i32(starts - run_chunk * chunk),
        var_ptr=i32(var_ptr), var_runs=i32(var_runs))


@dataclasses.dataclass
class Segments:
    """CSR description of a per-variable segmented sum over edges.

    Variable v's edges are ``perm[ptr[v]:ptr[v+1]]`` (or the contiguous
    range ``ptr[v]:ptr[v+1]`` when ``perm`` is None), in ascending edge
    order, so every sum runs in one fixed order. A permuted kind also
    carries its chunk plan."""

    ptr: torch.Tensor                 # [V + 1] int32
    perm: torch.Tensor | None         # [n] int32 edge ids, or None (0..n-1)
    var: torch.Tensor                 # [n] int32 variable of each listed edge
    plan: ChunkPlan | None = None

    @property
    def n_var(self) -> int:
        return self.ptr.shape[0] - 1


def build_segments(var_idx: np.ndarray, n_var: int, n_real: int,
                   device) -> Segments:
    """Segments of the first ``n_real`` edges by their variable id. The
    sort is stable, so each segment lists its edges in ascending order;
    when the ids are already non-decreasing no permutation is stored."""
    ids = np.asarray(var_idx[:n_real]).astype(np.int64)
    counts = np.bincount(ids, minlength=n_var)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    perm = plan = None
    if not np.all(ids[1:] >= ids[:-1]):
        plan = chunk_plan(ids, n_var, device)
        perm = np.argsort(ids, kind="stable")
        ids = ids[perm]

    def i32(x):
        return torch.tensor(x.astype(np.int32), device=device)

    return Segments(ptr=i32(ptr), perm=None if perm is None else i32(perm),
                    var=i32(ids), plan=plan)


@dataclasses.dataclass
class GBPGraph:
    """Static per-problem tensors (never mutated)."""

    cam_idx: torch.Tensor       # [E] int32 — keyframe id per edge
    lmk_idx: torch.Tensor       # [E] int32 — landmark id per edge
    meas: torch.Tensor          # [2, E] — observed pixel coords
    meas_var: torch.Tensor      # [E] — base measurement variance
    k: np.ndarray               # [3, 3] f32 shared intrinsics (host numbers)
    intr: torch.Tensor | None   # [3, E] per-edge Snavely (f, k1, k2) or None
    cam_scaling: torch.Tensor   # [C] prior-annealing scaling per keyframe
    lmk_scaling: torch.Tensor   # [L]
    first_kf: torch.Tensor      # [L] int32 first observing keyframe
    first_uv: torch.Tensor      # [2, L] pixel of the first observation
    cam_seg: Segments           # camera-side segmented sum
    lmk_seg: Segments           # landmark-side segmented sum
    # segments derived once per graph by later stages (the coarse
    # corrector's group sums, core/coarse.group_segments), by key
    derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n_keyframes(self) -> int:
        return self.cam_scaling.shape[0]

    @property
    def n_points(self) -> int:
        return self.lmk_scaling.shape[0]

    @property
    def n_edges(self) -> int:
        return self.cam_idx.shape[0]


def _rows(name):
    a, b = EDGE_PACK_OFFSETS[name]
    if b - a == 1:
        return property(lambda s: s.pk[a])
    return property(lambda s: s.pk[a:b])


@dataclasses.dataclass
class GBPState:
    """Mutable solver state (see the module docstring for the layout)."""

    cam_bel: torch.Tensor       # [27, C] belief eta | packed Lambda
    lmk_bel: torch.Tensor       # [9, L]
    cam_prior: torch.Tensor     # [27, C]
    lmk_prior: torch.Tensor     # [9, L]
    pk: torch.Tensor            # [109, E] packed f32 edge state
    damping_count: torch.Tensor  # [E] int32
    robust: torch.Tensor        # [E] bool — Huber active at last relin
    active: torch.Tensor        # [E] int32 — edge participates in GBP
    cam_weaken: torch.Tensor    # [C] int32 prior-annealing flags
    lmk_weaken: torch.Tensor    # [L] int32

    cam_eta = property(lambda s: s.cam_bel[:CAM_DOF])
    cam_lam = property(lambda s: s.cam_bel[CAM_DOF:])
    lmk_eta = property(lambda s: s.lmk_bel[:LMK_DOF])
    lmk_lam = property(lambda s: s.lmk_bel[LMK_DOF:])
    cam_prior_eta = property(lambda s: s.cam_prior[:CAM_DOF])
    cam_prior_lam = property(lambda s: s.cam_prior[CAM_DOF:])
    lmk_prior_eta = property(lambda s: s.lmk_prior[:LMK_DOF])
    lmk_prior_lam = property(lambda s: s.lmk_prior[LMK_DOF:])
    f_eta_c = _rows("f_eta_c")
    f_eta_l = _rows("f_eta_l")
    f_lam_cc = _rows("f_lam_cc")
    f_lam_cl = _rows("f_lam_cl")
    f_lam_ll = _rows("f_lam_ll")
    msg_c_eta = _rows("msg_c_eta")
    msg_c_lam = _rows("msg_c_lam")
    msg_l_eta = _rows("msg_l_eta")
    msg_l_lam = _rows("msg_l_lam")
    damping = _rows("damping")
    mu = _rows("mu")
    lin_mu = _rows("lin_mu")

    def clone(self) -> "GBPState":
        return GBPState(**{f.name: getattr(self, f.name).clone()
                           for f in dataclasses.fields(self)})


def padded_n_edges(problem: BAProblem, cfg: GBPConfig) -> int:
    m = max(1, cfg.edge_pad_multiple)
    return -(-problem.n_edges // m) * m


def edge_order(problem: BAProblem) -> np.ndarray:
    """Canonical edge order: sorted by (landmark, keyframe). Every per-edge
    tensor of GBPGraph/GBPState uses it."""
    return np.lexsort((np.asarray(problem.cam_idx),
                       np.asarray(problem.lmk_idx)))


def build_graph(problem: BAProblem, cfg: GBPConfig,
                device: torch.device | str) -> GBPGraph:
    """Static graph tensors on ``device``, the edge axis padded to
    cfg.edge_pad_multiple with inert edges (ids 0, inactive in the
    matching init_state)."""
    pr = priors_lib.build_priors(problem, cfg, device)
    first_kf = np.full(problem.n_points, problem.n_keyframes, np.int32)
    np.minimum.at(first_kf, problem.lmk_idx.astype(np.int64),
                  problem.cam_idx.astype(np.int32))
    lk = np.asarray(problem.lmk_idx)
    order = edge_order(problem)
    pos = np.minimum(np.searchsorted(lk[order], np.arange(problem.n_points)),
                     problem.n_edges - 1)
    first_edge = order[pos]
    seen = np.bincount(lk, minlength=problem.n_points) > 0
    first_uv = np.where(seen[:, None],
                        np.asarray(problem.measurements)[first_edge], 0.0).T
    e_pad = padded_n_edges(problem, cfg)
    pad = e_pad - problem.n_edges
    cam_idx_o = np.asarray(problem.cam_idx)[order].astype(np.int32)
    lmk_idx_o = np.asarray(problem.lmk_idx)[order].astype(np.int32)
    meas = np.pad(np.asarray(problem.measurements)[order].T,
                  [(0, 0), (0, pad)])
    intr = None
    if getattr(problem, "intrinsics", None) is not None:
        # padding edges reuse camera 0's intrinsics: inactive, but the
        # linearisation still evaluates them and f != 0 keeps it finite
        intr = np.asarray(problem.intrinsics)[np.pad(cam_idx_o, (0, pad))].T

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=device)

    return GBPGraph(
        cam_idx=i32(np.pad(cam_idx_o, (0, pad))),
        lmk_idx=i32(np.pad(lmk_idx_o, (0, pad))),
        meas=f32(meas),
        meas_var=torch.full((e_pad,), cfg.meas_var, dtype=torch.float32,
                            device=device),
        k=np.asarray(problem.k, np.float32),
        intr=None if intr is None else f32(intr),
        cam_scaling=pr["cam_scaling"],
        lmk_scaling=pr["lmk_scaling"],
        first_kf=i32(first_kf),
        first_uv=f32(first_uv),
        cam_seg=build_segments(cam_idx_o, problem.n_keyframes,
                               problem.n_edges, device),
        lmk_seg=build_segments(lmk_idx_o, problem.n_points,
                               problem.n_edges, device),
    )


def init_state(problem: BAProblem, cfg: GBPConfig,
               device: torch.device | str,
               flags: SlamFlags | None = None) -> GBPState:
    """Initial solver state: beliefs zero (set by the first belief update),
    messages zero, damping counter at -iters_before_damping."""
    if flags is None:
        flags = ba_flags(problem, cfg.steps)
    pr = priors_lib.build_priors(problem, cfg, device)
    c, l = problem.n_keyframes, problem.n_points
    e = padded_n_edges(problem, cfg)
    active = np.pad(
        flags.active_flag.astype(np.int32)[edge_order(problem)],
        (0, e - problem.n_edges))
    f32 = dict(dtype=torch.float32, device=device)
    return GBPState(
        cam_bel=torch.zeros((CAM_COMP, c), **f32),
        lmk_bel=torch.zeros((LMK_COMP, l), **f32),
        cam_prior=torch.cat([pr["cam_prior_eta"], pr["cam_prior_lam"]]),
        lmk_prior=torch.cat([pr["lmk_prior_eta"], pr["lmk_prior_lam"]]),
        pk=torch.zeros((EDGE_PACK_ROWS, e), **f32),
        damping_count=torch.full((e,), -cfg.iters_before_damping,
                                 dtype=torch.int32, device=device),
        robust=torch.zeros((e,), dtype=torch.bool, device=device),
        active=torch.as_tensor(active, device=device),
        cam_weaken=torch.as_tensor(
            flags.cam_weaken_flag.astype(np.int32), device=device),
        lmk_weaken=torch.as_tensor(
            flags.lmk_weaken_flag.astype(np.int32), device=device),
    )


# ---------------------------------------------------------------------------
# exchange with the JAX package (NumPy arrays keyed by its field names)
# ---------------------------------------------------------------------------

def _unprefix(fields, prefix: str) -> dict:
    """Field arrays keyed by bare names, from either bare names or a JAX
    checkpoint npz's ``"<prefix>.<field>"`` keys."""
    out = {}
    for key in fields:
        head, _, tail = key.partition(".")
        if tail and head == prefix:
            out[tail] = fields[key]
        elif not tail:
            out[key] = fields[key]
    return out


def graph_from_numpy(fields, device: torch.device | str) -> GBPGraph:
    """A GBPGraph from the JAX package's GBPGraph fields as NumPy arrays
    (``{f: np.asarray(getattr(graph, f)) for f in GRAPH_FIELDS}``, or a
    JAX checkpoint npz saved with its graph; ``intr`` absent or None for
    the pinhole model). Padding edges are not marked in a graph, so the
    segments cover every edge; padding edges are inactive, carry zero
    messages and add nothing."""
    fields = _unprefix(fields, "graph")
    cam_idx = np.asarray(fields["cam_idx"], np.int32)
    lmk_idx = np.asarray(fields["lmk_idx"], np.int32)
    n_kf = np.asarray(fields["cam_scaling"]).shape[0]
    n_pts = np.asarray(fields["lmk_scaling"]).shape[0]

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    intr = fields.get("intr")
    return GBPGraph(
        cam_idx=torch.tensor(cam_idx, device=device),
        lmk_idx=torch.tensor(lmk_idx, device=device),
        meas=f32(fields["meas"]),
        meas_var=f32(fields["meas_var"]),
        k=np.asarray(fields["k"], np.float32),
        intr=None if intr is None else f32(intr),
        cam_scaling=f32(fields["cam_scaling"]),
        lmk_scaling=f32(fields["lmk_scaling"]),
        first_kf=torch.tensor(np.asarray(fields["first_kf"], np.int32),
                              device=device),
        first_uv=f32(fields["first_uv"]),
        cam_seg=build_segments(cam_idx, n_kf, len(cam_idx), device),
        lmk_seg=build_segments(lmk_idx, n_pts, len(lmk_idx), device),
    )


def state_from_numpy(fields, device: torch.device | str) -> GBPState:
    """A GBPState from the JAX package's GBPState fields as NumPy arrays
    (``{f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}``, or a
    JAX checkpoint npz, ``np.load(path)``)."""
    fields = _unprefix(fields, "state")

    def f32(*names):
        rows = [np.asarray(fields[n], np.float32) for n in names]
        rows = [r[None] if r.ndim == 1 else r for r in rows]
        return torch.tensor(np.concatenate(rows), device=device)

    def i32(name):
        return torch.tensor(np.asarray(fields[name], np.int32),
                            device=device)

    return GBPState(
        cam_bel=f32("cam_eta", "cam_lam"),
        lmk_bel=f32("lmk_eta", "lmk_lam"),
        cam_prior=f32("cam_prior_eta", "cam_prior_lam"),
        lmk_prior=f32("lmk_prior_eta", "lmk_prior_lam"),
        pk=f32(*(n for n, _ in EDGE_PACK_FIELDS)),
        damping_count=i32("damping_count"),
        robust=torch.tensor(np.asarray(fields["robust"], bool),
                            device=device),
        active=i32("active"),
        cam_weaken=i32("cam_weaken"),
        lmk_weaken=i32("lmk_weaken"),
    )


def state_to_numpy(state: GBPState) -> dict:
    """The inverse of :func:`state_from_numpy`: NumPy arrays keyed by the
    JAX package's GBPState field names."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in STATE_FIELDS}
