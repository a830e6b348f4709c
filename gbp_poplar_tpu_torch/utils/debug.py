"""Debug introspection: one edge's complete factor state as host NumPy.

The counterpart of ``gbp_poplar_tpu/utils/debug.py`` (the reference's
``PrintVertex``, ba/gbp_codelets.cpp:200-213): the edge's potentials,
messages, adjacent beliefs and damping machine, with the JAX function's
keys and Python types. Only the edge's column of the packed state and its
two belief columns are copied to the host, never the whole state.
"""

from __future__ import annotations

import numpy as np

from ..ops import planes as pl


def _sym_dense(packed: np.ndarray, d: int) -> np.ndarray:
    """Packed symmetric column [n_slots] -> dense [d, d]."""
    return np.array([[packed[pl.sym_slot(i, j)] for j in range(d)]
                     for i in range(d)])


def dump_edge(state, graph, e: int) -> dict:
    """All solver quantities for edge ``e`` (graph edge order) as dense
    NumPy arrays."""
    from ..core.factor_graph import EDGE_PACK_OFFSETS

    c = int(graph.cam_idx[e])
    l = int(graph.lmk_idx[e])
    col = state.pk[:, e].cpu().numpy()

    def rows(name):
        a, b = EDGE_PACK_OFFSETS[name]
        return col[a:b]

    cam = state.cam_bel[:, c].cpu().numpy()
    lmk = state.lmk_bel[:, l].cpu().numpy()
    return {
        "edge": e,
        "cam": c,
        "lmk": l,
        "meas": graph.meas[:, e].cpu().numpy(),
        "active": int(state.active[e]),
        "damping": float(rows("damping")[0]),
        "damping_count": int(state.damping_count[e]),
        "robust": bool(state.robust[e]),
        "f_eta_c": rows("f_eta_c"),
        "f_eta_l": rows("f_eta_l"),
        "f_lam_cc": _sym_dense(rows("f_lam_cc"), 6),
        "f_lam_cl": rows("f_lam_cl").reshape(6, 3),
        "f_lam_ll": _sym_dense(rows("f_lam_ll"), 3),
        "msg_to_cam_eta": rows("msg_c_eta"),
        "msg_to_cam_lam": _sym_dense(rows("msg_c_lam"), 6),
        "msg_to_lmk_eta": rows("msg_l_eta"),
        "msg_to_lmk_lam": _sym_dense(rows("msg_l_lam"), 3),
        "lin_mu": rows("lin_mu"),
        "belief_cam_eta": cam[:6],
        "belief_cam_lam": _sym_dense(cam[6:], 6),
        "belief_lmk_eta": lmk[:3],
        "belief_lmk_lam": _sym_dense(lmk[3:], 3),
    }


def print_edge(state, graph, e: int) -> None:
    """Pretty-print ``dump_edge``."""
    info = dump_edge(state, graph, e)
    np.set_printoptions(precision=5, suppress=True)
    print(f"edge {info['edge']}: cam {info['cam']} <-> lmk {info['lmk']}  "
          f"active={info['active']} damping={info['damping']:.2f} "
          f"count={info['damping_count']} robust={info['robust']}")
    for k in ("meas", "f_eta_c", "f_eta_l", "msg_to_cam_eta",
              "msg_to_lmk_eta", "lin_mu"):
        print(f"  {k:16s} {info[k]}")
    for k in ("f_lam_cc", "f_lam_cl", "f_lam_ll", "msg_to_cam_lam",
              "msg_to_lmk_lam", "belief_cam_lam", "belief_lmk_lam"):
        print(f"  {k}:\n{np.array2string(info[k], prefix='    ')}")
