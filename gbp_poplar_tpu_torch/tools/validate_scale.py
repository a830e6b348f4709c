"""MAP accuracy at scale: the GBP solve against the Levenberg-Marquardt
oracle, at the Ladybug shape (1,092,000 edges) or, with ``--venice``, the
Venice shape (4,970,000 edges).

    python -m gbp_poplar_tpu_torch.tools.validate_scale [n_iters] [--venice]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.validate_scale 50

The counterpart of the JAX package's ``scripts/validate_scale.py``, step
for step, on ``synthetic_problem_large`` with no extra perturbation and
``GBPConfig()`` (default schedule and accelerator):

  1. the GBP solve (``gbp.solve``, ``n_iters`` sweeps, default 500): the
     error after the first and the last sweep;
  2. the MAP cost of the GBP means on the ba driver's polish graph
     (``drivers.ba._polish_problem``: the exact edges, the annealed
     priors);
  3. the warm polish, 15 LM iterations from the GBP means (the ba
     driver's ``--polish``);
  4. the cold LM from the problem's means, 4 x 10 iterations with the
     damping carried;
  5. the cost ratios GBP/GN and polished/GN, ATE(GBP, GN) and
     ATE(polished, GN) (``utils.evaluation.ate_rmse``), wall time per
     stage.

Besides, the LM preconditioner's census along the polish: at each of its
iterations, the 6x6 blocks of S's block diagonal whose inverse is not
finite, by the LM's ``inv6x6_cholesky_ex`` and by the unrolled
``inv6x6``, each on the run's device and on a CPU copy of the same
blocks.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import GBPConfig
from ..core import build_graph, gauss_newton as gn, gbp, init_state
from ..ops import linalg
from ..utils import analysis, balio, evaluation
from . import device_label, resolve_device, synchronize

LADYBUG_SHAPE = (1723, 156000, 7)     # keyframes, landmarks, obs/landmark
VENICE_SHAPE = (1778, 994000, 5)
POLISH_ITERS = 15
COLD_ROUNDS, COLD_ITERS = 4, 10


def _timed(dev, fn):
    """(fn(), seconds on the host clock, the device synchronised)."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def _nonfinite_blocks(inv: torch.Tensor) -> int:
    return int((~torch.isfinite(inv).flatten(-2).all(-1)).sum())


def precond_census(cam: torch.Tensor, lmk: torch.Tensor, graph, pri, cfg,
                   n_iters: int, lambda0: float = 1e-4) -> dict:
    """The polish run one LM iteration at a time from (cam [C, 6], lmk
    [L, 3]); before each, S's block diagonal at the iteration's means and
    damping, inverted four ways. Returns per-iteration lists of the
    non-finite block counts (``cholesky_ex_device``, ``cholesky_ex_cpu``,
    ``unrolled_device``, ``unrolled_cpu``) and the accept decisions, and
    the block count."""
    out = {k: [] for k in ("cholesky_ex_device", "cholesky_ex_cpu",
                           "unrolled_device", "unrolled_cpu", "accepted")}
    lam = lambda0
    for _ in range(n_iters):
        s = gn.schur_block_diagonal(cam, lmk, graph, pri, cfg, lam)
        s_cpu = s.cpu()
        out["cholesky_ex_device"].append(
            _nonfinite_blocks(linalg.inv6x6_cholesky_ex(s)))
        out["cholesky_ex_cpu"].append(
            _nonfinite_blocks(linalg.inv6x6_cholesky_ex(s_cpu)))
        out["unrolled_device"].append(_nonfinite_blocks(linalg.inv6x6(s)))
        out["unrolled_cpu"].append(_nonfinite_blocks(linalg.inv6x6(s_cpu)))
        res = gn.solve_lm(cam, lmk, graph, pri, cfg, n_lm_iters=1,
                          lambda0=lam)
        cam, lmk, lam = res.cam, res.lmk, float(res.lm_lambda)
        out["accepted"].append(bool(res.accepted[0]))
    out["blocks"] = int(cam.shape[0])
    return out


def compare_to_gn(problem, cam_mu: np.ndarray, lmk_mu: np.ndarray,
                  device=None, census: bool = True) -> dict:
    """Steps 2-5 for GBP means (cam_mu [C, 6], lmk_mu [L, 3], NumPy) of
    ``problem``; the polish census unless ``census`` is False."""
    from ..drivers.ba import _polish_problem

    dev = resolve_device(device)
    cfg = GBPConfig()
    graph1, pri = _polish_problem(problem, cfg, dev)
    cam = torch.tensor(cam_mu, dtype=torch.float32, device=dev)
    lmk = torch.tensor(lmk_mu, dtype=torch.float32, device=dev)
    gbp_cost = float(gn.map_cost(cam, lmk, graph1, pri, cfg))
    res_p, t_p = _timed(dev, lambda: gn.solve_lm(
        cam, lmk, graph1, pri, cfg, n_lm_iters=POLISH_ITERS))
    out = {"gbp_cost": gbp_cost,
           "polish_err": float(res_p.reproj_err[-1]),
           "polish_cost": float(res_p.cost[-1]),
           "polish_accepted": res_p.accepted.tolist()}

    def cold():
        c, l, lam = pri.cam_mu, pri.lmk_mu, 1e-4
        for _ in range(COLD_ROUNDS):
            r = gn.solve_lm(c, l, graph1, pri, cfg, n_lm_iters=COLD_ITERS,
                            lambda0=lam)
            c, l, lam = r.cam, r.lmk, float(r.lm_lambda)
        return r

    res_g, t_g = _timed(dev, cold)
    gn_cost = float(res_g.cost[-1])
    gn_cam = res_g.cam.cpu().numpy()
    out.update(
        gn_iters=COLD_ROUNDS * COLD_ITERS,
        gn_err=float(res_g.reproj_err[-1]), gn_cost=gn_cost,
        ratio_gbp=gbp_cost / gn_cost,
        ratio_polish=out["polish_cost"] / gn_cost,
        ate_gbp=evaluation.ate_rmse(cam_mu, gn_cam),
        ate_polish=evaluation.ate_rmse(res_p.cam.cpu().numpy(), gn_cam),
        seconds={"polish": t_p, "gn": t_g})
    if census:
        cen, t_c = _timed(dev, lambda: precond_census(
            cam, lmk, graph1, pri, cfg, POLISH_ITERS))
        cen["same_decisions_as_polish"] = (cen["accepted"]
                                           == out["polish_accepted"])
        out["census"] = cen
        out["seconds"]["census"] = t_c
    return out


def validate(problem, n_iters: int = 500, device=None,
             census: bool = True) -> dict:
    """The whole protocol (steps 1-5) on ``problem``; the numbers as a
    dict (``main`` prints them)."""
    dev = resolve_device(device)
    cfg = GBPConfig()
    graph = build_graph(problem, cfg, dev)
    state = init_state(problem, cfg, dev)
    (state, diag), t_gbp = _timed(
        dev, lambda: gbp.solve(state, graph, cfg, n_iters=n_iters))
    errs = diag.reproj_err.cpu().numpy()
    cam_mu, lmk_mu = analysis.belief_means(state)
    n_edges = problem.n_edges
    del state, graph, diag
    out = {"device": device_label(dev), "edges": n_edges,
           "n_iters": n_iters, "gbp_err_first": float(errs[0]),
           "gbp_err": float(errs[-1])}
    out.update(compare_to_gn(problem, cam_mu, lmk_mu, dev, census))
    out["seconds"]["gbp"] = t_gbp
    return out


def report(r: dict) -> list[str]:
    """The result's lines, as the JAX script prints them."""
    s = r["seconds"]
    lines = []
    if "gbp_err_first" in r:
        lines.append(f"GBP: {r['edges']} edges, {r['n_iters']} iters in "
                     f"{s['gbp']:.1f}s, err {r['gbp_err_first']:.3f} -> "
                     f"{r['gbp_err']:.4f} px")
    lines += [
        f"GBP MAP cost: {r['gbp_cost']:.2f}",
        f"polish: {POLISH_ITERS} LM iters in {s['polish']:.1f}s, reproj "
        f"{r['polish_err']:.4f} px, cost {r['polish_cost']:.2f}",
        f"GN cold: {r['gn_iters']} LM iters in {s['gn']:.1f}s, reproj "
        f"{r['gn_err']:.4f} px, cost {r['gn_cost']:.2f}",
        f"cost ratio GBP/GN {r['ratio_gbp']:.6f}, polished/GN "
        f"{r['ratio_polish']:.6f}",
        f"ATE(GBP, GN) {r['ate_gbp']:.6f} m   ATE(polished, GN) "
        f"{r['ate_polish']:.6f} m"]
    if "census" in r:
        c = r["census"]
        lines.append(
            f"preconditioner census over {len(c['accepted'])} polish "
            f"iterations, {c['blocks']} blocks each: non-finite inverses "
            f"cholesky_ex device {c['cholesky_ex_device']} cpu "
            f"{c['cholesky_ex_cpu']}, unrolled device {c['unrolled_device']}"
            f" cpu {c['unrolled_cpu']}; decisions as the polish's: "
            f"{c['same_decisions_as_polish']}")
    if "device" in r:
        lines.append(f"device: {r['device']}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    n_iters = int(args[0]) if args else 500
    shape = VENICE_SHAPE if "--venice" in argv else LADYBUG_SHAPE
    r = validate(balio.synthetic_problem_large(*shape), n_iters)
    for line in report(r):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
