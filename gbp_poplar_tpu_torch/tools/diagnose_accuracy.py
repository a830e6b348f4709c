"""Why a schedule stops short of the Gauss-Newton MAP point: the final
per-edge state of a GBP solve, and its comparison with the GN oracle.

    python -m gbp_poplar_tpu_torch.tools.diagnose_accuracy [SEQ|FILE] [N] [k=v ...]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.diagnose_accuracy f.txt 300

The counterpart of the JAX package's ``scripts/diagnose_accuracy.py``
(defaults ``fr1desk`` and 1,000 sweeps; ``k=v`` overrides of
``GBPConfig``, ``tools/seq_common.parse_overrides``), split into three
functions:

  - ``solve``: the GBP solve with diagnostics and its iteration trace
    (error, relinearised and robust edges at marks);
  - ``edge_stats``: pure, on a given final state: the residual at the
    belief means, the robust share, ``dmu`` (the means against the edge's
    stored means), the drift from the linearisation point, the depth in
    the camera frame, the 25 worst edges and the catastrophic edges'
    share of the mean error;
  - ``gn_compare``: the cold GN oracle (60 LM iterations), its per-edge
    residuals, the per-landmark and per-camera disagreement, the MAP cost
    split into its robust and prior parts, the anchor keyframes, and the
    basin test: 30 LM iterations polishing the GBP point.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import GBPConfig
from ..core import build_graph, gauss_newton as gn, gbp, init_state
from ..ops import planes as pl
from ..ops import projection
from ..utils import balio, evaluation
from . import device_label, resolve_device, timed
from .seq_common import MapObjective, gn_oracle, parse_overrides

TRACE_AT = (9, 25, 50, 100, 200, 300, 500, 700)
N_WORST = 25
POLISH_ITERS = 30


def solve(prob, cfg: GBPConfig, n_iters: int, device=None) -> dict:
    """The GBP solve of ``prob`` (``gbp.solve``, diagnostics on): the final
    state and graph, the per-sweep traces and the wall time."""
    dev = resolve_device(device)
    graph = build_graph(prob, cfg, dev)
    state = init_state(prob, cfg, dev)
    (state, diag), dt = timed(
        dev, lambda: gbp.solve(state, graph, cfg, n_iters=n_iters))
    return {"state": state, "graph": graph, "seconds": dt,
            "device": device_label(dev),
            "errs": diag.reproj_err.cpu().numpy(),
            "relins": diag.n_relins.cpu().numpy(),
            "robusts": diag.n_robust.cpu().numpy()}


def edge_stats(state, graph, cfg: GBPConfig, n_edges: int) -> dict:
    """The final per-edge statistics of ``state`` over its first
    ``n_edges`` (real) edges, at the unsanitised belief means. Reads the
    state and changes nothing."""
    e = n_edges
    cam_mu, lmk_mu = gbp._variable_means(state)          # [6, C], [3, L]
    cam_ids, lmk_ids = graph.cam_idx[:e].long(), graph.lmk_idx[:e].long()
    mu_c = cam_mu.index_select(1, cam_ids)
    mu_l = lmk_mu.index_select(1, lmk_ids)
    mu = torch.cat([mu_c, mu_l])                          # [9, e]
    dmu = torch.linalg.vector_norm(mu - state.mu[:, :e], dim=0)
    drift = torch.linalg.vector_norm(mu - state.lin_mu[:, :e], dim=0)
    (u, v), y_cf, _ = pl.project(pl.unpack_vec(mu_c, 6),
                                 pl.unpack_vec(mu_l, 3), graph.k)
    meas = graph.meas[:, :e]
    res = torch.hypot(meas[0] - u, meas[1] - v)

    def host(t):
        return t.cpu().numpy()

    res, dmu, drift, depth = map(host, (res, dmu, drift, y_cf[2]))
    robust = host(state.robust[:e])
    lmk_np = host(lmk_ids)
    thr = cfg.dmu_threshold
    hi = res > np.percentile(res, 95)
    lo = ~hi
    worst = np.argsort(res)[-N_WORST:][::-1]
    return {
        "n_edges": e, "res": res, "dmu": dmu, "drift": drift,
        "depth": depth, "robust": robust,
        "damping_count": host(state.damping_count[:e]),
        "cam_ids": host(cam_ids), "lmk_ids": lmk_np,
        "lmk_deg": np.bincount(lmk_np, minlength=graph.n_points),
        "cam_mu": host(cam_mu).T, "lmk_mu": host(lmk_mu).T,  # [C, 6], [L, 3]
        "res_mean": float(res.mean()), "res_median": float(np.median(res)),
        "res_p90": float(np.percentile(res, 90)),
        "res_p99": float(np.percentile(res, 99)), "res_max": float(res.max()),
        "robust_frac": float(robust.mean()),
        "dmu_median": float(np.median(dmu)),
        "dmu_p90": float(np.percentile(dmu, 90)),
        "dmu_above": float((dmu > thr).mean()),
        "drift_median": float(np.median(drift)),
        "drift_p90": float(np.percentile(drift, 90)),
        "drift_max": float(drift.max()),
        "hi_dmu_median": float(np.median(dmu[hi])),
        "hi_dmu_above": float((dmu[hi] > thr).mean()),
        "hi_drift_median": float(np.median(drift[hi])),
        "hi_robust_frac": float(robust[hi].mean()),
        "lo_dmu_median": float(np.median(dmu[lo])),
        "lo_dmu_above": float((dmu[lo] > thr).mean()),
        "lo_drift_median": float(np.median(drift[lo])),
        "depth_neg": float(np.mean(depth < 0)),
        "depth_below_min": float(np.mean(depth < cfg.min_depth)),
        "worst": worst,
        "catastrophic": {t: (int((res > t).sum()),
                             float(res[res > t].sum() / e))
                         for t in (10.0, 50.0)},
    }


def gn_compare(prob, cfg: GBPConfig, state, graph, device=None) -> dict:
    """The GBP final state against the cold GN oracle: per-edge GN
    residuals, disagreement per landmark and camera, the MAP cost split of
    both, the anchor keyframes and the LM polish of the GBP point."""
    dev = resolve_device(device)
    stats = edge_stats(state, graph, cfg, prob.n_edges)
    e = stats["n_edges"]
    res_gn, dt_gn = timed(dev, lambda: gn_oracle(prob, cfg, device=dev))
    gn_cam = res_gn.cam.cpu().numpy()
    gn_lmk = res_gn.lmk.cpu().numpy()
    cam_ids = graph.cam_idx[:e].long()
    lmk_ids = graph.lmk_idx[:e].long()
    r_gn = graph.meas[:, :e].T - projection.project(
        res_gn.cam[cam_ids], res_gn.lmk[lmk_ids], graph.k)
    res_gn_e = torch.linalg.vector_norm(r_gn, dim=-1).cpu().numpy()
    cam_mu, lmk_mu = stats["cam_mu"], stats["lmk_mu"]     # [C, 6], [L, 3]
    dl = np.linalg.norm(lmk_mu - gn_lmk, axis=1)

    obj = MapObjective(prob, cfg, dev)
    rob_gbp, pri_gbp = obj.split(cam_mu, lmk_mu)
    rob_gn, pri_gn = obj.split(gn_cam, gn_lmk)
    res_pol, dt_pol = timed(dev, lambda: gn.solve_lm(
        torch.tensor(cam_mu, device=dev), torch.tensor(lmk_mu, device=dev),
        obj.graph, obj.priors, cfg, n_lm_iters=POLISH_ITERS))
    pol_cam = res_pol.cam.cpu().numpy()
    d = np.linalg.norm(cam_mu[:, :3] - gn_cam[:, :3], axis=1)
    deg = np.bincount(stats["cam_ids"], minlength=prob.n_keyframes)
    worst_cams = []
    for c in np.argsort(d)[-5:][::-1]:
        m = stats["cam_ids"] == c
        worst_cams.append((int(c), float(d[c]), int(deg[c]),
                           float(stats["res"][m].mean()),
                           float(stats["robust"][m].mean())))
    return {
        "gn_err": float(res_gn.reproj_err[-1]),
        "gn_cost_trace": res_gn.cost.cpu().numpy(),
        "gn_accepted": int(res_gn.accepted.sum()),
        "gn_iters": len(res_gn.accepted),
        "res_gn": res_gn_e,
        "res_gn_mean": float(res_gn_e.mean()),
        "res_gn_median": float(np.median(res_gn_e)),
        "res_gn_p99": float(np.percentile(res_gn_e, 99)),
        "res_gn_max": float(res_gn_e.max()),
        "res_gn_worst": res_gn_e[stats["worst"]],
        "lmk_median": float(np.median(dl)),
        "lmk_p99": float(np.percentile(dl, 99)), "lmk_max": float(dl.max()),
        "lmk_far": int((dl > 0.1).sum()),
        "ate": evaluation.ate_rmse(cam_mu, gn_cam),
        "cost_gbp": (rob_gbp, pri_gbp), "cost_gn": (rob_gn, pri_gn),
        "ratio": (rob_gbp + pri_gbp) / (rob_gn + pri_gn),
        "anchor_dt": [float(x) for x in d[:3]],
        "polish_cost": float(res_pol.cost[-1]),
        "polish_gn_ratio": float(res_pol.cost[-1]) / (rob_gn + pri_gn),
        "polish_moved": float(np.linalg.norm(pol_cam[:, :3] - cam_mu[:, :3],
                                             axis=1).max()),
        "polish_ate": evaluation.ate_rmse(pol_cam, gn_cam),
        "cam_median": float(np.median(d)),
        "cam_p90": float(np.percentile(d, 90)),
        "cam_max": float(d.max()), "cam_argmax": int(d.argmax()),
        "worst_cams": worst_cams,
        "seconds": {"gn": dt_gn, "polish": dt_pol},
    }


def trace_lines(run: dict) -> list[str]:
    errs, relins, robusts = run["errs"], run["relins"], run["robusts"]
    n = len(errs)
    lines = ["", "iteration trace (err / relins / robust):"]
    for i in (*TRACE_AT, n - 1):
        if i < n:
            lines.append(f"  it {i:4d}: {errs[i]:8.4f} px  relins "
                         f"{relins[i]:5d}  robust {robusts[i]:5d}")
    lines += [f"  min err {np.nanmin(errs):.4f} at it "
              f"{int(np.nanargmin(errs))}",
              f"  relins over last 100 iters: mean "
              f"{relins[-100:].mean():.1f}",
              f"  solve: {n} sweeps in {run['seconds']:.1f}s "
              f"({run['device']})"]
    return lines


def stats_lines(s: dict, cfg: GBPConfig) -> list[str]:
    lines = [
        "", f"final per-edge stats over {s['n_edges']} edges:",
        f"  residual px: mean {s['res_mean']:.3f}  median "
        f"{s['res_median']:.3f}  p90 {s['res_p90']:.3f}  p99 "
        f"{s['res_p99']:.3f}  max {s['res_max']:.2f}",
        f"  robust fraction: {s['robust_frac']:.4f}",
        f"  dmu: median {s['dmu_median']:.2e}  p90 {s['dmu_p90']:.2e}  frac "
        f"above 3e-3 (never quiesce): {s['dmu_above']:.4f}",
        f"  drift from lin point: median {s['drift_median']:.2e}  p90 "
        f"{s['drift_p90']:.2e}  max {s['drift_max']:.2e}",
        "",
        f"  top-5% residual edges: dmu median {s['hi_dmu_median']:.2e}, "
        f"frac dmu>thr {s['hi_dmu_above']:.3f}, drift median "
        f"{s['hi_drift_median']:.2e}, robust frac {s['hi_robust_frac']:.3f}",
        f"  rest: dmu median {s['lo_dmu_median']:.2e}, frac dmu>thr "
        f"{s['lo_dmu_above']:.3f}, drift median {s['lo_drift_median']:.2e}",
        f"  depth at belief mean: frac < 0 {s['depth_neg']:.4f}, frac < "
        f"{cfg.min_depth}: {s['depth_below_min']:.4f}",
        "", f"  {N_WORST} worst edges (res, depth, dmu, drift, robust, dc, "
        "lmk, deg):"]
    for i in s["worst"]:
        lm = s["lmk_ids"][i]
        lines.append(
            f"    e{i:6d}: res {s['res'][i]:9.2f}  z {s['depth'][i]:8.3f}  "
            f"dmu {s['dmu'][i]:.2e}  drift {s['drift'][i]:.2e}  "
            f"rob {int(s['robust'][i])}  dc {int(s['damping_count'][i]):5d}"
            f"  lmk {lm:5d} (deg {s['lmk_deg'][lm]})")
    for t, (n, share) in s["catastrophic"].items():
        lines.append(f"  edges with res>{t}: {n} ({share:.3f} px of the "
                     "mean)")
    return lines


def compare_lines(g: dict, device: str) -> list[str]:
    (rb, pb), (rg, pg) = g["cost_gbp"], g["cost_gn"]
    sec = g["seconds"]
    lines = [
        "", f"GN per-edge residuals: mean {g['res_gn_mean']:.3f}  median "
        f"{g['res_gn_median']:.3f}  p99 {g['res_gn_p99']:.3f}  max "
        f"{g['res_gn_max']:.2f}",
        "  GN residual on GBP's 25 worst edges: "
        + " ".join(f"{x:.1f}" for x in g["res_gn_worst"]),
        f"  per-landmark |y_GBP - y_GN| (m): median {g['lmk_median']:.4f}  "
        f"p99 {g['lmk_p99']:.4f}  max {g['lmk_max']:.3f}; n>0.1m: "
        f"{g['lmk_far']}",
        "", f"GN: reproj {g['gn_err']:.4f} px; ATE(GBP,GN) {g['ate']:.5f} m",
        "", f"MAP cost: GBP {rb + pb:.2f} (robust {rb:.2f} + prior {pb:.2f})"
        f"  GN {rg + pg:.2f} (robust {rg:.2f} + prior {pg:.2f})  ratio "
        f"{g['ratio']:.4f}",
        f"  GN cost trace last 5: {g['gn_cost_trace'][-5:]}  accepted "
        f"{g['gn_accepted']}/{g['gn_iters']}",
        "  anchor kfs |t_GBP - t_GN| (m): "
        + " ".join(f"kf{i}={x:.5f}" for i, x in enumerate(g["anchor_dt"])),
        f"  LM-polish of GBP point: cost {g['polish_cost']:.2f}, moved "
        f"{g['polish_moved']:.4f} m max, ATE(polished, GN) "
        f"{g['polish_ate']:.5f} m",
        f"  per-camera |t_GBP - t_GN| (m): median {g['cam_median']:.4f}  "
        f"p90 {g['cam_p90']:.4f}  max {g['cam_max']:.4f} at kf "
        f"{g['cam_argmax']}"]
    for c, dc, deg, mres, rob in g["worst_cams"]:
        lines.append(f"    kf {c:3d}: |dt| {dc:.4f} m, degree {deg:4d}, "
                     f"mean res {mres:.3f} px, robust {rob:.3f}")
    lines.append(f"  GN {g['gn_iters']} LM iterations in {sec['gn']:.1f}s, "
                 f"polish {POLISH_ITERS} in {sec['polish']:.1f}s ({device})")
    return lines


def diagnose(seq: str, n_iters: int = 1000, overrides: dict | None = None,
             device=None) -> dict:
    """The whole script on ``seq`` (a name or a BAL path); prints its
    lines and returns ``{"problem", "run", "stats", "gn"}`` (the run
    without its state and graph)."""
    dev = resolve_device(device)
    overrides = overrides or {}
    prob = balio.load_bal(seq)
    cfg = GBPConfig(**overrides)
    print(f"{seq}: {prob.n_keyframes} kf / {prob.n_points} lmk / "
          f"{prob.n_edges} edges; cfg overrides: {overrides}", flush=True)
    run = solve(prob, cfg, n_iters, dev)
    state, graph = run.pop("state"), run.pop("graph")
    stats = edge_stats(state, graph, cfg, prob.n_edges)
    for line in trace_lines(run) + stats_lines(stats, cfg):
        print(line, flush=True)
    g = gn_compare(prob, cfg, state, graph, dev)
    for line in compare_lines(g, run["device"]):
        print(line, flush=True)
    return {"problem": prob, "run": run, "stats": stats, "gn": g}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seq = argv[0] if argv else "fr1desk"
    n_iters = int(argv[1]) if len(argv) > 1 else 1000
    diagnose(seq, n_iters, parse_overrides(argv[2:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
