"""The numbers that decide ``correct``: the program's outputs against the
plain reference's. Each number's limit is in ``portbench/limits/<cell>.json``,
set from the readings of sound runs and of the control (PERF.md)."""

from __future__ import annotations

import numpy as np

# a pixel is "off" when its mean differs from the reference's by more than
# this share of the reference's brightest channel (plus a floor for black)
PIXEL_TOL = 1e-3
PIXEL_FLOOR = 1e-3


def pixel_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(prog - ref).max(axis=1) / (np.abs(ref).max(axis=1) + PIXEL_FLOOR)


def pixels(prog: np.ndarray, ref: np.ndarray) -> dict:
    """``pixels_off``: the share of sampled pixels off by more than
    PIXEL_TOL (a path that took another winner moves a pixel; a wrong
    estimator moves most); ``median_gap``: the median pixel's gap."""
    g = pixel_gaps(prog, ref)
    if not np.all(np.isfinite(g)):
        return {"pixels_off": 1.0, "median_gap": float("inf")}
    return {"pixels_off": float((g > PIXEL_TOL).mean()), "median_gap": float(np.median(g))}


LEAVES = (("emission", slice(0, 3)), ("diffuse", slice(3, 6)), ("ior", slice(6, 7)),
          ("reflectivity", slice(7, 8)), ("cone_angle", slice(8, 9)))


def leaf_gap(prog_rows, ref_rows, ref_grad_rows) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger; leaves whose reference gradient is under a thousandth of the
    median leaf's (round-off alone moves them) are left out."""
    p = [np.linalg.norm(np.asarray(prog_rows)[:, s]) for _, s in LEAVES]
    r = [np.linalg.norm(np.asarray(ref_rows)[:, s]) for _, s in LEAVES]
    g = [np.linalg.norm(np.asarray(ref_grad_rows)[:, s]) for _, s in LEAVES]
    gm, rm = float(np.median(g)), float(np.median(r))
    gaps = [abs(pi - ri) / max(ri, rm) for pi, ri, gi in zip(p, r, g) if gi >= 1e-3 * gm]
    return float(max(gaps)) if gaps else 0.0


def training(losses_p, losses_r, tables_p, tables_r, lr: float) -> dict:
    """``loss_gap``: the worst step's relative gap of the loss;
    ``grad_gap``: the first gradient, as (m0 - m1) / lr; ``change_gap``:
    m_n - m0 after the compared steps; both by the worst leaf."""
    lp, lr_ = np.asarray(losses_p, np.float64), np.asarray(losses_r, np.float64)
    if not (np.all(np.isfinite(lp)) and len(lp) == len(lr_)):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    tp = [np.asarray(t, np.float64) for t in tables_p]
    tr = [np.asarray(t, np.float64) for t in tables_r]
    g_r = (tr[0] - tr[1]) / lr
    return {
        "loss_gap": float(np.max(np.abs(lp - lr_) / np.abs(lr_))),
        "grad_gap": leaf_gap((tp[0] - tp[1]) / lr, g_r, g_r),
        "change_gap": leaf_gap(tp[-1] - tp[0], tr[-1] - tr[0], g_r),
    }
