"""Pose-accuracy metrics for self-evaluation (host-side numpy).

The port's copy of picopose_tpu/eval/metrics.py (:15-72), numpy with
``scipy.spatial.cKDTree``: rotation / translation errors and the classic
ADD / ADD-S point metrics (Hinterstoisser et al.), including the "correct
if below 10% of object diameter" criterion.  Official BOP AR comes from
eval/bop_scoring.py (score_csv.py) or the external bop_toolkit.
"""

from __future__ import annotations

import numpy as np


def rotation_error_deg(R_pred: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    """Geodesic rotation error in degrees, batched over leading dims."""
    tr = np.einsum("...ij,...ij->...", R_pred, R_gt)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def translation_error(t_pred: np.ndarray, t_gt: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(t_pred) - np.asarray(t_gt), axis=-1)


def add_metric(
    R_pred, t_pred, R_gt, t_gt, model_points: np.ndarray
) -> np.ndarray:
    """ADD: mean distance between model points under the two poses."""
    p = model_points @ np.swapaxes(R_pred, -1, -2) + t_pred[..., None, :]
    g = model_points @ np.swapaxes(R_gt, -1, -2) + t_gt[..., None, :]
    return np.linalg.norm(p - g, axis=-1).mean(axis=-1)


def adds_metric(
    R_pred, t_pred, R_gt, t_gt, model_points: np.ndarray
) -> np.ndarray:
    """ADD-S: symmetric variant (nearest-point assignment)."""
    from scipy.spatial import cKDTree

    p = model_points @ np.swapaxes(R_pred, -1, -2) + np.asarray(t_pred)[..., None, :]
    g = model_points @ np.swapaxes(R_gt, -1, -2) + np.asarray(t_gt)[..., None, :]
    batch_shape = p.shape[:-2]
    out = []
    for pi, gi in zip(p.reshape(-1, *p.shape[-2:]), g.reshape(-1, *g.shape[-2:])):
        d, _ = cKDTree(gi).query(pi, k=1)
        out.append(d.mean())
    out = np.asarray(out).reshape(batch_shape) if batch_shape else np.asarray(out[0])
    return out


def pose_summary(
    R_pred, t_pred, R_gt, t_gt,
    model_points: np.ndarray | None = None,
    diameter: float | None = None,
) -> dict[str, float]:
    """Aggregate error statistics (+ ADD(-0.1d) accuracy when a model is
    given)."""
    rot = rotation_error_deg(R_pred, R_gt)
    tr = translation_error(t_pred, t_gt)
    out = {
        "rot_err_deg_mean": float(np.mean(rot)),
        "rot_err_deg_median": float(np.median(rot)),
        "trans_err_mean": float(np.mean(tr)),
        "trans_err_median": float(np.median(tr)),
    }
    if model_points is not None:
        add = add_metric(R_pred, t_pred, R_gt, t_gt, model_points)
        out["add_mean"] = float(np.mean(add))
        if diameter is not None:
            out["add_0.1d_acc"] = float(np.mean(add < 0.1 * diameter))
    return out
