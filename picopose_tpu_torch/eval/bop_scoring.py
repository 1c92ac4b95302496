"""In-repo BOP19-style pose scoring: MSSD / MSPD / VSD average recall.

The port's copy of picopose_tpu/eval/bop_scoring.py, numpy and scipy
only: the symmetries (:35-62), ``mssd`` (:64), ``mspd`` (:76), ``vsd``
(:94), ``read_csv`` (:160), ``score_bop19`` (:179), ``bootstrap_ar``
(:297) and ``paired_delta_ar`` (:336), with the same arithmetic, numpy
generators and seeds, so the results are equal.

  * MSSD: max symmetry-aware surface distance
      e = min_{S in syms} max_x || (R̂ x̂_S + t̂) - (R x_S + t) ||,
    recall averaged over thresholds {0.05 .. 0.5} * object diameter;
  * MSPD: max symmetry-aware projection distance in pixels,
    recall averaged over thresholds {5 .. 50} * r, r = im_width / 640;
  * VSD (when a depth renderer is given): visible surface discrepancy
    over taus {0.05 .. 0.5} * diameter and thresholds {0.05 .. 0.5};
  * matching follows the BOP19 protocol: per (scene, image, object), the
    top-`inst_count` estimates by score are greedily matched 1:1 to GT
    instances (highest-score estimate first, best remaining GT by error).

AR_{MSSD,MSPD,VSD} = mean recall over their threshold grids; AR_bop19 is
their mean.  score_csv.py scores a run_test CSV with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MSSD_THRESHOLDS = np.arange(0.05, 0.51, 0.05)   # x diameter
MSPD_THRESHOLDS = np.arange(5.0, 51.0, 5.0)     # x r px, r = width/640
VSD_TAUS = np.arange(0.05, 0.51, 0.05)          # x diameter
VSD_THETAS = np.arange(0.05, 0.51, 0.05)        # error thresholds


def identity_syms() -> np.ndarray:
    return np.eye(4)[None]


def discrete_syms(transforms: list[dict]) -> np.ndarray:
    """BOP models_info 'symmetries_discrete' entries -> (S, 4, 4) incl. I."""
    out = [np.eye(4)]
    for t in transforms:
        out.append(np.asarray(t).reshape(4, 4) if not isinstance(t, dict)
                   else np.asarray(t["matrix"]).reshape(4, 4)
                   if "matrix" in t else np.eye(4))
    return np.stack(out)


def continuous_syms(axis: np.ndarray, n: int = 36) -> np.ndarray:
    """Discretized continuous symmetry around `axis` (bop_toolkit uses the
    same discretization for MSSD/MSPD)."""
    from scipy.spatial.transform import Rotation

    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    out = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(axis * ang).as_matrix()
        out.append(T)
    return np.stack(out)


def mssd(R_est, t_est, R_gt, t_gt, pts: np.ndarray, syms: np.ndarray) -> float:
    """Max symmetry-aware surface distance (units of pts/t)."""
    p_est = pts @ R_est.T + t_est
    best = np.inf
    for S in syms:
        pts_s = pts @ S[:3, :3].T + S[:3, 3]
        p_gt = pts_s @ R_gt.T + t_gt
        d = np.linalg.norm(p_est - p_gt, axis=-1).max()
        best = min(best, d)
    return float(best)


def mspd(R_est, t_est, R_gt, t_gt, K, pts: np.ndarray, syms: np.ndarray) -> float:
    """Max symmetry-aware projection distance (px)."""

    def proj(R, t, p):
        q = p @ R.T + t
        q = q @ K.T
        return q[:, :2] / q[:, 2:3]

    u_est = proj(R_est, t_est, pts)
    best = np.inf
    for S in syms:
        pts_s = pts @ S[:3, :3].T + S[:3, 3]
        u_gt = proj(R_gt, t_gt, pts_s)
        d = np.linalg.norm(u_est - u_gt, axis=-1).max()
        best = min(best, d)
    return float(best)


def vsd(
    d_est: np.ndarray,
    d_gt: np.ndarray,
    d_scene: np.ndarray | None,
    taus: np.ndarray,
    delta: float = 15.0,
) -> np.ndarray:
    """Visible surface discrepancy errors, one per tau (bop_toolkit
    pose_error.vsd semantics with normalized_by_diameter handled by the
    caller's tau values).

    d_est / d_gt: rendered object depth maps (0 = background), same units as
    d_scene (mm for BOP).  d_scene may be None (no occluders: everything
    rendered is visible).  delta: visibility tolerance (bop default 15 mm).
    """
    p_est = d_est > 0
    p_gt = d_gt > 0
    if d_scene is None:
        v_est, v_gt = p_est, p_gt
    else:
        seen = d_scene > 0
        v_gt = p_gt & (~seen | (d_gt <= d_scene + delta))
        v_est = p_est & (~seen | (d_est <= d_scene + delta))
        # bop19 amendment: the estimate is "visible" wherever the GT is
        # visible and the estimate renders at all
        v_est = v_est | (v_gt & p_est)
    union = v_est | v_gt
    n = union.sum()
    if n == 0:
        return np.ones_like(np.asarray(taus, np.float64))
    both = v_est & v_gt
    dist = np.abs(d_est - d_gt)
    errs = []
    for tau in np.asarray(taus, np.float64):
        ok = both & (dist < tau)
        errs.append(1.0 - ok.sum() / n)
    return np.asarray(errs)


@dataclass
class Estimate:
    scene_id: int
    im_id: int
    obj_id: int
    score: float
    R: np.ndarray
    t: np.ndarray  # same units as GT (mm for BOP)


@dataclass
class GTInstance:
    scene_id: int
    im_id: int
    obj_id: int
    R: np.ndarray
    t: np.ndarray
    visib_fract: float = 1.0


@dataclass
class ObjectModel:
    pts: np.ndarray           # (N, 3) sampled surface points (mm)
    diameter: float           # mm
    syms: np.ndarray = field(default_factory=identity_syms)


def read_csv(path: str) -> list[Estimate]:
    """Parse a bop19 CSV (the format run_test.py emits)."""
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("scene_id"):
            continue
        f = line.split(",")
        out.append(
            Estimate(
                scene_id=int(f[0]), im_id=int(f[1]), obj_id=int(f[2]),
                score=float(f[3]),
                R=np.array(f[4].split(), np.float64).reshape(3, 3),
                t=np.array(f[5].split(), np.float64),
            )
        )
    return out


def score_bop19(
    estimates: list[Estimate],
    gts: list[GTInstance],
    models: dict[int, ObjectModel],
    K_by_image: dict[tuple[int, int], np.ndarray],
    im_width: int = 640,
    visib_gt_min: float = 0.1,
    render_depth=None,
    scene_depth_by_image: dict[tuple[int, int], np.ndarray] | None = None,
    vsd_delta: float = 15.0,
    per_instance: list | None = None,
) -> dict[str, float]:
    """Greedy-match estimates to GT and compute AR_MSSD / AR_MSPD (+ AR_VSD
    and the full bop19 AR when a depth renderer is provided).

    render_depth: optional callable (obj_id, R, t, K) -> (H, W) depth map in
    the GT units (mm) — e.g. a closure over
    picopose_tpu_torch.native.renderer.render_views.

    per_instance: optional list; when given, one record per scored GT
    instance (matched or not) is appended — dicts of per-threshold hit
    vectors — for resampling statistics (`bootstrap_ar`).
    """
    from collections import defaultdict

    gt_by_key: dict[tuple, list[GTInstance]] = defaultdict(list)
    for g in gts:
        gt_by_key[(g.scene_id, g.im_id, g.obj_id)].append(g)
    est_by_key: dict[tuple, list[Estimate]] = defaultdict(list)
    for e in estimates:
        est_by_key[(e.scene_id, e.im_id, e.obj_id)].append(e)

    r = im_width / 640.0
    mssd_hits = np.zeros(len(MSSD_THRESHOLDS))
    mspd_hits = np.zeros(len(MSPD_THRESHOLDS))
    vsd_hits = np.zeros((len(VSD_TAUS), len(VSD_THETAS)))
    n_gt_scored = 0

    for key, gt_list in gt_by_key.items():
        gt_list = [g for g in gt_list if g.visib_fract >= visib_gt_min]
        if not gt_list:
            continue
        model = models[key[2]]
        K = K_by_image[(key[0], key[1])]
        ests = sorted(est_by_key.get(key, []), key=lambda e: -e.score)
        ests = ests[: len(gt_list)]

        taken = [False] * len(gt_list)
        for e in ests:
            # greedy: best remaining GT by MSSD
            errs = [
                (mssd(e.R, e.t, g.R, g.t, model.pts, model.syms), gi)
                for gi, g in enumerate(gt_list) if not taken[gi]
            ]
            if not errs:
                break
            err_s, gi = min(errs)
            taken[gi] = True
            g = gt_list[gi]
            err_p = mspd(e.R, e.t, g.R, g.t, K, model.pts, model.syms)
            rec = {
                # stable GT identity (scene, image, object, index within the
                # visib-filtered gt_list) — lets two scoring runs over the
                # SAME ground truth be joined instance-by-instance for
                # paired statistics (`paired_delta_ar`)
                "id": (key[0], key[1], key[2], gi),
                "mssd": err_s < MSSD_THRESHOLDS * model.diameter,
                "mspd": err_p < MSPD_THRESHOLDS * r,
                "vsd": None,
            }
            mssd_hits += rec["mssd"]
            mspd_hits += rec["mspd"]
            if render_depth is not None:
                d_est = render_depth(key[2], e.R, e.t, K)
                d_gt = render_depth(key[2], g.R, g.t, K)
                d_scene = (
                    scene_depth_by_image.get((key[0], key[1]))
                    if scene_depth_by_image
                    else None
                )
                ev = vsd(
                    d_est, d_gt, d_scene, VSD_TAUS * model.diameter, vsd_delta
                )
                rec["vsd"] = ev[:, None] < VSD_THETAS[None, :]
                vsd_hits += rec["vsd"]
            if per_instance is not None:
                per_instance.append(rec)
        if per_instance is not None:
            for gi, was_taken in enumerate(taken):  # unmatched GT = misses
                if was_taken:
                    continue
                per_instance.append({
                    "id": (key[0], key[1], key[2], gi),
                    "mssd": np.zeros(len(MSSD_THRESHOLDS), bool),
                    "mspd": np.zeros(len(MSPD_THRESHOLDS), bool),
                    "vsd": (
                        np.zeros((len(VSD_TAUS), len(VSD_THETAS)), bool)
                        if render_depth is not None else None
                    ),
                })
        n_gt_scored += len(gt_list)

    n = max(n_gt_scored, 1)
    ar_mssd = float((mssd_hits / n).mean())
    ar_mspd = float((mspd_hits / n).mean())
    out = {
        "AR_MSSD": ar_mssd,
        "AR_MSPD": ar_mspd,
        "AR_mssd_mspd": (ar_mssd + ar_mspd) / 2.0,
        "n_gt": n_gt_scored,
    }
    if render_depth is not None:
        ar_vsd = float((vsd_hits / n).mean())
        out["AR_VSD"] = ar_vsd
        out["AR_bop19"] = (ar_mssd + ar_mspd + ar_vsd) / 3.0
    return out


def bootstrap_ar(
    per_instance: list,
    n_boot: int = 2000,
    seed: int = 0,
    alpha: float = 0.05,
) -> dict[str, list[float]]:
    """Percentile bootstrap CIs for the AR metrics over GT instances.

    AR_x = mean over thresholds of hits/n = mean over instances of each
    instance's per-threshold recall, so resampling instance-level recall
    scalars is exact.  Returns {metric: [lo, hi]} at the (1-alpha) level."""
    rng = np.random.default_rng(seed)
    n = len(per_instance)
    if n == 0:
        return {}
    r_mssd = np.array([rec["mssd"].mean() for rec in per_instance])
    r_mspd = np.array([rec["mspd"].mean() for rec in per_instance])
    has_vsd = per_instance[0]["vsd"] is not None
    r_vsd = (
        np.array([rec["vsd"].mean() for rec in per_instance])
        if has_vsd else None
    )
    idx = rng.integers(0, n, size=(n_boot, n))
    ms, mp_ = r_mssd[idx].mean(1), r_mspd[idx].mean(1)
    stats = {
        "AR_MSSD": ms,
        "AR_MSPD": mp_,
        "AR_mssd_mspd": (ms + mp_) / 2.0,
    }
    if has_vsd:
        vs = r_vsd[idx].mean(1)
        stats["AR_VSD"] = vs
        stats["AR_bop19"] = (ms + mp_ + vs) / 3.0
    qs = [100 * alpha / 2, 100 * (1 - alpha / 2)]
    return {
        k: [float(x) for x in np.percentile(v, qs)] for k, v in stats.items()
    }


def paired_delta_ar(
    records_a: list,
    records_b: list,
    n_boot: int = 2000,
    seed: int = 0,
    alpha: float = 0.05,
) -> dict[str, dict]:
    """Paired percentile-bootstrap CI for AR(b) - AR(a) over shared GT
    instances.

    Both record lists must come from `score_bop19(per_instance=...)` runs
    over the SAME ground truth (matched on the records' `id`).  Because both
    arms score identical instances, resampling the per-instance recall
    DELTAS cancels the instance-difficulty variance that dominates
    independent per-arm CIs.  This plays the role bop_toolkit AR deltas
    play in the reference's eval protocol.

    Returns {metric: {"delta": mean_b_minus_a, "ci95": [lo, hi]}}.
    """
    rng = np.random.default_rng(seed)
    by_id_a = {rec["id"]: rec for rec in records_a}
    by_id_b = {rec["id"]: rec for rec in records_b}
    shared = sorted(set(by_id_a) & set(by_id_b))
    if set(by_id_a) != set(by_id_b):
        raise ValueError(
            f"record sets differ: {len(by_id_a)} vs {len(by_id_b)} instances, "
            f"{len(shared)} shared — arms must score the same ground truth"
        )
    n = len(shared)
    if n == 0:
        return {}

    def recalls(by_id, field):
        return np.array([by_id[i][field].mean() for i in shared])

    d_mssd = recalls(by_id_b, "mssd") - recalls(by_id_a, "mssd")
    d_mspd = recalls(by_id_b, "mspd") - recalls(by_id_a, "mspd")
    has_vsd = (
        by_id_a[shared[0]]["vsd"] is not None
        and by_id_b[shared[0]]["vsd"] is not None
    )
    idx = rng.integers(0, n, size=(n_boot, n))
    ms, mp_ = d_mssd[idx].mean(1), d_mspd[idx].mean(1)
    deltas = {
        "AR_MSSD": (d_mssd, ms),
        "AR_MSPD": (d_mspd, mp_),
        "AR_mssd_mspd": ((d_mssd + d_mspd) / 2.0, (ms + mp_) / 2.0),
    }
    if has_vsd:
        d_vsd = recalls(by_id_b, "vsd") - recalls(by_id_a, "vsd")
        vs = d_vsd[idx].mean(1)
        deltas["AR_VSD"] = (d_vsd, vs)
        deltas["AR_bop19"] = (
            (d_mssd + d_mspd + d_vsd) / 3.0, (ms + mp_ + vs) / 3.0
        )
    qs = [100 * alpha / 2, 100 * (1 - alpha / 2)]
    return {
        k: {
            "delta": float(d.mean()),
            "ci95": [float(x) for x in np.percentile(boot, qs)],
            "n": n,
        }
        for k, (d, boot) in deltas.items()
    }
