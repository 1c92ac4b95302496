"""Batched RANSAC-PnP on the device, in plain PyTorch.

Counterpart of picopose_tpu/ops/pnp.py (plain XLA there, no kernel): the
same solver batched over (instance, hypothesis) with explicit batch axes
instead of vmap, and with no host synchronisation (no ``.item()``, no
data-dependent shapes):

  1. hypotheses: ``iters`` samples of 6 correspondences drawn with
     replacement from the valid-index table (a stable sort of ~valid);
  2. minimal solve: Hartley-normalised weighted DLT, smallest eigenvector
     by an unrolled Cholesky and 3 steps of inverse iteration, then 7
     Newton polar steps onto SO(3);
  3. all hypotheses scored loosely (4x threshold) on a 1024-point subset
     of the valid points drawn without replacement; the top 16 get 5
     Gauss-Newton steps and a strict score;
  4. refit: weighted DLT on the best hypothesis' inliers (the subset-ratio
     ``enough`` gate), then Gauss-Newton, each kept only if it scores at
     least as well; 2 final polar steps;
  5. the inlier ratio over all N points; identity pose and success=False
     with fewer than MIN_POINTS valid points or no inlier.

Random draws cannot be the JAX package's (its PRNG is not torch's), so
``ransac_pnp`` takes a ``torch.Generator`` or the draws themselves.
Everything is fp32.  Contractions are written as products and sums
rather than matmuls, and ``ransac_pnp`` runs under ``device.full_fp32``,
so TF32 cannot reach them.  Ties in the rankings
go to the lower index (stable sorts), as ``lax.top_k`` breaks them; a
non-positive-definite system gives NaN through the unrolled Cholesky,
which the degenerate-sample checks rely on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from picopose_tpu_torch.device import full_fp32


# the reference's OpenCV settings (2 px, 150 iterations) and the JAX
# package's solver constants
SAMPLE = 6             # points per minimal sample
REPROJ_PX = 2.0        # inlier threshold
REFINE_ITERS = 8       # Gauss-Newton steps after the refit
HYP_REFINE_ITERS = 5   # Gauss-Newton steps on each polished hypothesis
MIN_POINTS = 6         # fewer valid points: failure
SCORE_SUBSET = 1024    # points of the loose-scoring subset
POLISH_K = 16          # hypotheses polished


class PnPResult(NamedTuple):
    R: torch.Tensor             # (B, 3, 3)
    t: torch.Tensor             # (B, 3)
    inlier_ratio: torch.Tensor  # (B,)
    success: torch.Tensor       # (B,) bool


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, k) x (..., k, j) as products and a sum over k (fp32 exact
    whatever the TF32 settings)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) applied to (..., n, 3) points -> (..., n, 3)."""
    return (
        x[..., 0:1] * R[..., None, :, 0]
        + x[..., 1:2] * R[..., None, :, 1]
        + x[..., 2:3] * R[..., None, :, 2]
    )


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    W = _hat(w)
    theta = torch.clamp(theta, min=1e-12)
    return _eye(3, w) + (torch.sin(theta) / theta) * W + ((1.0 - torch.cos(theta)) / theta**2) * _mm(W, W)


def _det3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _unit_z(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, 1) in ``like``'s dtype, made on its device (no host copy)."""
    return (torch.arange(3, device=like.device) == 2).to(like.dtype)


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3); |det| < 1e-30 -> 1e-30."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    return adj / det[..., None, None]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of x >= 0."""
    return torch.pow(x, 1.0 / 3.0)


def _polar_step(X: torch.Tensor) -> torch.Tensor:
    """Determinant-scaled Newton step towards the polar factor."""
    g = 1.0 / _cbrt(_det3(X).abs() + 1e-20)
    return 0.5 * (g[..., None, None] * X + _inv3(X).transpose(-1, -2) / g[..., None, None])


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky of (..., n, n); a non-positive pivot gives NaN
    (no exception), as the JAX package's unrolled form does."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j : j + 1, k]
        d = torch.sqrt(s[..., :1])
        L[..., j:, j] = torch.cat([d, s[..., 1:] / d], dim=-1)
    return L


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b by forward and back substitution."""
    n = L.shape[-1]
    y = []
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[..., i, k] * y[k]
        y.append(acc / L[..., i, i])
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i] * x[k]
        x[i] = acc / L[..., i, i]
    return torch.stack(x, dim=-1)


def _normalize_points(pts: torch.Tensor, w: torch.Tensor, dim: int):
    """Hartley normalisation: zero weighted centroid, mean norm sqrt(dim)."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    centroid = (pts * w[..., None]).sum(-2) / wsum
    centered = pts - centroid[..., None, :]
    scale = (torch.linalg.vector_norm(centered, dim=-1) * w).sum(-1) / wsum[..., 0]
    s = math.sqrt(dim) / torch.clamp(scale, min=1e-9)
    return centered * s[..., None, None], centroid, s


def _weighted_dlt(pts3d: torch.Tensor, uv: torch.Tensor, w: torch.Tensor):
    """Weighted DLT pose from (..., n, 3) model points and (..., n, 2)
    normalised image points with weights (..., n).  Returns (R, t, ok)."""
    X, c3, s3 = _normalize_points(pts3d, w, 3)
    U, c2, s2 = _normalize_points(uv, w, 2)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)  # (..., n, 4)
    zeros = torch.zeros_like(Xh)
    u, v = U[..., :1], U[..., 1:2]
    row1 = torch.cat([Xh, zeros, -u * Xh], -1) * w[..., None]  # (..., n, 12)
    row2 = torch.cat([zeros, Xh, -v * Xh], -1) * w[..., None]
    A = torch.cat([row1, row2], -2)  # (..., 2n, 12)
    AtA = (A[..., :, :, None] * A[..., :, None, :]).sum(-3)
    # smallest eigenvector by shifted-Cholesky inverse iteration
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)
    shift = 1e-7 * tr / 12.0 + 1e-12
    L = _cholesky(AtA + shift[..., None, None] * _eye(12, AtA))
    p = torch.full_like(AtA[..., 0], 1.0 / math.sqrt(12.0))
    for _ in range(3):
        y = _cho_solve(L, p)
        p = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-20)
    p = torch.where(torch.isfinite(p).all(-1, keepdim=True), p, torch.ones_like(p))
    P = p.reshape(*p.shape[:-1], 3, 4)

    # de-normalise: P <- T2^-1 P T3
    one, zero = torch.ones_like(s2), torch.zeros_like(s2)
    T2inv = torch.stack([
        torch.stack([1.0 / s2, zero, c2[..., 0]], -1),
        torch.stack([zero, 1.0 / s2, c2[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    T3 = torch.zeros((*s3.shape, 4, 4), dtype=X.dtype, device=X.device)
    for i in range(3):
        T3[..., i, i] = s3
        T3[..., i, 3] = -s3 * c3[..., i]
    T3[..., 3, 3] = 1.0
    P = _mm(_mm(T2inv, P), T3)

    sign = torch.sign(_det3(P[..., :3]))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    P = P * sign[..., None, None]
    M = P[..., :3]
    R = M / _cbrt(torch.clamp(_det3(M), min=1e-20))[..., None, None]
    for _ in range(7):
        R = _polar_step(R)
    scale = torch.clamp((R * M).sum((-1, -2)) / 3.0, min=1e-9)  # trace(R^T M) / 3
    t = P[..., 3] / scale[..., None]
    ok = torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
    R = torch.where(ok[..., None, None], R, _eye(3, R).expand_as(R))
    t = torch.where(ok[..., None], t, _unit_z(t))
    return R, t, ok


def _reproj_err2_px(pts3d, pts2d_px, K, R, t):
    """Squared pixel reprojection errors (..., n); inf behind the camera.
    K (..., 3, 3) broadcasts against the leading axes of R and t."""
    p = _mv(R, pts3d) + t[..., None, :]
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    uv = p[..., :2] / z
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[..., None, :]
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], -1)[..., None, :]
    err2 = ((uv * f + c - pts2d_px) ** 2).sum(-1)
    return torch.where(p[..., 2] <= 0, torch.full_like(err2, math.inf), err2)


def _gauss_newton(pts3d, uv, w, R, t, iters: int):
    """Refine (R, t) by Gauss-Newton on normalised-coordinate reprojection
    with left-multiplicative twist updates; a non-finite step is skipped."""
    eye6 = 1e-6 * _eye(6, pts3d)
    for _ in range(iters):
        p = _mv(R, pts3d) + t[..., None, :]
        z = torch.clamp(p[..., 2], min=1e-6)
        iz = 1.0 / z
        u, v = p[..., 0] * iz, p[..., 1] * iz
        r = (torch.stack([u, v], -1) - uv) * w[..., None]
        zro = torch.zeros_like(u)
        Ju = torch.stack([iz, zro, -u * iz, -u * v, 1.0 + u * u, -v], -1) * w[..., None]
        Jv = torch.stack([zro, iz, -v * iz, -(1.0 + v * v), u * v, u], -1) * w[..., None]
        JtJ = (
            (Ju[..., :, :, None] * Ju[..., :, None, :]).sum(-3)
            + (Jv[..., :, :, None] * Jv[..., :, None, :]).sum(-3)
            + eye6
        )
        Jtr = (Ju * r[..., 0:1]).sum(-2) + (Jv * r[..., 1:2]).sum(-2)
        delta = -_cho_solve(_cholesky(JtJ), Jtr)
        dR = _exp_so3(delta[..., 3:])
        ok = torch.isfinite(delta).all(-1)
        R = torch.where(ok[..., None, None], _mm(dR, R), R)
        t = torch.where(ok[..., None], (dR * t[..., None, :]).sum(-1) + delta[..., :3], t)
    return R, t


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, ...) along N."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = x[torch.arange(B, device=x.device)[:, None], flat]
    return out.reshape(*idx.shape, *x.shape[2:])


def draw_samples(valid: torch.Tensor, iters: int, sample: int, subset: int,
                 generator: torch.Generator | None = None):
    """The solver's random draws for (B, N) ``valid``: (sample_idx
    (B, iters, sample) drawn with replacement from the valid indices,
    subset_idx (B, min(subset, N)): the valid points in random order,
    then the invalid ones in index order)."""
    B, N = valid.shape
    dev = valid.device
    table = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    nv = torch.clamp(valid.sum(-1), min=1)
    u = torch.rand((B, iters, sample), generator=generator, device=dev)
    r = torch.minimum((u * nv[:, None, None]).long(), (nv - 1)[:, None, None])
    sample_idx = _gather(table, r)
    keys = torch.rand((B, N), generator=generator, device=dev)
    keys = torch.where(valid, keys, torch.full_like(keys, -math.inf))
    subset_idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][:, : min(subset, N)]
    return sample_idx, subset_idx


@torch.inference_mode()
@full_fp32()
def ransac_pnp(
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    K: torch.Tensor,
    valid: torch.Tensor,
    iters: int = 150,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,
    subset_idx: torch.Tensor | None = None,
) -> PnPResult:
    """Batched RANSAC-PnP: pts3d (B, N, 3) model points, pts2d (B, N, 2)
    pixels, K (B, 3, 3), valid (B, N) bool.  Draws come from ``generator``
    unless ``sample_idx`` (B, iters, SAMPLE) and ``subset_idx``
    (B, min(SCORE_SUBSET, N)) are given (``draw_samples`` makes them)."""
    pts3d, pts2d, K = pts3d.float(), pts2d.float(), K.float()
    B, N = valid.shape
    if sample_idx is None or subset_idx is None:
        drawn = draw_samples(valid, iters, SAMPLE, SCORE_SUBSET, generator)
        sample_idx = drawn[0] if sample_idx is None else sample_idx
        subset_idx = drawn[1] if subset_idx is None else subset_idx
    w = valid.float()
    n_valid = w.sum(-1)  # (B,)
    Kinv = _inv3(K)
    uv = (
        pts2d[..., 0:1] * Kinv[:, None, :2, 0]
        + pts2d[..., 1:2] * Kinv[:, None, :2, 1]
        + Kinv[:, None, :2, 2]
    )  # normalised coordinates (B, N, 2)

    # scoring subset
    pts3d_s, pts2d_s, uv_s = (_gather(x, subset_idx) for x in (pts3d, pts2d, uv))
    valid_s = _gather(valid, subset_idx)
    nv_s = torch.clamp(valid_s.float().sum(-1), min=1.0)
    Kh = K[:, None]  # broadcast over hypotheses

    # minimal DLT hypotheses, loosely scored
    R_d, t_d, ok_d = _weighted_dlt(
        _gather(pts3d, sample_idx), _gather(uv, sample_idx),
        torch.ones(sample_idx.shape, dtype=torch.float32, device=pts3d.device),
    )  # (B, iters, ...)
    err2 = _reproj_err2_px(pts3d_s[:, None], pts2d_s[:, None], Kh, R_d, t_d)
    loose = ((err2 < (4.0 * REPROJ_PX) ** 2) & valid_s[:, None]).sum(-1)
    loose_scores = torch.where(ok_d, loose, torch.full_like(loose, -1))

    # top hypotheses polished by Gauss-Newton on their own sample
    top = torch.sort(loose_scores, dim=-1, descending=True, stable=True)[1][:, :POLISH_K]
    top_idx = _gather(sample_idx, top)  # (B, POLISH_K, SAMPLE)
    Rs, ts = _gauss_newton(
        _gather(pts3d, top_idx), _gather(uv, top_idx),
        torch.ones(top_idx.shape, dtype=torch.float32, device=pts3d.device),
        _gather(R_d, top), _gather(t_d, top), HYP_REFINE_ITERS,
    )
    err2 = _reproj_err2_px(pts3d_s[:, None], pts2d_s[:, None], Kh, Rs, ts)
    inl = ((err2 < REPROJ_PX**2) & valid_s[:, None]).sum(-1)
    scores = torch.where(_gather(loose_scores, top) >= 0, inl, torch.full_like(inl, -1))
    best = torch.argmax(scores, dim=-1)  # first maximum
    R0, t0 = _gather(Rs, best[:, None])[:, 0], _gather(ts, best[:, None])[:, 0]
    best_score = _gather(scores, best[:, None])[:, 0]

    # refit on the best inliers, then Gauss-Newton; each kept if not worse
    strict = lambda R, t: (_reproj_err2_px(pts3d_s, pts2d_s, K, R, t) < REPROJ_PX**2) & valid_s
    inl_w = strict(R0, t0).float()
    enough = inl_w.sum(-1) * n_valid >= MIN_POINTS * nv_s
    refit_w = torch.where(enough[:, None], inl_w, valid_s.float())
    R1, t1, ok1 = _weighted_dlt(pts3d_s, uv_s, refit_w)
    better = ok1 & (strict(R1, t1).sum(-1) >= best_score)
    R1 = torch.where(better[:, None, None], R1, R0)
    t1 = torch.where(better[:, None], t1, t0)
    R2, t2 = _gauss_newton(pts3d_s, uv_s, refit_w, R1, t1, REFINE_ITERS)
    use_gn = strict(R2, t2).sum(-1) >= best_score
    R_out = torch.where(use_gn[:, None, None], R2, R1)
    t_out = torch.where(use_gn[:, None], t2, t1)
    for _ in range(2):
        R_out = _polar_step(R_out)

    # final strict inlier count over all N points
    err2 = _reproj_err2_px(pts3d, pts2d, K, R_out, t_out)
    n_inl = ((err2 < REPROJ_PX**2) & valid).sum(-1)
    success = (n_valid >= MIN_POINTS) & (best_score > 0)
    R_out = torch.where(success[:, None, None], R_out, _eye(3, R_out).expand_as(R_out))
    t_out = torch.where(success[:, None], t_out, _unit_z(t_out))
    ratio = torch.where(success, n_inl.float() / torch.clamp(n_valid, min=1.0), torch.zeros_like(n_valid))
    return PnPResult(R_out, t_out, ratio, success)
