"""Hermetic synthetic scenes: a textured sphere ray-traced in closed form.

The port's numpy copy of picopose_tpu/data/synthetic.py: RGB, depth, mask
and exact poses for any viewpoint, with a texture that is a function of the
model-frame surface point, so views of one sphere agree with each other and
GT keypoints, flow supervision and PnP all see real geometry.  It feeds the
training step's tests and ``chip_smoke.py`` without data files.

The JAX package crops with cv2; the port does without (the GPU machine's
cv2 is not a dependency), so ``warp_affine`` writes out cv2.warpAffine's
arithmetic as cv2 5.0 computes it for float32 images: the affine is
inverted in float64 and rounded to float32, each source coordinate is
fma(a0, x, a1 * y + a2) in float32 (no fixed-point 1/32-pixel grid),
INTER_LINEAR lerps the four taps with fmas, outside taps read the constant
border 0, and INTER_NEAREST rounds half to even.  The fmas are emulated in
float64 and rounded once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from picopose_tpu_torch.data.crops import CLIP_MEAN, CLIP_STD, nearest_index

K_TEMPLATE = np.array(
    [[572.4114, 0.0, 320.0], [0.0, 573.57043, 240.0], [0.0, 0.0, 1.0]],
    np.float32,
)  # the reference's fixed template intrinsics


def _texture(p_model: np.ndarray, radius: float) -> np.ndarray:
    """Viewpoint-invariant procedural texture over model-frame points."""
    q = p_model / radius
    r = 0.5 + 0.45 * np.sin(9.0 * q[..., 0]) * np.cos(7.0 * q[..., 1])
    g = 0.5 + 0.45 * np.sin(8.0 * q[..., 1] + 1.3) * np.cos(6.0 * q[..., 2])
    b = 0.5 + 0.45 * np.sin(10.0 * q[..., 2] + 2.1) * np.cos(5.0 * q[..., 0])
    return np.stack([r, g, b], axis=-1)


def render_sphere(
    K: np.ndarray, pose: np.ndarray, radius: float, hw: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-trace a textured sphere: K (3, 3), pose (4, 4) camera-from-model,
    radius in meters, hw (H, W).  Returns (rgb (H, W, 3) in [0, 1], depth
    (H, W) meters with 0 on the background, mask (H, W) float)."""
    H, W = hw
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1).astype(np.float64)
    d = pix @ np.linalg.inv(K).T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)

    c = pose[:3, 3].astype(np.float64)
    b = (d * c).sum(-1)  # |s d - c|^2 = r^2
    disc = b**2 - (c @ c - radius**2)
    hit = disc > 0
    s = b - np.sqrt(np.maximum(disc, 0.0))
    hit &= s > 0
    p_cam = s[..., None] * d
    depth = np.where(hit, p_cam[..., 2], 0.0)

    R = pose[:3, :3].astype(np.float64)
    p_model = (p_cam - c) @ R  # R^T (p - t), row-vector form
    rgb = _texture(p_model, radius)
    shade = 0.6 + 0.4 * np.clip(-(p_cam - c) @ (c / np.linalg.norm(c)), 0, None) / radius
    rgb = np.clip(rgb * shade[..., None], 0.0, 1.0)
    rgb = np.where(hit[..., None], rgb, 0.0)
    return rgb.astype(np.float32), depth.astype(np.float32), hit.astype(np.float32)


def square_crop_affine(mask: np.ndarray, out: int) -> np.ndarray:
    """Isotropic crop matrix M mapping the image to an out x out crop around
    the mask's square bbox."""
    ys, xs = np.where(mask > 0.5)
    if len(ys) == 0:
        return np.eye(3, dtype=np.float32)
    y1, y2, x1, x2 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    side = max(y2 - y1, x2 - x1)
    cy, cx = (y1 + y2) / 2.0, (x1 + x2) / 2.0
    s = out / side
    return np.array(
        [[s, 0.0, out / 2.0 - s * cx], [0.0, s, out / 2.0 - s * cy], [0.0, 0.0, 1.0]],
        np.float32,
    )


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, out: int, nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine(img, M[:2], (out, out)) of a float32 (H, W) or
    (H, W, C) image, INTER_LINEAR or (``nearest``) INTER_NEAREST, constant
    border 0 (module docstring)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    A = np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32)
    ys, xs = np.mgrid[0:out, 0:out].astype(np.float32)
    sx = _fma32(A[0, 0], xs, A[0, 1] * ys + A[0, 2])
    sy = _fma32(A[1, 0], xs, A[1, 1] * ys + A[1, 2])

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(inside.reshape(inside.shape + (1,) * (img.ndim - 2)), v, np.float32(0))

    if nearest:
        return tap(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    v00, v01, v10, v11 = tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top, bottom = _fma32(fx, v01 - v00, v00), _fma32(fx, v11 - v10, v10)
    return _fma32(fy, bottom - top, top)


def clip_normalize(rgb: np.ndarray) -> np.ndarray:
    """CLIP mean/std normalisation (no BGR flip: the texture has no colour
    convention)."""
    return (rgb - CLIP_MEAN) / CLIP_STD


@dataclass
class SyntheticView:
    rgb: np.ndarray          # (S, S, 3) normalised crop
    mask: np.ndarray         # (S, S)
    M: np.ndarray            # (3, 3)
    K: np.ndarray            # (3, 3)
    pose: np.ndarray         # (4, 4)
    full_depth: np.ndarray   # (H, W)
    depth_crop_pts: np.ndarray | None = None  # (g, g, 3) camera points, templates


def make_view(
    pose: np.ndarray,
    radius: float = 0.05,
    K: np.ndarray | None = None,
    image_hw: tuple[int, int] = (480, 640),
    crop: int = 224,
    pts_grid: int = 64,
) -> SyntheticView:
    """One rendered view, cropped around the sphere: the crop, its mask and
    affine, and (the template contract) the camera points of the crop on a
    ``pts_grid`` grid, cropped and resized with nearest samples."""
    K = K_TEMPLATE if K is None else K
    rgb, depth, mask = render_sphere(K, pose, radius, image_hw)
    M = square_crop_affine(mask, crop)
    rgb_c = warp_affine(rgb, M, crop)
    mask_c = (warp_affine(mask, M, crop) > 0.5).astype(np.float32)
    pts_c = warp_affine(_depth_to_points(depth, K), M, crop, nearest=True)
    idx = nearest_index(crop, pts_grid)  # cv2.resize INTER_NEAREST
    return SyntheticView(
        rgb=clip_normalize(rgb_c),
        mask=mask_c,
        M=M,
        K=K.astype(np.float32),
        pose=pose.astype(np.float32),
        full_depth=depth,
        depth_crop_pts=pts_c[idx][:, idx].astype(np.float32),
    )


def _depth_to_points(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    H, W = depth.shape
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    X = (xs - K[0, 2]) * depth / K[0, 0]
    Y = (ys - K[1, 2]) * depth / K[1, 1]
    return np.stack([X, Y, depth], axis=-1).astype(np.float32)


def make_pose(azimuth: float, elevation: float, z: float = 0.6) -> np.ndarray:
    """Camera-from-model pose looking at the object from (az, el):
    R = Rx(elevation) @ Rz(azimuth), t = (0, 0, z)."""
    ca, sa, ce, se = np.cos(azimuth), np.sin(azimuth), np.cos(elevation), np.sin(elevation)
    Rz = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, ce, -se], [0.0, se, ce]])
    pose = np.eye(4)
    pose[:3, :3] = Rx @ Rz
    pose[:3, 3] = [0.0, 0.0, z]
    return pose


def query_pts2d(M: np.ndarray, crop: int = 224, grid: int = 64) -> np.ndarray:
    """Original-image coordinates of the crop's patch centres (the test
    loader's real_pts2d contract)."""
    patch = crop / grid
    cs = np.arange(grid) * patch + patch / 2.0
    xx, yy = np.meshgrid(cs, cs)
    pts = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(M).T
    return (pts[..., :2] / pts[..., 2:]).astype(np.float32)
