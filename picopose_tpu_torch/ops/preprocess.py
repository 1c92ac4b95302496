"""Batched preprocessing on the device: one frame + masks/boxes -> crops.

Counterpart of picopose_tpu/ops/preprocess.py::preprocess_frame (:155),
plain PyTorch (it is plain XLA there, no Pallas kernel).  The host uploads
one uint8 frame and a (B, H, W) mask stack; every detection's crop comes
out of two separable products (``_crop_one`` :113):

    crop = Ry @ frame @ Rx^T   (per channel)

with Ry (out x H) and Rx (out x W) carrying each output row's and
column's two bilinear taps, cv2.INTER_LINEAR semantics (centre-aligned
taps, border replicate inside the crop); the mask the same way with
one-hot cv2.INTER_NEAREST rows (src = floor(dst * scale) in fp32, as the
JAX package computes it).  The products run in fp32 under
``device.full_fp32`` (no TF32 whatever the process flags), the
counterpart of the JAX code's ``Precision.HIGHEST``.  The bbox follows the host's integer
flow exactly (``_bbox_from_mask`` :43 with exclusive y2/x2, ``_squareize``
:58); M and pts2d are closed forms of data/crops.py's.

``preprocess_frame_graphed`` is the compiled program, a CUDA graph
(utils/graphs.py), as the JAX package jit-compiles ``preprocess_frame``
(:154).  Nothing here copies from the host, so a graph can hold it.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.device import full_fp32
from picopose_tpu_torch.utils.graphs import GraphCache

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _vector(values: tuple[float, ...], dev: torch.device) -> torch.Tensor:
    """fp32 constants filled on the device (no host copy)."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=dev) for v in values])


def _bbox_from_mask(masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W) masks -> (B, 4) int64 tight boxes (y1, y2, x1, x2), y2 and
    x2 exclusive: the first and last row / column holding a pixel."""
    H, W = masks.shape[1:]
    rows = (masks > 0).any(dim=2).to(torch.uint8)
    cols = (masks > 0).any(dim=1).to(torch.uint8)
    y1, x1 = rows.argmax(dim=1), cols.argmax(dim=1)
    y2 = H - rows.flip(1).argmax(dim=1)
    x2 = W - cols.flip(1).argmax(dim=1)
    return torch.stack([y1, y2, x1, x2], dim=1)


def _squareize(bbox: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Square (B, 4) boxes with the host's integer flow (size ratio 1):
    side = min(max(h, w), min(H, W)), centred, shifted inside the image in
    y-then-x order (one pass suffices since side <= min(H, W))."""
    rmin, rmax, cmin, cmax = bbox.unbind(1)
    b = torch.clamp(torch.maximum(rmax - rmin, cmax - cmin), max=min(H, W))
    cy, cx = (rmin + rmax) // 2, (cmin + cmax) // 2
    half = b // 2
    rmin, rmax, cmin, cmax = cy - half, cy + half, cx - half, cx + half
    rmax = torch.where(rmin < 0, rmax - rmin, rmax)
    rmin = torch.clamp(rmin, min=0)
    cmax = torch.where(cmin < 0, cmax - cmin, cmax)
    cmin = torch.clamp(cmin, min=0)
    rmin = torch.where(rmax > H, rmin - (rmax - H), rmin)
    rmax = torch.clamp(rmax, max=H)
    cmin = torch.where(cmax > W, cmin - (cmax - W), cmin)
    cmax = torch.clamp(cmax, max=W)
    return torch.stack([rmin, rmax, cmin, cmax], dim=1)


def _linear_weights(lo: torch.Tensor, size: torch.Tensor, n_src: int, out: int) -> torch.Tensor:
    """(B, out, n_src) bilinear rows resizing the spans [lo, lo + size) to
    ``out`` samples, cv2.INTER_LINEAR semantics."""
    scale = size.float()[:, None] / out
    src = (torch.arange(out, dtype=torch.float32, device=lo.device) + 0.5) * scale - 0.5
    fl = torch.floor(src)
    i0 = torch.minimum(torch.clamp(fl, min=0), (size - 1).float()[:, None]).long()
    i1 = torch.minimum(i0 + 1, (size - 1)[:, None])
    w1 = torch.where(src < 0, 0.0, torch.clamp(src - fl, 0.0, 1.0))
    iota = torch.arange(n_src, device=lo.device)
    a0, a1 = (lo[:, None] + i0)[..., None], (lo[:, None] + i1)[..., None]
    # i1 == i0 at the right border: both terms land on one column and sum to 1
    return (iota == a0) * (1.0 - w1)[..., None] + (iota == a1) * w1[..., None]


def _nearest_rows(lo: torch.Tensor, size: torch.Tensor, n_src: int, out: int) -> torch.Tensor:
    """(B, out, n_src) one-hot rows, cv2.INTER_NEAREST (src = floor(dst *
    scale), clamped)."""
    scale = size.float()[:, None] / out
    dst = torch.arange(out, dtype=torch.float32, device=lo.device)
    src = torch.minimum(torch.floor(dst * scale), (size - 1).float()[:, None]).long() + lo[:, None]
    return (torch.arange(n_src, device=lo.device) == src[..., None]).float()


@full_fp32()
def preprocess_frame(
    frame: torch.Tensor,
    masks: torch.Tensor,
    bboxes: torch.Tensor | None = None,
    use_bbox: torch.Tensor | None = None,
    out: int = 224,
    pts: int = 64,
    mask_rgb: bool = False,
) -> dict[str, torch.Tensor]:
    """(H, W, 3) uint8 frame + (B, H, W) masks -> the model's crop batch.

    bboxes (B, 4) as (y1, y2, x1, x2) with use_bbox (B,) select the
    detector-box path per detection (the host's fallback for masks with too
    few pixels); both kinds of box are squared here.  Returns real_rgb
    (B, out, out, 3) CLIP-normalised, real_mask (B, out, out), real_M
    (B, 3, 3) and real_pts2d (B, pts, pts, 2), all fp32, on the frame's
    device.
    """
    H, W = frame.shape[:2]
    dev = frame.device
    ff = frame[..., :3].flip(-1).float() / 255.0  # BGR, as the network takes it
    raw = _bbox_from_mask(masks)
    if bboxes is not None:
        use = torch.ones(len(bboxes), dtype=torch.bool, device=dev) if use_bbox is None else use_bbox
        raw = torch.where(use[:, None], bboxes.to(raw.dtype), raw)
    y1, y2, x1, x2 = _squareize(raw, H, W).unbind(1)
    hsz, wsz = y2 - y1, x2 - x1

    Ry = _linear_weights(y1, hsz, H, out)  # (B, out, H)
    Rx = _linear_weights(x1, wsz, W, out)  # (B, out, W)
    if mask_rgb:
        rows = torch.einsum("byh,bhwc->bywc", Ry, ff * (masks > 0)[..., None])
    else:
        rows = torch.einsum("byh,hwc->bywc", Ry, ff)
    crop = torch.einsum("bywc,bxw->byxc", rows, Rx)
    rgb = (crop - _vector(CLIP_MEAN, dev)) / _vector(CLIP_STD, dev)

    Ny = _nearest_rows(y1, hsz, H, out)
    Nx = _nearest_rows(x1, wsz, W, out)
    m = torch.einsum("byh,bhw,bxw->byx", Ny, masks.float(), Nx)

    # M (data/crops.py::crop_matrix) and pts2d (grid_pts2d) in closed form
    s, sx = out / hsz.float(), out / wsz.float()
    B = masks.shape[0]
    M = torch.zeros(B, 3, 3, device=dev)
    M[:, 0, 0], M[:, 0, 2] = s, -s * x1
    M[:, 1, 1], M[:, 1, 2] = sx, -sx * y1
    M[:, 2, 2] = 1.0
    patch = out / pts
    cs = torch.arange(pts, dtype=torch.float32, device=dev) * patch + patch / 2.0
    yy, xx = torch.meshgrid(cs, cs, indexing="ij")
    px = (xx + (s * x1)[:, None, None]) / s[:, None, None]
    py = (yy + (sx * y1)[:, None, None]) / sx[:, None, None]
    return {"real_rgb": rgb, "real_mask": m, "real_M": M, "real_pts2d": torch.stack([px, py], dim=-1)}


@torch.inference_mode()
def preprocess_frame_graphed(
    graphs: GraphCache,
    frame: torch.Tensor,
    masks: torch.Tensor,
    bboxes: torch.Tensor | None = None,
    use_bbox: torch.Tensor | None = None,
    out: int = 224,
    pts: int = 64,
    mask_rgb: bool = False,
) -> dict[str, torch.Tensor]:
    """``preprocess_frame`` as one program of ``graphs``, keyed on the
    frame's shape, the mask count, ``out``, ``pts`` and ``mask_rgb``."""
    program = lambda f, m, b, u: preprocess_frame(f, m, b, u, out=out, pts=pts, mask_rgb=mask_rgb)
    return graphs.run("preprocess_frame", program, (frame, masks, bboxes, use_bbox), static=(out, pts, mask_rgb))
