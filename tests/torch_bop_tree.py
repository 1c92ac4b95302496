"""A small BOP test tree written with PIL from seeded numpy images, for the
port's dataset and runner tests (tests/test_torch_bop.py,
tests/test_torch_eval_runner.py).

Two objects (1 and 3), each with ``n_views`` RGBA template views at
240 x 320 (an elliptical object of random texture, opaque inside, alpha
100 on its rim), 16-bit depth in mm and poses in mm; three frames in two
scenes (RGB, grey, RGB) at 240 x 320 into which template objects are
pasted.  The detections exercise the dataset's rules: compressed and
uncompressed RLE, a detection with an empty mask (the box is used), a
lower-scored detection past ``inst_count``, a zero score (dropped by the
score filter) and a frame whose detections carry another category (the
MegaPose backfill relabels them).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image
from test_torch_serve import rle_compressed, rle_uncompressed

H, W = 240, 320
OBJECTS = (1, 3)
# (scene, image, grey) of each frame
FRAMES = ((1, 0, False), (1, 2, True), (2, 4, False))


def _view(rng, H=H, W=W):
    """One template view: RGBA with an elliptical object, and its depth."""
    yy, xx = np.mgrid[:H, :W]
    cy, cx = rng.uniform(80, 160), rng.uniform(100, 220)
    ry, rx = rng.uniform(30, 60), rng.uniform(30, 60)
    r = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
    inside, rim = r <= 1.0, (r > 1.0) & (r <= 1.15)
    rgba = np.zeros((H, W, 4), np.uint8)
    rgba[..., :3] = rng.integers(0, 256, (H, W, 3)) * (inside | rim)[..., None]
    rgba[..., 3] = np.where(inside, 255, np.where(rim, 100, 0))
    depth = np.where(inside | rim, rng.integers(400, 700) + rng.integers(0, 20, (H, W)), 0).astype(np.uint16)
    return rgba, depth


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4)
    pose[:3, :3] = q * np.sign(np.linalg.det(q))
    pose[:3, 3] = [rng.normal(0, 20), rng.normal(0, 20), rng.uniform(400, 700)]  # mm
    return pose


def write_bop_tree(root: str, n_views: int = 6, seed: int = 0) -> dict:
    """Write the tree under ``root``; returns its paths."""
    rng = np.random.default_rng(seed)
    data_dir, tem_dir, det_dir = (os.path.join(root, d) for d in ("bop", "templates", "dets"))
    views = {}
    for obj in OBJECTS:
        odir = os.path.join(tem_dir, "fakeds", f"{obj:06d}")
        os.makedirs(odir)
        views[obj] = []
        for v in range(n_views):
            rgba, depth = _view(rng)
            Image.fromarray(rgba).save(os.path.join(odir, f"{v:06d}.png"))
            Image.fromarray(depth).save(os.path.join(odir, f"{v:06d}_depth.png"))
            views[obj].append(rgba)
        os.makedirs(os.path.join(tem_dir, "fakeds", "object_poses"), exist_ok=True)
        np.save(os.path.join(tem_dir, "fakeds", "object_poses", f"{obj:06d}.npy"),
                np.stack([_pose(rng) for _ in range(n_views)]))

    def paste(frame, obj, view, y0, x0):
        """Paste a view's object at (y0, x0); returns its mask in the frame."""
        rgba = views[obj][view]
        ys, xs = np.nonzero(rgba[..., 3] == 255)
        sub = (slice(ys.min(), ys.max() + 1), slice(xs.min(), xs.max() + 1))
        m = rgba[sub][..., 3] == 255
        h, w = m.shape
        frame[y0 : y0 + h, x0 : x0 + w][m] = rgba[sub][..., :3][m]
        mask = np.zeros((H, W), np.uint8)
        mask[y0 : y0 + h, x0 : x0 + w] = m
        return mask

    def det(scene, im, cat, mask, score, rle=rle_compressed, bbox=None):
        if bbox is None:
            ys, xs = np.nonzero(mask)
            bbox = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
        return {"scene_id": scene, "image_id": im, "category_id": cat, "bbox": bbox,
                "score": score, "time": 0.25 + 0.01 * im, "segmentation": rle(mask)}

    dets, targets = [], []
    for fi, (scene, im, grey) in enumerate(FRAMES):
        frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        sdir = os.path.join(data_dir, "fakeds", "test", f"{scene:06d}")
        os.makedirs(os.path.join(sdir, "rgb"), exist_ok=True)
        if fi == 0:
            # obj 1: three detections, the top two kept; obj 3: an empty
            # mask scored highest (its box is used) over a normal one
            masks = [paste(frame, 1, v, 10 + 100 * k, 20) for k, v in enumerate((2, 4))]
            m3 = paste(frame, 3, 1, 40, 180)
            dets += [det(scene, im, 1, masks[0], 0.9), det(scene, im, 1, masks[1], 0.8, rle_uncompressed),
                     det(scene, im, 1, masks[1], 0.3),
                     det(scene, im, 3, np.zeros((H, W), np.uint8), 0.75, bbox=[170, 30, 120, 120]),
                     det(scene, im, 3, m3, 0.7)]
            targets += [dict(scene_id=scene, im_id=im, obj_id=1, inst_count=2),
                        dict(scene_id=scene, im_id=im, obj_id=3, inst_count=1)]
        elif fi == 1:
            masks = [paste(frame, 3, v, 20 + 110 * k, 60 + 90 * k) for k, v in enumerate((0, 5))]
            dets += [det(scene, im, 3, masks[0], 0.6), det(scene, im, 3, masks[1], 0.55),
                     det(scene, im, 3, masks[1], 0.0)]
            targets += [dict(scene_id=scene, im_id=im, obj_id=3, inst_count=3)]
        else:
            # the detector labelled the object 5: the MegaPose backfill
            # relabels every detection of the frame as the target's object
            m1 = paste(frame, 1, 3, 60, 100)
            dets += [det(scene, im, 5, m1, 0.85)]
            targets += [dict(scene_id=scene, im_id=im, obj_id=1, inst_count=1)]
        img = frame.mean(-1).astype(np.uint8) if grey else frame
        Image.fromarray(img).save(os.path.join(sdir, "rgb", f"{im:06d}.png"))
        cam_path = os.path.join(sdir, "scene_camera.json")
        cams = json.load(open(cam_path)) if os.path.exists(cam_path) else {}
        cams[str(im)] = {"cam_K": [300.0 + 10 * fi, 0, 160.0, 0, 300.0, 120.0, 0, 0, 1]}
        json.dump(cams, open(cam_path, "w"))
    json.dump(targets, open(os.path.join(data_dir, "fakeds", "test_targets_bop19.json"), "w"))
    os.makedirs(det_dir)
    det_path = os.path.join(det_dir, "fakeds.json")
    json.dump(dets, open(det_path, "w"))
    return dict(data_dir=data_dir, template_dir=os.path.join(tem_dir, "fakeds"),
                template_root=tem_dir, det_dir=det_dir, det_path=det_path)
