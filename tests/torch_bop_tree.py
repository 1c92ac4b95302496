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

``write_megapose_tree`` writes a MegaPose-GSO training tree the same way
(shards of JPEG frames, a level-1 template bank), for the port's training
data and loop tests.
"""

from __future__ import annotations

import json
import os

import imageio.v2 as imageio
import numpy as np
from PIL import Image
from test_torch_serve import rle_compressed, rle_uncompressed

from picopose_tpu_torch.data.bop import TEMPLATES_K
from picopose_tpu_torch.data.synthetic import _texture, render_sphere
from picopose_tpu_torch.geom.templates import template_object_poses

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


MP_HW = (120, 160)  # training frames
MP_K = np.array([[200.0, 0.0, 80.0], [0.0, 200.0, 60.0], [0.0, 0.0, 1.0]])
SPHERE_RADIUS = 0.1  # meters
# template views: TEMPLATES_K puts the sphere 1 m away at (320, 240), so
# 320 x 400 pixels hold it
TEMPLATE_HW = (320, 400)


def _frame_pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4)
    pose[:3, :3] = q * np.sign(np.linalg.det(q))
    pose[:3, 3] = [rng.uniform(-0.12, 0.12), rng.uniform(-0.08, 0.08), rng.uniform(0.5, 0.8)]
    return pose


def write_megapose_tree(root: str, n_frames: int = 10, seed: int = 0) -> str:
    """A MegaPose-GSO tree under ``root``: ``n_frames`` 120 x 160 JPEG
    frames (q95 4:2:0, as tools/synthetic_world.py writes them with
    imageio) of one or two textured spheres of object 1 with their depth,
    masks, gt, gt_info and camera files; frame 1's instances are below the
    visibility threshold and frame 2 has no depth file (both invalid: the
    loader retries); and object 1's level-1 bank of 162 RGBA views with
    depth and poses at the GSO x10 scale.  Returns ``root``."""
    rng = np.random.default_rng(seed)
    shard = os.path.join(root, "MegaPose-GSO", "train_pbr_web", "shard-000000")
    os.makedirs(shard)
    H, W = MP_HW
    keys = {}
    for i in range(n_frames):
        poses = [_frame_pose(rng) for _ in range(1 + (i % 3 == 0))]
        renders = [render_sphere(MP_K, p, SPHERE_RADIUS, MP_HW) for p in poses]
        depth = np.full((H, W), np.inf)
        rgb = np.zeros((H, W, 3))
        for col, d, m in renders:
            front = (m > 0) & (d < depth)
            depth[front], rgb[front] = d[front], col[front]
        depth[np.isinf(depth)] = 0.0
        key = f"{i:08d}"
        keys[key] = 0
        base = os.path.join(shard, key)
        imageio.imwrite(base + ".rgb.jpg", (rgb * 255).astype(np.uint8), quality=95)
        if i != 2:
            imageio.imwrite(base + ".depth.png", np.round(depth * 1000.0).astype(np.uint16))  # mm
        masks, gt, gt_info = {}, [], []
        for j, (p, (_, d, m)) in enumerate(zip(poses, renders)):
            vis = (m > 0) & (d <= depth)
            masks[str(j)] = rle_uncompressed(vis.astype(np.uint8)) if j else rle_compressed(vis.astype(np.uint8))
            gt.append({"obj_id": 1, "cam_R_m2c": p[:3, :3].reshape(-1).tolist(),
                       "cam_t_m2c": (p[:3, 3] * 1000.0).tolist()})
            gt_info.append({"px_count_valid": int(vis.sum()),
                            "visib_fract": 0.1 if i == 1 else float(vis.sum() / max(m.sum(), 1))})
        for name, obj in (("mask_visib", masks), ("gt", gt), ("gt_info", gt_info),
                          ("camera", {"cam_K": MP_K.reshape(-1).tolist(), "depth_scale": 1.0})):
            with open(f"{base}.{name}.json", "w") as f:
                json.dump(obj, f)
    with open(os.path.join(root, "MegaPose-GSO", "train_pbr_web", "key_to_shard.json"), "w") as f:
        json.dump(keys, f)

    tdir = os.path.join(root, "MegaPose-Templates", "GSO")
    os.makedirs(os.path.join(tdir, "000001"))
    os.makedirs(os.path.join(tdir, "object_poses"))
    table = template_object_poses(1)  # mm
    np.save(os.path.join(tdir, "object_poses", "000001.npy"), table * np.array([1, 1, 1, 10.0])[None, None, :])
    # every view sees the sphere at the same place (the object 1 m ahead):
    # one hit map, textured per view
    first = table[0].copy()
    first[:3, 3] /= 1000.0
    _, depth, mask = render_sphere(TEMPLATES_K.astype(np.float64), first, SPHERE_RADIUS, TEMPLATE_HW)
    ys, xs = np.nonzero(mask)
    rays = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1) @ np.linalg.inv(TEMPLATES_K.astype(np.float64)).T
    p_cam = rays * depth[ys, xs, None]
    depth_png = os.path.join(tdir, "000001", "000000_depth.png")
    Image.fromarray(np.round(depth * 10000.0).astype(np.uint16)).save(depth_png)  # mm x 10
    depth_bytes = open(depth_png, "rb").read()
    for v, pose in enumerate(table):
        p_model = (p_cam - pose[:3, 3] / 1000.0) @ pose[:3, :3]
        rgba = np.zeros((*TEMPLATE_HW, 4), np.uint8)
        rgba[ys, xs, :3] = (_texture(p_model, SPHERE_RADIUS) * 255).astype(np.uint8)
        rgba[ys, xs, 3] = 255
        Image.fromarray(rgba).save(os.path.join(tdir, "000001", f"{v:06d}.png"), compress_level=1)
        if v:
            with open(os.path.join(tdir, "000001", f"{v:06d}_depth.png"), "wb") as f:
                f.write(depth_bytes)
    return root
