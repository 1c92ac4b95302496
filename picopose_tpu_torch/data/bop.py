"""BOP test-set loading: CNOS detections, crops, template banks.

The port's own copy of picopose_tpu/data/bop.py: ``TEMPLATES_K``,
``DETECTION_FILES``, ``BOP7``, ``Instance``, ``ImageRecord``,
``BOPTestDataset`` (:89-228: the top-``inst_count`` detections per target
with the MegaPose category backfill, ``seg_filter_score``, the mask-box
rules) and ``load_template_views`` (:230-278), on the same directory
layout:

  data_dir/<dataset>/test/<scene:06d>/{rgb,gray}/<img:06d>.{jpg,png,tif},
      scene_camera.json
  data_dir/<dataset>/test_targets_bop19.json
  template_dir/<obj:06d>/{view:06d}.png (RGBA), {view:06d}_depth.png (16-bit mm)
  template_dir/object_poses/<obj:06d>.npy   (mm -> m)

Images are decoded by data/png.py and data/jpeg.py instead of PIL, and
the template points' INTER_NEAREST resize is data/crops.py::nearest_index
instead of cv2's; the arrays are the same.  Frames are looked for as
``.jpg``, ``.png`` and ``.tif``, in that order, as the JAX package does; a
``.tif`` frame raises NotImplementedError: the port has no TIFF decoder
yet.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from picopose_tpu_torch.data.crops import (
    crop_and_normalize_rgb,
    crop_mask,
    crop_matrix,
    depth_to_points,
    grid_pts2d,
    mask_square_bbox,
    nearest_index,
    square_bbox,
)
from picopose_tpu_torch.data.jpeg import read_image
from picopose_tpu_torch.data.png import read_png
from picopose_tpu_torch.data.rle import rle_to_mask

TEMPLATES_K = np.array(
    [[572.4114, 0.0, 320.0], [0.0, 573.57043, 240.0], [0.0, 0.0, 1.0]],
    np.float32,
)  # fixed template intrinsics (bop_test_dataset.py:57-59, call_panda3d.py:48-54)

# CNOS-FastSAM bop23 task-4 default detection files (run_test.py:29-37)
DETECTION_FILES = {
    "itodd": "cnos-fastsam_itodd-test_df32d45b-301c-4fc9-8769-797904dd9325.json",
    "hb": "cnos-fastsam_hb-test_db836947-020a-45bd-8ec5-c95560b68011.json",
    "icbin": "cnos-fastsam_icbin-test_f21a9faf-7ef2-4325-885f-f4b6460f4432.json",
    "lmo": "cnos-fastsam_lmo-test_3cb298ea-e2eb-4713-ae9e-5a7134c5da0f.json",
    "tless": "cnos-fastsam_tless-test_8ca61cb0-4472-4f11-bce7-1362a12d396f.json",
    "ycbv": "cnos-fastsam_ycbv-test_f4f2127c-6f59-447c-95b3-28e1e591f1a1.json",
    "tudl": "cnos-fastsam_tudl-test_c48a2a95-1b41-4a51-9920-a667cb3d7149.json",
}
BOP7 = ("ycbv", "tudl", "lmo", "icbin", "tless", "itodd", "hb")


@dataclass
class Instance:
    obj_id: int
    score: float
    rgb: np.ndarray        # (S, S, 3) normalized
    mask: np.ndarray       # (S, S)
    M: np.ndarray          # (3, 3)
    K: np.ndarray          # (3, 3)
    pts2d: np.ndarray      # (64, 64, 2) original-image patch centers


@dataclass
class ImageRecord:
    scene_id: int
    img_id: int
    seg_time: float
    instances: list[Instance] = field(default_factory=list)


class BOPTestDataset:
    def __init__(
        self,
        data_dir: str,
        dataset: str,
        detection_path: str,
        img_size: int = 224,
        pts_size: int = 64,
        min_mask_px: int = 8,
        seg_filter_score: float = 0.0,
        n_template_view: int = 162,
        rgb_mask_flag: bool = False,
    ):
        self.data_dir = data_dir
        self.dataset = dataset
        self.img_size = img_size
        self.pts_size = pts_size
        self.min_mask_px = min_mask_px
        self.seg_filter_score = seg_filter_score
        self.n_template_view = n_template_view
        self.rgb_mask_flag = rgb_mask_flag
        self.test_dir = os.path.join(data_dir, dataset, "test")

        with open(detection_path) as f:
            dets = json.load(f)
        by_image: dict[str, list] = {}
        for det in dets:
            key = f"{det['scene_id']:06d}_{det['image_id']:06d}"
            by_image.setdefault(key, []).append(det)

        with open(
            os.path.join(data_dir, dataset, "test_targets_bop19.json")
        ) as f:
            targets = json.load(f)

        # top-inst_count detections per (scene, image, obj), with the
        # MegaPose category backfill (bop_test_dataset.py:84-107)
        self.images: dict[str, ImageRecord] = {}
        for tgt in targets:
            key = f"{tgt['scene_id']:06d}_{tgt['im_id']:06d}"
            dets_img = by_image.get(key, [])
            cand = [d for d in dets_img if d["category_id"] == tgt["obj_id"]]
            if not cand:
                cand = [dict(d, category_id=tgt["obj_id"]) for d in dets_img]
            cand.sort(key=lambda d: d["score"], reverse=True)
            rec = self.images.setdefault(
                key,
                ImageRecord(
                    scene_id=tgt["scene_id"],
                    img_id=tgt["im_id"],
                    seg_time=dets_img[0]["time"] if dets_img else 0.0,
                ),
            )
            rec.instances.extend(cand[: tgt["inst_count"]])  # raw dets for now

        self.keys = sorted(self.images.keys())
        # object ids present in the dataset's targets
        self.obj_ids = sorted({t["obj_id"] for t in targets})
        self.obj_idx = {o: i for i, o in enumerate(self.obj_ids)}

    def __len__(self) -> int:
        return len(self.keys)

    def _scene_camera(self, scene_id: int) -> dict:
        path = os.path.join(self.test_dir, f"{scene_id:06d}", "scene_camera.json")
        with open(path) as f:
            return json.load(f)

    def _rgb_path(self, scene_id: int, img_id: int) -> str:
        base = os.path.join(self.test_dir, f"{scene_id:06d}")
        for rel in (f"rgb/{img_id:06d}.jpg", f"rgb/{img_id:06d}.png",
                    f"gray/{img_id:06d}.tif"):
            p = os.path.join(base, rel)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no rgb for scene {scene_id} img {img_id}")

    def dets(self, index: int) -> list[dict]:
        """Metadata-only filtered detection list for one image (no decode).

        The score filter is decode-independent, so instance ORDER here is
        identical to load_image's — the eval runner uses this to group
        instances by object and assemble the CSV without decoding anything
        up-front.
        """
        raw = self.images[self.keys[index]]
        return [d for d in raw.instances if d["score"] > self.seg_filter_score]

    def image_meta(self, index: int) -> ImageRecord:
        """scene_id / img_id / seg_time without decoding pixels."""
        raw = self.images[self.keys[index]]
        return ImageRecord(raw.scene_id, raw.img_id, raw.seg_time)

    def load_raw(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """Decode one image's full RGB (uint8) + camera K.  PNG or JPEG: a
        TIFF frame raises NotImplementedError."""
        raw = self.images[self.keys[index]]
        cam = self._scene_camera(raw.scene_id)
        K = np.array(cam[str(raw.img_id)]["cam_K"], np.float64).reshape(3, 3)
        rgb = read_image(self._rgb_path(raw.scene_id, raw.img_id)).astype(np.uint8)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        return rgb, K

    def decode_instance(self, rgb: np.ndarray, K: np.ndarray, det: dict) -> Instance:
        """One detection -> model-ready crop (mask-bbox rules from
        bop_test_dataset.py:146-209)."""
        H, W = rgb.shape[:2]
        mask = rle_to_mask(det["segmentation"])
        if mask.sum() > self.min_mask_px:
            bbox = mask_square_bbox(mask)
        else:
            bx = det["bbox"]
            bbox = square_bbox(
                (bx[1], bx[1] + bx[3], bx[0], bx[0] + bx[2]), (H, W)
            )
        M = crop_matrix(bbox, self.img_size)
        return Instance(
            obj_id=det["category_id"],
            score=det["score"],
            rgb=crop_and_normalize_rgb(
                rgb, bbox, self.img_size, mask, self.rgb_mask_flag
            ),
            mask=crop_mask(mask, bbox, self.img_size),
            M=M,
            K=K.astype(np.float32),
            pts2d=grid_pts2d(M, self.img_size, self.pts_size),
        )

    def load_image(self, index: int) -> ImageRecord:
        """Decode one image's instances into model-ready crops."""
        rgb, K = self.load_raw(index)
        out = self.image_meta(index)
        for det in self.dets(index):
            out.instances.append(self.decode_instance(rgb, K, det))
        return out

    def __iter__(self):
        for i in range(len(self)):
            yield self.load_image(i)


def load_template_views(
    template_dir: str,
    obj_id: int,
    n_views: int = 162,
    img_size: int = 224,
    pts_size: int = 64,
    rgb_mask_flag: bool = False,
) -> dict[str, np.ndarray]:
    """Load one object's pre-rendered template views (the reference bank
    layout — bop_test_dataset.py:212-264): RGBA + 16-bit depth PNGs at
    640x480 with TEMPLATES_K, poses from object_poses/<obj>.npy (mm -> m)."""
    rgbs, masks, pts, poses, Ms = [], [], [], [], []
    pose_table = np.load(
        os.path.join(template_dir, "object_poses", f"{obj_id:06d}.npy")
    ).astype(np.float64)
    for v in range(n_views):
        rgba = read_png(os.path.join(template_dir, f"{obj_id:06d}", f"{v:06d}.png"))
        depth = read_png(os.path.join(template_dir, f"{obj_id:06d}", f"{v:06d}_depth.png")) / 1000.0
        mask = (rgba[..., 3] / 255.0).astype(np.float32)
        bbox = mask_square_bbox(mask)
        p3 = depth_to_points(depth.astype(np.float32), TEMPLATES_K, bbox)
        p3 = p3[nearest_index(p3.shape[0], pts_size)][:, nearest_index(p3.shape[1], pts_size)]

        rgbs.append(
            crop_and_normalize_rgb(rgba[..., :3], bbox, img_size, mask, rgb_mask_flag)
        )
        masks.append(crop_mask(mask, bbox, img_size))
        pts.append(p3)
        pose = pose_table[v].copy()
        pose[:3, 3] /= 1000.0
        poses.append(pose.astype(np.float32))
        Ms.append(crop_matrix(bbox, img_size))

    N = len(rgbs)
    return {
        "tem_rgb": np.stack(rgbs),
        "tem_mask": np.stack(masks),
        "tem_pts3d": np.stack(pts),
        "tem_pose": np.stack(poses),
        "tem_K": np.broadcast_to(TEMPLATES_K, (N, 3, 3)).copy(),
        "tem_M": np.stack(Ms),
    }
