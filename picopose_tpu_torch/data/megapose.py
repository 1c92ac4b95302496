"""MegaPose training shards: the training dataset and its collation.

The port's own copy of picopose_tpu/data/megapose.py
(``MegaPoseTrainingDataset`` and ``collate``, :46-284) on the port's
data/{rle,crops,png,jpeg,color_augment}.py, ``TEMPLATES_K`` and
geom/templates.py, with the same on-disk contract
(provider/training_dataset.py):

  data_dir/MegaPose-{GSO,ShapeNetCore}/train_pbr_web/
      key_to_shard.json,
      shard-XXXXXX/<key>.{rgb.jpg, depth.png, camera.json, gt.json,
                          gt_info.json, mask_visib.json}
  data_dir/MegaPose-Templates/{GSO,ShapeNetCore}/<obj:06d>/... + object_poses/

Per sample: one valid instance (visib_fract >= 0.3, px >= 1024), square
crop to 224, BGR flip + CLIP normalisation, colour augmentation with p 0.8;
the template a random pick among the 5 nearest level-1 views by OpenGL
z-axis distance; template depth and pose scaled by 0.1 / 1000 (GSO banks
store x10 millimetres).  ``reset()`` resamples the epoch.  Every draw
(instance, augmentation, template view, retry) comes from ``self.rng`` in
the JAX package's order, so one seed gives the same samples in both.

Importing this module touches no device: worker processes of the training
loop import it.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np

from picopose_tpu_torch.data.bop import TEMPLATES_K
from picopose_tpu_torch.data.color_augment import augment_color
from picopose_tpu_torch.data.crops import crop_and_normalize_rgb, crop_mask, crop_matrix, mask_square_bbox
from picopose_tpu_torch.data.jpeg import read_image
from picopose_tpu_torch.data.rle import rle_to_mask
from picopose_tpu_torch.geom.templates import template_object_poses

_SUFFIXES = (".camera.json", ".depth.png", ".gt_info.json", ".gt.json",
             ".mask_visib.json", ".rgb.jpg")


class MegaPoseTrainingDataset:
    def __init__(
        self,
        data_dir: str,
        img_size: int = 224,
        min_visib_fract: float = 0.3,
        min_px_count_visib: int = 1024,
        augment_real: bool = True,
        rgb_mask_flag: bool = False,
        num_img_per_epoch: int = -1,
        pose_table: np.ndarray | None = None,
        seed: int = 0,
        cache_templates: int = 64,
    ):
        self.data_dir = data_dir
        self.img_size = img_size
        self.min_visib_fract = min_visib_fract
        self.min_px = min_px_count_visib
        self.augment_real = augment_real
        self.rgb_mask_flag = rgb_mask_flag
        self.num_img_per_epoch = num_img_per_epoch
        self.rng = np.random.default_rng(seed)
        # LRU over processed template samples: templates repeat heavily
        # within an epoch (one bank of 162 views per object, 5-nearest pick),
        # and the processed result is deterministic per (source, obj, view) —
        # caching skips 2 png decodes + crop per hit.  0 disables.
        self._tem_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._tem_cache_cap = int(cache_templates)
        self._pose_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

        self.data_paths = [
            os.path.join("MegaPose-GSO", "train_pbr_web"),
            os.path.join("MegaPose-ShapeNetCore", "train_pbr_web"),
        ]
        self.template_paths = [
            os.path.join(data_dir, "MegaPose-Templates", "GSO"),
            os.path.join(data_dir, "MegaPose-Templates", "ShapeNetCore"),
        ]
        # nearest-template search table: level-1 (162 views) OpenGL z-axes.
        # Pass pose_table to match banks rendered by the reference toolchain
        # (their view ORDER is Blender-specific — geom/templates.py).
        table = (
            pose_table if pose_table is not None else template_object_poses(1)
        )
        gl = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]]) @ table[:, :3, :3]
        self.template_z = gl[:, 2, :3]

        self.samples: list[tuple[int, str]] = []  # (source_idx, path_head)
        for si, rel in enumerate(self.data_paths):
            key_file = os.path.join(data_dir, rel, "key_to_shard.json")
            if not os.path.exists(key_file):
                continue
            with open(key_file) as f:
                key_shards = json.load(f)
            for k, shard in key_shards.items():
                self.samples.append(
                    (si, os.path.join(rel, f"shard-{shard:06d}", k))
                )
        self.epoch_idx = np.arange(len(self.samples))
        self.reset()

    def __len__(self) -> int:
        if self.num_img_per_epoch == -1:
            return len(self.samples)
        return self.num_img_per_epoch

    def reset(self) -> None:
        """Resample this epoch's subset (training_dataset.py:125-135)."""
        n = len(self.samples)
        want = len(self)
        replace = n < want
        self.epoch_idx = self.rng.choice(n, size=want, replace=replace)

    def get(self, index: int) -> dict[str, np.ndarray] | None:
        for _ in range(64):  # invalid-sample retry (training_dataset.py:126-135)
            out = self._read(self.epoch_idx[index % len(self.epoch_idx)])
            if out is not None:
                return out
            index = int(self.rng.integers(len(self.epoch_idx)))
        return None

    # ------------------------------------------------------------------ internals
    def _read(self, sample_idx: int) -> dict | None:
        si, head = self.samples[sample_idx]
        full = os.path.join(self.data_dir, head)
        if not all(os.path.exists(full + s) for s in _SUFFIXES):
            return None
        real = self._process_real(full)
        if real is None:
            return None
        view_id = self._sample_template_view(real["real_pose"][:3, :3])
        tem = self._process_template(si, real.pop("obj_id"), view_id)
        if tem is None:
            return None
        real.update(tem)
        return real

    def _process_real(self, full: str) -> dict | None:
        with open(full + ".gt_info.json") as f:
            gt_info = json.load(f)
        valid = [
            k for k, it in enumerate(gt_info)
            if it.get("px_count_valid", 0) >= self.min_px
            and it.get("visib_fract", 0) >= self.min_visib_fract
        ]
        if not valid:
            return None
        k = int(self.rng.choice(valid))

        with open(full + ".gt.json") as f:
            gt = json.load(f)[k]
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.array(gt["cam_R_m2c"], np.float64).reshape(3, 3)
        pose[:3, 3] = np.array(gt["cam_t_m2c"], np.float64).reshape(3) / 1000.0

        with open(full + ".camera.json") as f:
            camera = json.load(f)
        K = np.array(camera["cam_K"], np.float64).reshape(3, 3).astype(np.float32)

        with open(full + ".mask_visib.json") as f:
            rles = {int(i): v for i, v in json.load(f).items()}
        mask = rle_to_mask(rles[k]) if k in rles else None
        if mask is None or mask.sum() == 0:
            return None

        bbox = mask_square_bbox(mask)
        y1, y2, x1, x2 = bbox
        if (mask[y1:y2, x1:x2] > 0).sum() < 32:
            return None

        rgb = read_image(full + ".rgb.jpg").astype(np.uint8)
        if self.augment_real and self.rng.random() < 0.8:
            # reference augments the BGR-flipped crop region pre-resize
            # (training_dataset.py:216-218); we augment the full image's
            # crop equivalently
            aug = augment_color(self.rng, rgb[y1:y2, x1:x2][..., ::-1])
            rgb = rgb.copy()
            rgb[y1:y2, x1:x2] = aug[..., ::-1]

        depth = read_image(full + ".depth.png").astype(np.float32)
        depth = depth * camera["depth_scale"] / 1000.0

        return {
            "real_rgb": crop_and_normalize_rgb(
                rgb, bbox, self.img_size, mask, self.rgb_mask_flag
            ),
            "real_mask": crop_mask(mask, bbox, self.img_size),
            "real_M": crop_matrix(bbox, self.img_size),
            "real_K": K,
            "real_pose": pose,
            "real_full_depth": depth,
            "obj_id": int(gt["obj_id"]),
        }

    def _process_template(self, si: int, obj_id: int, view_id: int) -> dict | None:
        key = (si, obj_id, view_id)
        if self._tem_cache_cap > 0:
            hit = self._tem_cache.get(key)
            if hit is not None:
                self._tem_cache.move_to_end(key)
                # consumers (collate) only stack; a shallow copy keeps the
                # dict itself private without duplicating the arrays
                return dict(hit)
        out = self._load_template(si, obj_id, view_id)
        if out is not None and self._tem_cache_cap > 0:
            self._tem_cache[key] = out
            if len(self._tem_cache) > self._tem_cache_cap:
                self._tem_cache.popitem(last=False)
            return dict(out)
        return out

    def _template_poses(self, si: int, obj_id: int) -> np.ndarray:
        key = (si, obj_id)
        hit = self._pose_cache.get(key)
        if hit is None:
            hit = np.load(
                os.path.join(
                    self.template_paths[si], "object_poses", f"{obj_id:06d}.npy"
                )
            )
            self._pose_cache[key] = hit
            if len(self._pose_cache) > 256:
                self._pose_cache.popitem(last=False)
        else:
            self._pose_cache.move_to_end(key)
        return hit

    def _load_template(self, si: int, obj_id: int, view_id: int) -> dict | None:
        tdir = self.template_paths[si]
        img_path = os.path.join(tdir, f"{obj_id:06d}", f"{view_id:06d}.png")
        depth_path = os.path.join(tdir, f"{obj_id:06d}", f"{view_id:06d}_depth.png")
        if not (os.path.exists(img_path) and os.path.exists(depth_path)):
            return None
        rgba = read_image(img_path)
        mask = (rgba[..., 3] / 255.0).astype(np.float32)
        if mask.sum() == 0:
            return None
        bbox = mask_square_bbox(mask)

        depth = read_image(depth_path).astype(np.float32) * 0.1 / 1000.0
        pose = self._template_poses(si, obj_id)[view_id].astype(np.float32).copy()
        pose[:3, 3] *= 0.1 / 1000.0

        return {
            "tem_rgb": crop_and_normalize_rgb(
                rgba[..., :3].astype(np.uint8), bbox, self.img_size, mask,
                self.rgb_mask_flag,
            ),
            "tem_mask": crop_mask(mask, bbox, self.img_size),
            "tem_M": crop_matrix(bbox, self.img_size),
            "tem_K": TEMPLATES_K.copy(),
            "tem_pose": pose,
            "tem_full_depth": depth,
        }

    def _sample_template_view(self, R: np.ndarray, topk: int = 5) -> int:
        """Random pick among the 5 nearest views by OpenGL z-axis distance
        (training_dataset.py:320-332)."""
        gl = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]]) @ R
        z = gl[2, :3]
        d = np.linalg.norm(z - self.template_z, axis=1)
        return int(self.rng.choice(np.argsort(d)[:topk]))


def collate(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack a list of samples; depth maps may differ in size across sources
    so they are center-padded to the max (static per batch)."""
    out = {}
    for key in samples[0]:
        arrs = [s[key] for s in samples]
        if key.endswith("full_depth"):
            H = max(a.shape[0] for a in arrs)
            W = max(a.shape[1] for a in arrs)
            arrs = [
                np.pad(a, ((0, H - a.shape[0]), (0, W - a.shape[1])))
                for a in arrs
            ]
        out[key] = np.stack(arrs)
    return out
