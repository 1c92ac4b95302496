"""The serving entry point: a persistent pose estimator.

Counterpart of picopose_tpu/serve.py (``PoseResult`` :70, ``PoseEstimator``
:81): load the model once, register object template banks, then call
``estimate(rgb, K, detections)`` per frame.

    est = PoseEstimator("model.ckpt")   # or variables=flax_variables, or seeded weights
    est.register_object(1, "templates/ycbv")           # or register_bank(1, bank)
    poses = est.estimate(rgb, K, [{"obj_id": 1, "mask": mask}])  # or RLE / bbox
    poses[0].R, poses[0].t, poses[0].score

Detections are grouped per object bank and cut into chunks of
``max_batch``, the last one padded by repeating its last row, so every
batch has one shape.  Every chunk is queued on the device first; the
results of all of them come back to the host in one copy at the end.
Crops are cut on the host (data/crops.py) or, with ``device_preprocess``,
on the device from one uploaded frame and its masks (ops/preprocess.py).

On the card the estimator runs its compiled programs, CUDA graphs in one
``GraphCache`` (``self.graphs``, utils/graphs.py), as the JAX package's
entry point runs ``run_batch_jit``: ``estimate`` replays
``run_batch_graphed`` per chunk (and ``preprocess_frame_graphed`` with
``device_preprocess``), ``register_object`` the bank build's chunk
programs.  Each captures at its first call of a shape, after the weights
are loaded and precast; no entry point re-assigns them after
(``load_flax_variables`` copies in place), and a model whose parameters
were re-assigned is captured anew.

Bank files are the JAX package's: ``bank_<obj:06d>.npz`` with the fields
mask, pts3d, pose, K, M, feats_<i> and dpt_<i>, bf16 arrays stored as raw
uint16 under the structured dtype [("bf16", uint16)], so a bank written by
either package loads in the other.

Serving modes: bf16 weights are stored in bf16 (utils/precast.py) when
the compute dtype is bf16; ``quantize_stage3`` runs the stage-3 convs in
int8; PICOPOSE_MATCH_INT8=1 / PICOPOSE_MATCH_FP32=1 pick the matching
operands (ops/matching.py).  Not ported here: bank placement over
several devices.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import warnings
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from picopose_tpu_torch.data.bop import load_template_views
from picopose_tpu_torch.data.crops import (
    crop_and_normalize_rgb,
    crop_mask,
    crop_matrix,
    grid_pts2d,
    mask_square_bbox,
    square_bbox,
)
from picopose_tpu_torch.data.rle import rle_to_mask
from picopose_tpu_torch.device import full_fp32, resolve_device
from picopose_tpu_torch.eval.pipeline import TemplateBank, build_bank_graphed, run_batch_graphed
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS
from picopose_tpu_torch.ops.preprocess import preprocess_frame_graphed
from picopose_tpu_torch.utils.checkpoint import load_any
from picopose_tpu_torch.utils.graphs import GraphCache
from picopose_tpu_torch.utils.precast import precast_inference_params
from picopose_tpu_torch.utils.weights import init_random_, load_flax_variables

BF16_TAG = [("bf16", np.uint16)]  # numpy has no bfloat16: raw bits under this dtype
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def to_numpy_typed(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy, bf16 as raw uint16 bits under ``BF16_TAG``."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16).view(BF16_TAG)
    return x.numpy()


def from_numpy_typed(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The inverse of ``to_numpy_typed``, on ``device``."""
    if a.dtype.names == ("bf16",):
        raw = np.ascontiguousarray(a.view(np.uint16)).view(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class PoseResult:
    """Best-hypothesis pose for one detection (camera frame, meters)."""

    obj_id: int
    R: np.ndarray            # (3, 3)
    t: np.ndarray            # (3,)
    score: float             # PnP inlier ratio of the winning hypothesis
    success: bool            # PnP converged (else the stage-2 pose)
    template_score: float    # stage-1 matching score of the best match


class PoseEstimator:
    """Single-process estimator around ``run_batch_graphed`` on one device."""

    def __init__(
        self,
        checkpoint: str | None = None,
        variables: Mapping[str, Any] | None = None,
        vit_type: str = "dinov2_vitl14",
        blocks_to_take: Sequence[int] = (5, 11, 17, 23),
        compute_dtype: str | torch.dtype = "bfloat16",
        hyp: int = 5,
        n_template_view: int = 162,
        pnp_iters: int = 150,
        stage3_topk: int | None = None,
        quantize_stage3: bool = False,
        max_batch: int = 16,
        img_size: int = 224,
        pts_size: int = 64,
        min_mask_px: int = 8,
        rgb_mask_flag: bool = False,
        seed: int = 0,
        device: str | torch.device | None = None,
        device_preprocess: bool = False,
        generator: torch.Generator | None = None,
    ):
        """``checkpoint``: a reference PyTorch checkpoint (``.ckpt`` or
        ``.pth``) or a train state the port saved (utils/checkpoint.py);
        ``variables``, the JAX package's flax variables (``params`` and
        ``batch_stats`` as arrays), take precedence over it; with neither
        the weights are drawn from ``seed``, with a warning.  ``device``:
        the card unless "cpu" is passed (raises when no card is
        present).  ``generator``: the PnP draws' generator, on ``device``
        (by default one seeded with ``seed``)."""
        self.device = resolve_device(device)
        dtype = _DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype
        self.model = PicoPose(vit_type, blocks_to_take, dtype, device=self.device,
                              quantize_stage3=quantize_stage3)
        self.hyp, self.pnp_iters, self.n_template_view = hyp, pnp_iters, n_template_view
        self.stage3_topk, self.max_batch = stage3_topk, max_batch
        self.img_size, self.pts_size = img_size, pts_size
        self.min_mask_px, self.rgb_mask_flag = min_mask_px, rgb_mask_flag
        self.device_preprocess = device_preprocess
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.graphs = GraphCache(self.device)
        self._banks: dict[int, TemplateBank] = {}
        if variables is None and checkpoint is not None:
            variables = load_any(checkpoint, depth=VIT_CONFIGS[vit_type].depth)
        if variables is not None:
            load_flax_variables(self.model, variables)
        else:
            warnings.warn("PoseEstimator with RANDOM weights (no checkpoint)")
            init_random_(self.model, seed)
        if dtype == torch.bfloat16:
            precast_inference_params(self.model)  # bitwise-identical bf16 weight storage

    # ---- object registration ---------------------------------------------

    def register_object(self, obj_id: int, template_dir: str) -> None:
        """Build and cache an object's bank from its rendered views
        (<template_dir>/<obj:06d>/*.png and object_poses/<obj:06d>.npy,
        data/bop.py::load_template_views)."""
        tem = load_template_views(
            template_dir, obj_id, self.n_template_view,
            self.img_size, self.pts_size, self.rgb_mask_flag,
        )
        self._banks[obj_id] = build_bank_graphed(
            self.graphs, self.model, tem["tem_rgb"], tem["tem_mask"], tem["tem_pts3d"],
            tem["tem_pose"], tem["tem_K"], tem["tem_M"],
        )

    def register_bank(self, obj_id: int, bank: TemplateBank) -> None:
        """Cache a prebuilt TemplateBank (eval/pipeline.py::build_bank) on
        the estimator's device."""
        move = lambda x: None if x is None else torch.as_tensor(x, device=self.device)
        self._banks[obj_id] = TemplateBank(
            feats=tuple(move(f) for f in bank.feats), mask=move(bank.mask),
            pts3d=move(bank.pts3d), pose=move(bank.pose), K=move(bank.K), M=move(bank.M),
            dpt=None if bank.dpt is None else tuple(move(d) for d in bank.dpt),
        )

    @property
    def objects(self) -> list[int]:
        return sorted(self._banks)

    # ---- bank persistence (skip the ViT pass over the views on restart) ---

    def save_banks(self, directory: str) -> None:
        """Write every registered bank as <directory>/bank_<obj:06d>.npz.
        Banks depend on the weights they were built with."""
        os.makedirs(directory, exist_ok=True)
        for obj_id, bank in self._banks.items():
            arrs = {f: to_numpy_typed(getattr(bank, f)) for f in ("mask", "pts3d", "pose", "K", "M")}
            arrs.update({f"feats_{i}": to_numpy_typed(f) for i, f in enumerate(bank.feats)})
            if bank.dpt is not None:
                arrs.update({f"dpt_{i}": to_numpy_typed(d) for i, d in enumerate(bank.dpt)})
            np.savez(os.path.join(directory, f"bank_{obj_id:06d}.npz"), **arrs)

    def load_banks(self, directory: str) -> list[int]:
        """Register every bank_<obj>.npz in ``directory``; returns the ids."""
        loaded = []
        for path in sorted(glob.glob(os.path.join(directory, "bank_*.npz"))):
            m = re.search(r"bank_(\d+)\.npz$", path)
            if not m:
                continue
            with np.load(path) as z:
                arr = lambda k: from_numpy_typed(z[k], self.device)
                n_feats = sum(1 for k in z.files if k.startswith("feats_"))
                n_dpt = sum(1 for k in z.files if k.startswith("dpt_"))
                bank = TemplateBank(
                    feats=tuple(arr(f"feats_{i}") for i in range(n_feats)),
                    mask=arr("mask"), pts3d=arr("pts3d"), pose=arr("pose"), K=arr("K"), M=arr("M"),
                    dpt=tuple(arr(f"dpt_{i}") for i in range(n_dpt)) if n_dpt else None,
                )
            self._banks[int(m.group(1))] = bank
            loaded.append(int(m.group(1)))
        return loaded

    # ---- inference -----------------------------------------------------------

    def _mask_of(self, det: Mapping[str, Any]) -> np.ndarray | None:
        mask = det.get("mask")
        if mask is None and "segmentation" in det:
            mask = rle_to_mask(det["segmentation"])
        return mask

    def _decode(self, rgb: np.ndarray, K: np.ndarray, det: Mapping[str, Any]) -> dict:
        """One detection -> its model-ready crop on the host: the square box
        of the mask when it has more than ``min_mask_px`` pixels, else of
        the detector box (xywh), whose filled square stands in for a missing
        mask."""
        H, W = rgb.shape[:2]
        mask = self._mask_of(det)
        if mask is not None and mask.sum() > self.min_mask_px:
            bbox = mask_square_bbox(mask.astype(np.uint8))
        else:
            if "bbox" not in det:
                raise ValueError("detection needs a usable 'mask'/'segmentation' or 'bbox'")
            bx = det["bbox"]
            bbox = square_bbox((bx[1], bx[1] + bx[3], bx[0], bx[0] + bx[2]), (H, W))
            if mask is None:
                mask = np.zeros((H, W), np.uint8)
                mask[bbox[0]:bbox[1], bbox[2]:bbox[3]] = 1
        M = crop_matrix(bbox, self.img_size)
        return {
            "rgb": crop_and_normalize_rgb(rgb, bbox, self.img_size, mask, self.rgb_mask_flag),
            "mask": crop_mask(mask, bbox, self.img_size),
            "M": M,
            "K": K.astype(np.float32),
            "pts2d": grid_pts2d(M, self.img_size, self.pts_size),
        }

    def _decode_mask(self, H: int, W: int, det: Mapping[str, Any]):
        """Detection -> (mask, raw (y1, y2, x1, x2) box, use the box) for
        the on-device crops, by ``_decode``'s rules."""
        mask = self._mask_of(det)
        if mask is not None and mask.sum() > self.min_mask_px:
            return mask.astype(np.uint8), (0, 0, 0, 0), False
        if "bbox" not in det:
            raise ValueError("detection needs a usable 'mask'/'segmentation' or 'bbox'")
        bx = det["bbox"]
        raw = (bx[1], bx[1] + bx[3], bx[0], bx[0] + bx[2])
        if mask is None:
            sq = square_bbox(raw, (H, W))
            mask = np.zeros((H, W), np.uint8)
            mask[sq[0]:sq[1], sq[2]:sq[3]] = 1
        return mask.astype(np.uint8), raw, True

    def _host_batch(self, rgb, K, dets, pad: int) -> dict:
        insts = [self._decode(rgb, K, d) for d in dets]
        batch = {}
        for name in ("rgb", "mask", "M", "K", "pts2d"):
            arr = np.stack([inst[name] for inst in insts])
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            batch[f"real_{name}"] = torch.from_numpy(arr).to(self.device)
        return batch

    def _device_batch(self, rgb, K, dets, pad: int) -> dict:
        """The chunk's batch from ops/preprocess.py: one frame and its masks
        go to the device; only RLE decoding stays on the host."""
        H, W = rgb.shape[:2]
        trip = [self._decode_mask(H, W, d) for d in dets]
        masks = np.stack([t[0] for t in trip])
        bboxes = np.asarray([t[1] for t in trip], np.int64)
        use_bbox = np.asarray([t[2] for t in trip], bool)
        if pad:
            masks = np.concatenate([masks, np.repeat(masks[-1:], pad, 0)])
            bboxes = np.concatenate([bboxes, np.repeat(bboxes[-1:], pad, 0)])
            use_bbox = np.concatenate([use_bbox, np.repeat(use_bbox[-1:], pad, 0)])
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        batch = preprocess_frame_graphed(
            self.graphs, put(rgb), put(masks), bboxes=put(bboxes), use_bbox=put(use_bbox),
            out=self.img_size, pts=self.pts_size, mask_rgb=self.rgb_mask_flag,
        )
        batch["real_K"] = put(np.repeat(K.astype(np.float32)[None], len(dets) + pad, 0))
        return batch

    @torch.inference_mode()
    @full_fp32()
    def estimate(
        self, rgb: np.ndarray, K: np.ndarray, detections: Sequence[Mapping[str, Any]]
    ) -> list[PoseResult]:
        """A pose per detection on one (H, W, 3) uint8 RGB frame.

        Each detection: {"obj_id": int (or "category_id"), "mask": (H, W)
        binary | "segmentation": RLE dict | "bbox": xywh}.  Returns the
        results in input order."""
        rgb = np.ascontiguousarray(rgb)
        per_obj: dict[int, list[int]] = {}
        for i, det in enumerate(detections):
            obj = int(det.get("obj_id", det.get("category_id", -1)))
            if obj not in self._banks:
                raise KeyError(f"object {obj} not registered (have {self.objects})")
            per_obj.setdefault(obj, []).append(i)

        # queue every chunk on the device, then fetch all results at once
        chunks, packed = [], []
        for obj, idxs in per_obj.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s : s + self.max_batch]
                pad = self.max_batch - len(chunk)
                dets = [detections[i] for i in chunk]
                if self.device_preprocess:
                    batch = self._device_batch(rgb, K, dets, pad)
                else:
                    batch = self._host_batch(rgb, K, dets, pad)
                out = run_batch_graphed(self.graphs, self.model, batch, self._banks[obj], hyp=self.hyp,
                                        pnp_iters=self.pnp_iters, stage3_topk=self.stage3_topk,
                                        generator=self.generator)
                n = len(chunk)
                packed.append(torch.cat([
                    out.R[:n, 0].reshape(n, 9), out.t[:n, 0], out.inlier_ratio[:n, :1],
                    out.pnp_success[:n, :1].float(), out.template_score[:n, :1],
                ], dim=1))
                chunks.append((obj, chunk))
        if not packed:
            return []
        host = torch.cat(packed).cpu().numpy()
        results: list[PoseResult | None] = [None] * len(detections)
        row = 0
        for obj, chunk in chunks:
            for i in chunk:
                r = host[row]
                results[i] = PoseResult(
                    obj_id=obj, R=r[:9].reshape(3, 3).copy(), t=r[9:12].copy(), score=float(r[12]),
                    success=bool(r[13] > 0.5), template_score=float(r[14]),
                )
                row += 1
        return results  # type: ignore[return-value]
