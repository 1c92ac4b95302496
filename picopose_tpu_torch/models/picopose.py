"""PicoPose's neural stages 1-2 and the DPT pyramid head.

Counterpart of picopose_tpu/models/picopose.py: ``features`` (stage-1 ViT
taps), ``stage2`` (similarity volume + affine head, fp32) and ``dpt``
(template/query pyramids).  Geometry and matching are plain functions
composed around the model by eval/pipeline.py.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from picopose_tpu_torch.device import resolve_device
from picopose_tpu_torch.models.affine_head import AffineRegressor
from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS, FeatureExtractor
from picopose_tpu_torch.models.dpt import DPTHead
from picopose_tpu_torch.ops.matching import feature_similarity_volume


class PicoPose(nn.Module):
    """Parameters are allocated on ``device`` (CUDA unless "cpu" is passed;
    raises if no card is present) and kept in fp32; activations run in
    ``compute_dtype`` except stage 2, which is fp32."""

    def __init__(
        self,
        vit_type: str = "dinov2_vitl14",
        blocks_to_take: Sequence[int] = (5, 11, 17, 23),
        compute_dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        cfg = VIT_CONFIGS[vit_type]
        with self.device:
            self.feature_extractor = FeatureExtractor(vit_type, blocks_to_take, compute_dtype)
            self.affine_regressor = AffineRegressor()
            self.dpt_head = DPTHead(in_channels=cfg.embed_dim)
        self.eval()

    def features(self, images: torch.Tensor) -> list[torch.Tensor]:
        """(B, 224, 224, 3) normalised crops -> 4 x (B, 16, 16, C) taps."""
        return self.feature_extractor(images)

    def stage2(self, tem_last: torch.Tensor, real_last: torch.Tensor, tem_mask: torch.Tensor):
        """(translation (B, 2), scale (B,), inplane cos/sin (B, 2))."""
        sim = feature_similarity_volume(tem_last.float(), real_last.float(), tem_mask)
        return self.affine_regressor(sim)

    def dpt(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        """DPT pyramid of a 4-level backbone stack, in the compute dtype."""
        return self.dpt_head([x.to(self.compute_dtype) for x in feats])
