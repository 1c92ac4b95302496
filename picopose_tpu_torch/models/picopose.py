"""PicoPose's neural stages: ViT taps, stage 2, the DPT pyramids and the
stage-3 flow decoder.

Counterpart of picopose_tpu/models/picopose.py: ``features`` (stage-1 ViT
taps), ``stage2`` (similarity volume + affine head, fp32), ``dpt``
(template/query pyramids), ``flow`` and ``stage3`` (flow decoding, fp32
flows and certainties out).  Geometry, matching and PnP are plain
functions composed around the model by eval/pipeline.py.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from picopose_tpu_torch.device import full_fp32, resolve_device
from picopose_tpu_torch.models.affine_head import AffineRegressor
from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS, FeatureExtractor
from picopose_tpu_torch.models.dpt import DPT_LEVELS, DPTHead
from picopose_tpu_torch.models.flow import FlowDecoder
from picopose_tpu_torch.ops.matching import feature_similarity_volume

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_kwargs(cfg) -> dict:
    """``PicoPose``'s arguments from ``cfg.model`` that both entry points
    pass, as the JAX package's run_test.py:65-74 and run_train.py:51-60
    build its model: the ViT, its taps, the compute dtype, the flow
    decoder's ``num_levels`` and ``radius``, and ``fuse_xheads``.  The
    eval entry point adds ``quantize_stage3``, the training one
    ``remat_vit``."""
    m = cfg.model
    return dict(
        vit_type=m.vit_type, blocks_to_take=tuple(m.blocks_to_take),
        compute_dtype=COMPUTE_DTYPES[m.compute_dtype], num_levels=m.num_levels, radius=m.radius,
        fuse_xheads=m.fuse_xheads,
    )


class PicoPose(nn.Module):
    """Parameters are allocated on ``device`` (CUDA unless "cpu" is passed;
    raises if no card is present) and kept in fp32 (``utils/precast.py``
    stores the bf16-consumed ones in bf16 for serving); activations run in
    ``compute_dtype`` except stage 2, which is fp32.  Every method runs
    under ``full_fp32``: the fp32 work in it (stage 2, the positional
    embedding's interpolation, the fp32 flows; everything when
    ``compute_dtype`` is fp32) takes no TF32, whatever the process flags.
    ``num_levels`` and ``radius`` shape the flow decoder (its levels, at
    most the DPT pyramid's 3, and the config radius: each lookup has radius
    ``radius // 2``), as in picopose_tpu/models/picopose.py:34-35,55-58.
    ``quantize_stage3``
    (int8 stage-3 convs, ops/qconv.py) and ``fuse_xheads`` select the flow
    decoder's path over the same parameters (picopose_tpu/models/
    picopose.py:42-57); ``remat_vit`` recomputes the ViT blocks'
    activations in the backward (a training memory saver).

    The module starts in ``.eval()``.  In ``.train()`` its BatchNorms (DPT
    head, flow decoder) normalise with batch statistics and update their
    running ones, as the JAX methods' ``train=True`` does; the ViT and
    stage 2 have no BatchNorm.  The inference pipeline refuses a module in
    train mode."""

    def __init__(
        self,
        vit_type: str = "dinov2_vitl14",
        blocks_to_take: Sequence[int] = (5, 11, 17, 23),
        compute_dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
        num_levels: int = 3,
        radius: int = 4,
        quantize_stage3: bool = False,
        fuse_xheads: bool = True,
        remat_vit: bool = False,
    ):
        super().__init__()
        if num_levels > DPT_LEVELS:
            raise ValueError(f"num_levels {num_levels}: the DPT head gives the flow decoder {DPT_LEVELS} levels")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        cfg = VIT_CONFIGS[vit_type]
        with self.device:
            self.feature_extractor = FeatureExtractor(vit_type, blocks_to_take, compute_dtype, remat_vit)
            self.affine_regressor = AffineRegressor()
            self.dpt_head = DPTHead(in_channels=cfg.embed_dim)
            self.flow_decoder = FlowDecoder(num_levels, radius, quantize_stage3, fuse_xheads)
        self.eval()

    @full_fp32()
    def features(self, images: torch.Tensor) -> list[torch.Tensor]:
        """(B, 224, 224, 3) normalised crops -> 4 x (B, 16, 16, C) taps."""
        return self.feature_extractor(images)

    @full_fp32()
    def stage2(self, tem_last: torch.Tensor, real_last: torch.Tensor, tem_mask: torch.Tensor):
        """(translation (B, 2), scale (B,), inplane cos/sin (B, 2))."""
        sim = feature_similarity_volume(tem_last.float(), real_last.float(), tem_mask)
        return self.affine_regressor(sim)

    @full_fp32()
    def dpt(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        """DPT pyramid of a 4-level backbone stack, in the compute dtype."""
        return self.dpt_head([x.to(self.compute_dtype) for x in feats])

    @full_fp32()
    def flow(self, tem_pyr, real_pyr, init_flow: torch.Tensor, init_certainty: torch.Tensor):
        """Flow decoding over DPT pyramids (the query side may be shared by
        consecutive template streams, see FlowDecoder); pyramids in the
        compute dtype, flow and certainty in and out in fp32."""
        flows, certs = self.flow_decoder(
            [x.to(self.compute_dtype) for x in tem_pyr],
            [x.to(self.compute_dtype) for x in real_pyr],
            init_flow.float(), init_certainty.float(),
        )
        return [f.float() for f in flows], [c.float() for c in certs]

    @full_fp32()
    def stage3(self, tem_feats, real_feats, init_flow, init_certainty):
        """DPT on both backbone stacks, then flow decoding."""
        return self.flow(self.dpt(tem_feats), self.dpt(real_feats), init_flow, init_certainty)
