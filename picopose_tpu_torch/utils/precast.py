"""Store the bf16-consumed inference weights in bf16 (serving mode).

Counterpart of picopose_tpu/utils/precast.py::precast_inference_params
(:61), applied in place to the port's ``PicoPose`` module.  The port's
layers keep fp32 parameters and cast them to the input's dtype at each op
(models/layers.py), so a bf16 model launches one fp32 -> bf16 cast per
weight per call: ~1829 of them in a 162-view bank build.  Storing those
weights in bf16 ahead of time removes the casts and leaves every output
**bitwise identical**, because each is rounded to bf16 at use anyway:

  * inside ``feature_extractor``, ``dpt_head`` and ``flow_decoder``: the
    weight and bias of every Linear / Conv2d / ConvTranspose2d, the
    LayerScale ``gamma`` and the ``cls_token``.

Kept fp32 (consumed in fp32 arithmetic, so casting would change results):

  * ``pos_embed`` (interpolated by fp32 products);
  * every LayerNorm / GroupNorm / BatchNorm parameter and buffer;
  * the whole ``affine_regressor`` (stage 2 runs in fp32).

For inference only: training keeps fp32 parameters for the optimizer.
"""

from __future__ import annotations

import torch
from torch import nn

from picopose_tpu_torch.models.dinov2 import DinoViT, LayerScale

BF16_SUBMODULES = ("feature_extractor", "dpt_head", "flow_decoder")
_CAST_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


@torch.no_grad()
def precast_inference_params(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Store ``model``'s bf16-consumed weights as ``dtype``, in place, and
    return the model.  Apply only when its compute dtype is ``dtype``."""
    for sub in BF16_SUBMODULES:
        for module in getattr(model, sub).modules():
            if isinstance(module, _CAST_LAYERS):
                names = ("weight", "bias")
            elif isinstance(module, LayerScale):
                names = ("gamma",)
            elif isinstance(module, DinoViT):
                names = ("cls_token",)
            else:
                continue
            for name in names:
                p = getattr(module, name)
                if p is not None and p.dtype == torch.float32:
                    p.data = p.data.to(dtype)
    return model
