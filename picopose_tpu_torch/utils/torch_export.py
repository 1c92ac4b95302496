"""The port's ``PicoPose`` -> a reference PyTorch checkpoint.

Counterpart of picopose_tpu/utils/torch_export.py (``export_picopose``
:164, ``save_torch_checkpoint`` :192): the weights become a state dict
keyed like the reference ``Net``, optionally wrapped as a Lightning
checkpoint (``{"state_dict": {"network.<k>": ...}}``), with the keys and
values the JAX exporter emits for the same weights.

The port's parameters already have the reference's layouts (utils/
weights.py turns flax kernels into torch ones: Dense (out, in), Conv OIHW,
ConvTranspose IOHW, each as the reference stores it), so exporting is
renaming, except for

  * the affine head's fc1, whose input rows the port keeps in NHWC flatten
    order and the reference in NCHW: permuted (8, 8, C) -> (C, 8, 8);
  * each BatchNorm's ``num_batches_tracked``, a torch buffer the port has
    no use for: emitted as 0.

Modules that exist in the reference but never run (DPT refinenet1 and the
output convs, refinenet4's first residual unit, the ViT's mask token and
final norm) are not emitted, as in the JAX exporter: the reference loads
the result with ``strict=False``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

# the port's module names -> the reference Net's, first match wins; ViT
# keys other than the patch embedding are the same in both
_RENAMES = tuple((re.compile(a), b) for a, b in (
    (r"^feature_extractor\.dinov2\.patch_embed\.", "feature_extractor.dinov2.patch_embed.proj."),
    (r"^affine_regressor\.conv0\.", "affine_regressor.features.0."),
    (r"^affine_regressor\.gn0\.", "affine_regressor.features.1."),
    (r"^affine_regressor\.conv1\.", "affine_regressor.features.3."),
    (r"^affine_regressor\.gn1\.", "affine_regressor.features.4."),
    (r"^dpt_head\.(layer\d_rn|refinenet\d)\.", r"offset_regressor.dpt_head.scratch.\1."),
    (r"^dpt_head\.resize_(\d)\.", r"offset_regressor.dpt_head.resize_layers.\1."),
    (r"^dpt_head\.", "offset_regressor.dpt_head."),
    (r"^flow_decoder\.proj_conv\.(\d+)\.", r"offset_regressor.flow_decoder.proj.\1.0."),
    (r"^flow_decoder\.proj_bn\.(\d+)\.", r"offset_regressor.flow_decoder.proj.\1.1."),
    (r"^flow_decoder\.encoder\.(\d+)\.(\w+)_(\d)\.", r"offset_regressor.flow_decoder.encoder.\1.\2.\3.conv."),
    (r"^flow_decoder\.(\w+)\.(\d+)\.layers_(\d)\.", r"offset_regressor.flow_decoder.\1.\2.layers.\3.conv."),
    (r"^flow_decoder\.(\w+)\.(\d+)\.predict\.", r"offset_regressor.flow_decoder.\1.\2.predict_layer."),
))


def _reference_key(key: str) -> str:
    for pattern, repl in _RENAMES:
        if pattern.match(key):
            return pattern.sub(repl, key, count=1)
    return key


def export_state_dict(state: dict) -> dict[str, np.ndarray]:
    """The port's ``PicoPose`` state dict -> reference ``Net`` state dict
    (fp32 numpy values; bf16-stored weights widen exactly)."""
    out: dict[str, np.ndarray] = {}
    C = state["affine_regressor.conv1.weight"].shape[0]
    for key, value in state.items():
        value = value.detach().float().cpu().numpy()
        ref = _reference_key(key)
        if key == "affine_regressor.fc1.weight":
            value = value.reshape(-1, 8, 8, C).transpose(0, 3, 1, 2).reshape(value.shape[0], -1)
        out[ref] = np.ascontiguousarray(value)
        if key.endswith(".running_var"):
            out[ref[: -len("running_var")] + "num_batches_tracked"] = np.array(0, np.int64)
    return out


def export_picopose(model: nn.Module) -> dict[str, np.ndarray]:
    """The port's ``PicoPose`` -> reference ``Net`` state dict."""
    return export_state_dict(model.state_dict())


def save_torch_checkpoint(model: nn.Module, path: str, lightning: bool = True) -> None:
    """Write ``model`` as a reference-loadable file: a Lightning ``.ckpt``
    (keys ``network.<k>`` under ``state_dict``) or, with
    ``lightning=False``, a raw ``Net`` state dict (``.pth``)."""
    sd = {k: torch.from_numpy(v) for k, v in export_picopose(model).items()}
    if lightning:
        sd = {"state_dict": {f"network.{k}": v for k, v in sd.items()}}
    torch.save(sd, path)
