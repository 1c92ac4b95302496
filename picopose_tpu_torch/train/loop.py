"""Warm starts: a training state's weights from a checkpoint file.

Counterpart of the weight part of picopose_tpu/train/loop.py (``_graft_tree``
and ``warm_start``, :195-298).  The reference's two pretrained entry points:

  * a full PicoPose checkpoint (the reference's Lightning ``.ckpt`` or raw
    ``Net`` state dict ``.pth``) fills every parameter and BatchNorm
    statistic;
  * torch-hub DINOv2 backbone weights (``.pth``), the reference's
    ``pretrained: True``, fill the ViT only; every other parameter keeps
    its fresh init.

The step counter and the optimizer stay as they are; a layout or shape
mismatch (e.g. a checkpoint of another ``vit_type``) raises.  Orbax
directories raise as ``utils/checkpoint.py::load_any`` does.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from picopose_tpu_torch.utils.checkpoint import load_any
from picopose_tpu_torch.utils.torch_port import load_torch_checkpoint, port_dinov2, port_picopose, to_numpy_state_dict
from picopose_tpu_torch.utils.weights import _dinov2, state_dict_from_flax


@torch.no_grad()
def _graft(model: torch.nn.Module, new: Mapping[str, np.ndarray], what: str, subset: bool = False) -> None:
    """Copy ``new`` (the port's state-dict keys, numpy values) into
    ``model`` in place, cast to each entry's dtype.  With ``subset=False``
    every entry of the model's state must be covered; with ``subset=True``
    only the keys present are replaced.  Raises ValueError on unknown keys
    or shape mismatches, before anything is copied."""
    state = model.state_dict()
    extra = [k for k in new if k not in state]
    missing = [] if subset else [k for k in state if k not in new]
    if missing or extra:
        raise ValueError(
            f"{what}: checkpoint layout mismatch (missing {missing[:3]}{'…' if len(missing) > 3 else ''}, "
            f"unexpected {extra[:3]}{'…' if len(extra) > 3 else ''})"
        )
    for k, v in new.items():
        if tuple(np.shape(v)) != tuple(state[k].shape):
            raise ValueError(
                f"{what}: shape mismatch at {k}: checkpoint {tuple(np.shape(v))} vs model {tuple(state[k].shape)}"
            )
    for k, v in new.items():
        state[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))


def warm_start(state, path: str, num_levels: int = 3):
    """Fill ``state.model``'s weights from the checkpoint at ``path`` (see
    the module docstring) and return ``state``."""
    model = state.model
    depth = len(model.feature_extractor.dinov2.blocks)
    if os.path.isdir(path):
        load_any(path, depth=depth)  # raises: the port reads torch files only
    raw = load_torch_checkpoint(path)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    keys = [str(k) for k in sd]
    if any(k.startswith(("network.", "feature_extractor.")) for k in keys):
        variables = port_picopose(raw, depth=depth, num_levels=num_levels)
        _graft(model, state_dict_from_flax(variables), "warm_start")
    elif any(k.startswith("patch_embed.proj.") for k in keys):
        try:
            vit = port_dinov2(to_numpy_state_dict(sd), depth, strict=True)["dinov2"]
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        new: dict[str, np.ndarray] = {}
        _dinov2(new, vit, "feature_extractor.dinov2.")
        _graft(model, new, "warm_start params", subset=True)
    else:
        raise ValueError(
            f"{path}: neither a PicoPose checkpoint nor DINOv2 backbone weights (no recognizable keys)"
        )
    return state
