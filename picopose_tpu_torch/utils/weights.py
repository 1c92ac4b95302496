"""Weights for the port: the JAX package's flax variables converted into the
port's state, or random weights drawn from a seed.

Layout rules, flax -> torch (the port keeps its own copy of them):
  * Dense kernel (in, out) -> weight (out, in);
  * Conv kernel HWIO -> OIHW;
  * ConvTranspose kernel (kh, kw, in, out) -> flipped spatially, then
    (in, out, kh, kw): flax's ConvTranspose applies its kernel unflipped,
    torch's conv_transpose2d applies it flipped, so the DPT's resize_0 and
    resize_1 are wrong without the flip;
  * LayerNorm / GroupNorm / BatchNorm scale -> weight; the BatchNorm
    batch_stats mean / var -> running_mean / running_var;
  * LayerScale gamma, cls_token and pos_embed as they are;
  * the affine head's fc1 keeps its NHWC row order (the port flattens NHWC);
  * the flow decoder's per-level modules (flax ``proj_{l}_conv``,
    ``encoder_{l}``, ``flow_pred_{l}``, ...) -> ModuleList entries
    (``proj_conv.{l}``, ``encoder.{l}``, ``flow_pred.{l}``, ...).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(out: dict, key: str, tree: Mapping) -> None:
    out[f"{key}.weight"] = _np(tree["kernel"]).T
    if "bias" in tree:
        out[f"{key}.bias"] = _np(tree["bias"])


def _conv(out: dict, key: str, tree: Mapping) -> None:
    out[f"{key}.weight"] = _np(tree["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in tree:
        out[f"{key}.bias"] = _np(tree["bias"])


def _conv_transpose(out: dict, key: str, tree: Mapping) -> None:
    out[f"{key}.weight"] = _np(tree["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    if "bias" in tree:
        out[f"{key}.bias"] = _np(tree["bias"])


def _norm(out: dict, key: str, tree: Mapping) -> None:
    out[f"{key}.weight"] = _np(tree["scale"])
    out[f"{key}.bias"] = _np(tree["bias"])


def _batch_norm(out: dict, key: str, params: Mapping, stats: Mapping) -> None:
    _norm(out, key, params)
    out[f"{key}.running_mean"] = _np(stats["mean"])
    out[f"{key}.running_var"] = _np(stats["var"])


def _dinov2(out: dict, t: Mapping, p: str) -> None:
    out[f"{p}cls_token"] = _np(t["cls_token"])
    out[f"{p}pos_embed"] = _np(t["pos_embed"])
    _conv(out, f"{p}patch_embed", t["patch_embed"])
    depth = sum(1 for k in t if k.startswith("blocks_"))
    for i in range(depth):
        blk, b = t[f"blocks_{i}"], f"{p}blocks.{i}"
        _norm(out, f"{b}.norm1", blk["norm1"])
        _dense(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _dense(out, f"{b}.attn.proj", blk["attn"]["proj"])
        out[f"{b}.ls1.gamma"] = _np(blk["ls1"]["gamma"])
        _norm(out, f"{b}.norm2", blk["norm2"])
        out[f"{b}.ls2.gamma"] = _np(blk["ls2"]["gamma"])
        for name, tree in blk["mlp"].items():  # fc1/fc2, or w12/w3 (SwiGLU)
            _dense(out, f"{b}.mlp.{name}", tree)


def _affine_regressor(out: dict, t: Mapping, p: str) -> None:
    _conv(out, f"{p}.conv0", t["conv0"])
    _norm(out, f"{p}.gn0", t["gn0"])
    _conv(out, f"{p}.conv1", t["conv1"])
    _norm(out, f"{p}.gn1", t["gn1"])
    _dense(out, f"{p}.fc1", t["fc1"])
    _dense(out, f"{p}.fc2", t["fc2"])
    for head in ("translation_predictor", "scale_predictor", "inplane_predictor"):
        for j in (0, 2, 4):
            _dense(out, f"{p}.{head}.{j}", t[f"{head}_{j}"])


def _dpt(out: dict, params: Mapping, stats: Mapping, p: str) -> None:
    for i in range(4):
        _conv(out, f"{p}.projects.{i}", params[f"projects_{i}"])
        _conv(out, f"{p}.layer{i + 1}_rn", params[f"layer{i + 1}_rn"])
    _conv_transpose(out, f"{p}.resize_0", params["resize_0"])
    _conv_transpose(out, f"{p}.resize_1", params["resize_1"])
    _conv(out, f"{p}.resize_3", params["resize_3"])
    for rn in (2, 3, 4):
        rp, rs = params[f"refinenet{rn}"], stats[f"refinenet{rn}"]
        # refinenet4 takes one input: a resConfUnit1 there (present in trees
        # ported from the reference) is never called and is not built here
        units = ("resConfUnit2",) if rn == 4 else ("resConfUnit1", "resConfUnit2")
        for unit in units:
            base = f"{p}.refinenet{rn}.{unit}"
            for c in ("conv1", "conv2"):
                _conv(out, f"{base}.{c}", rp[unit][c])
            for bn in ("bn1", "bn2"):
                _batch_norm(out, f"{base}.{bn}", rp[unit][bn], rs[unit][bn])
        _conv(out, f"{p}.refinenet{rn}.out_conv", rp["out_conv"])


def _flow_decoder(out: dict, params: Mapping, stats: Mapping, p: str) -> None:
    levels = sum(1 for k in params if k.endswith("_conv") and k.startswith("proj_"))
    for l in range(levels):
        _conv(out, f"{p}.proj_conv.{l}", params[f"proj_{l}_conv"])
        _batch_norm(out, f"{p}.proj_bn.{l}", params[f"proj_{l}_bn"], stats[f"proj_{l}_bn"])
        for name, tree in params[f"encoder_{l}"].items():
            _conv(out, f"{p}.encoder.{l}.{name}", tree)
        for head in ("flow_pred", "mask_pred"):
            for name, tree in params[f"{head}_{l}"].items():  # layers_0/1, predict
                _conv(out, f"{p}.{head}.{l}.{name}", tree)


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The JAX package's PicoPose variables (``params`` and ``batch_stats``,
    as arrays) -> the port's PicoPose state dict, as fp32 numpy arrays."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    _dinov2(out, params["feature_extractor"]["dinov2"], "feature_extractor.dinov2.")
    _affine_regressor(out, params["affine_regressor"], "affine_regressor")
    _dpt(out, params["dpt_head"], stats["dpt_head"], "dpt_head")
    _flow_decoder(out, params["flow_decoder"], stats["flow_decoder"], "flow_decoder")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy converted flax variables into ``model`` (every key must match)."""
    sd = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in state_dict_from_flax(variables).items()
    }
    model.load_state_dict(sd, strict=True)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> None:
    """Draw every parameter from one ``torch.Generator`` seeded with ``seed``
    on the model's device: weight matrices and kernels ~ N(0, 1/fan_in),
    cls/pos embeddings ~ N(0, 0.02^2), norm and LayerScale scales 1, biases
    0, BatchNorm running statistics (0, 1)."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name in ("cls_token", "pos_embed"):
                p.normal_(0.0, 0.02, generator=g)
            elif p.ndim >= 2:
                fan_in = (
                    module.in_channels if isinstance(module, nn.ConvTranspose2d)
                    else p[0].numel()
                )
                p.normal_(0.0, fan_in ** -0.5, generator=g)
            elif name == "bias":
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in module.named_buffers(recurse=False):
            b.fill_(1.0 if name == "running_var" else 0.0)
