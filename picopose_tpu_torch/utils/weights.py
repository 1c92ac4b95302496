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

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


BF16_TAG = [("bf16", np.uint16)]  # numpy has no bfloat16: raw bits under this dtype


def bf16_bits_to_f32(a: np.ndarray) -> np.ndarray:
    """bf16 raw bits (uint16, or under ``BF16_TAG``) -> fp32, exactly."""
    return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(a) -> np.ndarray:
    """fp32 -> bf16 raw bits (uint16), rounded to nearest even; NaN stays NaN."""
    u = np.asarray(a, np.float32).view(np.uint32)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(np.asarray(a, np.float32)), np.uint16(0x7FC0), r)


def _np(x) -> np.ndarray:
    """A leaf as fp32 numpy: jax / ml_dtypes arrays, numpy arrays, and bf16
    bits under ``BF16_TAG`` (utils/zarr2.py reads bf16 leaves so)."""
    a = x if isinstance(x, np.ndarray) else np.asarray(x)
    if a.dtype.names == ("bf16",):
        return bf16_bits_to_f32(a)
    return np.asarray(a, dtype=np.float32)


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


def _dpt(out: dict, params: Mapping, stats: Mapping, p: str, dead_units: bool = False) -> None:
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
        dead = rn == 4 and not (dead_units and "resConfUnit1" in rp)
        units = ("resConfUnit2",) if dead else ("resConfUnit1", "resConfUnit2")
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


def state_dict_from_flax(variables: Mapping[str, Any], dead_units: bool = False) -> dict[str, np.ndarray]:
    """The JAX package's PicoPose variables (``params`` and ``batch_stats``,
    as arrays) -> the port's PicoPose state dict, as fp32 numpy arrays.
    ``dead_units``: keep refinenet4's resConfUnit1 where the variables
    carry it (those ported from a reference checkpoint do), a module that
    never runs and that no model builds, for exporting back to the
    reference."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    _dinov2(out, params["feature_extractor"]["dinov2"], "feature_extractor.dinov2.")
    _affine_regressor(out, params["affine_regressor"], "affine_regressor")
    _dpt(out, params["dpt_head"], stats["dpt_head"], "dpt_head", dead_units)
    _flow_decoder(out, params["flow_decoder"], stats["flow_decoder"], "flow_decoder")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy converted flax variables into ``model`` (every key must match).
    Raises ValueError naming both shapes where an entry's shape differs
    (a flow decoder of another radius), before anything is copied."""
    sd = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in state_dict_from_flax(variables).items()
    }
    state = model.state_dict()
    for k, v in sd.items():
        if k in state and v.shape != state[k].shape:
            raise ValueError(
                f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs model {tuple(state[k].shape)}"
            )
    model.load_state_dict(sd, strict=True)


# jax.nn.initializers.variance_scaling's truncated_normal: a standard normal
# truncated at +-2 has this standard deviation, so the draw is rescaled by it
_TRUNCATED_STD = 0.87962566103423978
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))  # 2 * Phi(2) - 1


def fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    """The fan-in flax's lecun_normal counts for a kernel: in for a Dense,
    in x kh x kw for a Conv and for a ConvTranspose (torch keeps the latter
    as (in, out, kh, kw))."""
    if isinstance(module, nn.ConvTranspose2d):
        return weight.shape[0] * weight[0, 0].numel()
    return weight[0].numel()


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> None:
    """Draw every parameter from one ``torch.Generator`` seeded with ``seed``
    on the model's device, from the distributions the JAX package's
    ``model.init`` draws from (flax's defaults): every kernel truncated
    lecun_normal (a normal truncated at +-2 sigma, sigma =
    sqrt(1 / fan_in) / 0.8796), ``cls_token`` ~ N(0, 1e-6^2), ``pos_embed``
    ~ N(0, 0.02^2), LayerScale gammas their ``init_value``, norm scales 1,
    biases 0, BatchNorm running statistics (0, 1)."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name == "cls_token":
                p.normal_(0.0, 1e-6, generator=g)
            elif name == "pos_embed":
                p.normal_(0.0, 0.02, generator=g)
            elif p.ndim >= 2:
                # inverse CDF of a uniform draw on (Phi(-2), Phi(2)), as
                # nn.init.trunc_normal_ draws it (which is ~10x slower on the CPU)
                std = fan_in(module, p) ** -0.5 / _TRUNCATED_STD
                p.uniform_(-_ERF_2, _ERF_2, generator=g).erfinv_().mul_(std * math.sqrt(2.0))
                p.clamp_(-2.0 * std, 2.0 * std)
            elif name == "bias":
                p.zero_()
            elif name == "gamma":
                p.fill_(module.init_value)
            else:
                p.fill_(1.0)
        for name, b in module.named_buffers(recurse=False):
            b.fill_(1.0 if name == "running_var" else 0.0)
