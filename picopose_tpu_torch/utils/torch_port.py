"""Reference PyTorch checkpoints -> flax-layout parameter trees (numpy).

The port's own copy of picopose_tpu/utils/torch_port.py:
``to_numpy_state_dict`` (:73), ``dinov2_checkpoint_depth`` (:99),
``port_dinov2`` (:106, a torch-hub DINOv2 backbone), ``port_picopose``
(:256, a raw reference ``Net`` state dict or a Lightning checkpoint with a
``state_dict`` of ``network.``-prefixed keys) and ``load_torch_checkpoint``
(:287).  The trees it returns are those of the JAX package, so
utils/weights.py::load_flax_variables carries them into the port's
``PicoPose``, and the layout rules live there and here only:

  * Dense: kernel = weight.T;
  * Conv:  kernel = weight.transpose(2, 3, 1, 0)          (OIHW -> HWIO);
  * ConvTranspose: kernel = weight.transpose(2, 3, 0, 1), flipped in both
    spatial axes (IOHW -> HWIO);
  * BatchNorm: scale/bias = weight/bias, mean/var = running stats;
  * AffineRegressor.fc1: torch flattens NCHW (C, 8, 8), the flax tree
    NHWC, so the kernel rows are permuted (C, 8, 8) -> (8, 8, C) before
    transposing.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _dense(sd, k):
    return {"kernel": sd[f"{k}.weight"].T.copy(), "bias": sd[f"{k}.bias"].copy()}


def _dense_nobias(sd, k):
    return {"kernel": sd[f"{k}.weight"].T.copy()}


def _conv(sd, k, bias=True):
    out = {"kernel": sd[f"{k}.weight"].transpose(2, 3, 1, 0).copy()}
    if bias:
        out["bias"] = sd[f"{k}.bias"].copy()
    return out


def _convT(sd, k, bias=True):
    # torch IOHW -> HWIO, then flip both spatial axes: flax ConvTranspose
    # (transpose_kernel=False) correlates with the flipped kernel relative to
    # torch's ConvTranspose2d.
    kernel = sd[f"{k}.weight"].transpose(2, 3, 0, 1)[::-1, ::-1].copy()
    out = {"kernel": kernel}
    if bias:
        out["bias"] = sd[f"{k}.bias"].copy()
    return out


def _ln(sd, k):
    return {"scale": sd[f"{k}.weight"].copy(), "bias": sd[f"{k}.bias"].copy()}


def _bn_params(sd, k):
    return {"scale": sd[f"{k}.weight"].copy(), "bias": sd[f"{k}.bias"].copy()}


def _bn_stats(sd, k):
    return {
        "mean": sd[f"{k}.running_mean"].copy(),
        "var": sd[f"{k}.running_var"].copy(),
    }


def to_numpy_state_dict(torch_state: Mapping[str, Any]) -> dict[str, np.ndarray]:
    out = {}
    for k, v in torch_state.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


#: keys a torch-hub DINOv2 backbone checkpoint carries that the runtime model
#: never uses: `mask_token` (masked-image-modeling only) and the final `norm`
#: (the feature extractor taps raw block outputs — reference
#: model/stage1/feature_extractor.py:93-109 applies no final norm).
_DINOV2_BENIGN_UNCONSUMED = ("mask_token", "norm.weight", "norm.bias")


class _TrackingMapping(dict):
    """Records which keys `port_dinov2` actually consumed (strict mode)."""

    def __init__(self, base: Mapping[str, Any]):
        super().__init__(base)
        self.used: set[str] = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def dinov2_checkpoint_depth(sd: Mapping[str, Any], prefix: str = "") -> int:
    """Number of transformer blocks present in a torch state dict."""
    pat = re.compile(re.escape(prefix) + r"blocks\.(\d+)\.")
    idxs = {int(m.group(1)) for k in sd if (m := pat.match(str(k)))}
    return max(idxs) + 1 if idxs else 0


def port_dinov2(
    sd: Mapping[str, np.ndarray], depth: int, prefix: str = "", strict: bool = False
) -> dict:
    """torch DINOv2 state dict -> {'dinov2': ...} flax param subtree.

    With ``strict=True`` (used when loading a standalone backbone checkpoint,
    mirroring the reference's `load_state_dict(strict=True)` at
    model/stage1/feature_extractor.py:73-77):
      * a depth mismatch (e.g. vit-S weights into a vit-L model) raises a
        contextual ValueError instead of a raw KeyError;
      * unconsumed keys other than the known-benign set raise, so variants the
        model cannot represent (e.g. `register_tokens` in *_reg4 checkpoints)
        fail loudly instead of silently dropping parameters.
    """
    if strict:
        ckpt_depth = dinov2_checkpoint_depth(sd, prefix)
        if ckpt_depth != depth:
            raise ValueError(
                f"DINOv2 checkpoint has {ckpt_depth} transformer blocks but the "
                f"model expects {depth} — wrong vit_type for this checkpoint"
            )
        sd = _TrackingMapping(sd)
    p = prefix
    tree: dict[str, Any] = {
        "cls_token": sd[f"{p}cls_token"].copy(),
        "pos_embed": sd[f"{p}pos_embed"].copy(),
        "patch_embed": _conv(sd, f"{p}patch_embed.proj"),
    }
    for i in range(depth):
        b = f"{p}blocks.{i}"
        blk = {
            "norm1": _ln(sd, f"{b}.norm1"),
            "attn": {
                "qkv": _dense(sd, f"{b}.attn.qkv"),
                "proj": _dense(sd, f"{b}.attn.proj"),
            },
            "ls1": {"gamma": sd[f"{b}.ls1.gamma"].copy()},
            "norm2": _ln(sd, f"{b}.norm2"),
            "ls2": {"gamma": sd[f"{b}.ls2.gamma"].copy()},
        }
        if f"{b}.mlp.fc1.weight" in sd:
            blk["mlp"] = {
                "fc1": _dense(sd, f"{b}.mlp.fc1"),
                "fc2": _dense(sd, f"{b}.mlp.fc2"),
            }
        else:  # SwiGLU (vit_giant2)
            blk["mlp"] = {
                "w12": _dense(sd, f"{b}.mlp.w12"),
                "w3": _dense(sd, f"{b}.mlp.w3"),
            }
        tree[f"blocks_{i}"] = blk
    if strict:
        benign = {f"{p}{k}" for k in _DINOV2_BENIGN_UNCONSUMED}
        leftover = sorted(
            k for k in sd
            if str(k).startswith(p) and k not in sd.used and k not in benign
        )
        if leftover:
            raise ValueError(
                f"DINOv2 checkpoint has {len(leftover)} parameter(s) the model "
                f"cannot represent (would be silently dropped): "
                f"{leftover[:8]}{'...' if len(leftover) > 8 else ''}"
            )
    return {"dinov2": tree}


def _port_affine_regressor(sd, p):
    """AffineRegressor (model/stage2/affine_regressor.py:26-63).

    torch `features` Sequential: 0=conv1x1, 1=GN, 3=conv3x3(no bias), 4=GN.
    fc1 needs the NCHW->NHWC flatten permutation (see module docstring)."""
    fc1_w = sd[f"{p}.fc1.weight"]  # (1024, C*8*8) flattened as (C, 8, 8)
    C = sd[f"{p}.features.3.weight"].shape[0]
    fc1_w = fc1_w.reshape(-1, C, 8, 8).transpose(0, 2, 3, 1).reshape(fc1_w.shape[0], -1)
    tree = {
        "conv0": _conv(sd, f"{p}.features.0"),
        "gn0": _bn_params(sd, f"{p}.features.1"),
        "conv1": _conv(sd, f"{p}.features.3", bias=False),
        "gn1": _bn_params(sd, f"{p}.features.4"),
        "fc1": {"kernel": fc1_w.T.copy(), "bias": sd[f"{p}.fc1.bias"].copy()},
        "fc2": _dense(sd, f"{p}.fc2"),
    }
    for head in ("translation_predictor", "scale_predictor", "inplane_predictor"):
        for j in (0, 2, 4):
            tree[f"{head}_{j}"] = _dense(sd, f"{p}.{head}.{j}")
    return tree


def _port_dpt(sd, p):
    """DPTHead (model/stage3/dpt.py:171-272) -> (params, batch_stats)."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for i in range(4):
        params[f"projects_{i}"] = _conv(sd, f"{p}.projects.{i}")
        params[f"layer{i + 1}_rn"] = _conv(sd, f"{p}.scratch.layer{i + 1}_rn", bias=False)
    params["resize_0"] = _convT(sd, f"{p}.resize_layers.0")
    params["resize_1"] = _convT(sd, f"{p}.resize_layers.1")
    params["resize_3"] = _conv(sd, f"{p}.resize_layers.3")
    for rn in (2, 3, 4):
        rp: dict[str, Any] = {}
        rs: dict[str, Any] = {}
        for unit in ("resConfUnit1", "resConfUnit2"):
            if f"{p}.scratch.refinenet{rn}.{unit}.conv1.weight" not in sd:
                # refinenet4 takes a single input, so its resConfUnit1 is
                # dead in the reference (constructed by torch, never run —
                # dpt.py FeatureFusionBlock) and neither package's model
                # builds it.  Reference ckpts carry it (ported through as
                # unused leaves); exported ckpts don't (torch_export.py) —
                # tolerate both.
                continue
            up, us = {}, {}
            for c in ("conv1", "conv2"):
                up[c] = _conv(sd, f"{p}.scratch.refinenet{rn}.{unit}.{c}")
            for b in ("bn1", "bn2"):
                up[b] = _bn_params(sd, f"{p}.scratch.refinenet{rn}.{unit}.{b}")
                us[b] = _bn_stats(sd, f"{p}.scratch.refinenet{rn}.{unit}.{b}")
            rp[unit] = up
            rs[unit] = us
        rp["out_conv"] = _conv(sd, f"{p}.scratch.refinenet{rn}.out_conv")
        params[f"refinenet{rn}"] = rp
        stats[f"refinenet{rn}"] = rs
    return params, stats


def _port_flow_decoder(sd, p, num_levels=3):
    """FlowDecoder (model/stage3/flow_decoder.py:19-47) with mmcv ConvModule
    inner names (<seq>.<i>.conv)."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for l in range(num_levels):
        params[f"proj_{l}_conv"] = _conv(sd, f"{p}.proj.{l}.0")
        params[f"proj_{l}_bn"] = _bn_params(sd, f"{p}.proj.{l}.1")
        stats[f"proj_{l}_bn"] = _bn_stats(sd, f"{p}.proj.{l}.1")
        enc = {}
        for name, i in (("corr_net_0", 0), ("corr_net_1", 1)):
            enc[name] = _conv(sd, f"{p}.encoder.{l}.corr_net.{i}.conv")
        for name, i in (("flow_net_0", 0), ("flow_net_1", 1)):
            enc[name] = _conv(sd, f"{p}.encoder.{l}.flow_net.{i}.conv")
        enc["out_net_0"] = _conv(sd, f"{p}.encoder.{l}.out_net.0.conv")
        params[f"encoder_{l}"] = enc
        for kind, mod in (("flow_pred", "flow_pred"), ("mask_pred", "mask_pred")):
            head = {
                "layers_0": _conv(sd, f"{p}.{mod}.{l}.layers.0.conv"),
                "layers_1": _conv(sd, f"{p}.{mod}.{l}.layers.1.conv"),
                "predict": _conv(sd, f"{p}.{mod}.{l}.predict_layer"),
            }
            params[f"{kind}_{l}"] = head
    return params, stats


def port_picopose(
    torch_state: Mapping[str, Any], depth: int = 24, num_levels: int = 3
) -> dict:
    """Full reference checkpoint -> {'params': ..., 'batch_stats': ...}.

    Accepts either a raw `Net` state dict or a Lightning checkpoint dict
    (uses its 'state_dict' and strips the 'network.' prefix, matching
    Lite.load_from_checkpoint at run_test.py:265-272)."""
    if "state_dict" in torch_state:
        torch_state = torch_state["state_dict"]
    sd = to_numpy_state_dict(torch_state)
    if any(k.startswith("network.") for k in sd):
        sd = {k[len("network."):]: v for k, v in sd.items() if k.startswith("network.")}

    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    # the ViT nests under FeatureExtractor's `dinov2` attribute
    # (model/stage1/feature_extractor.py:87: self.dinov2 = _make_dinov2_model)
    params["feature_extractor"] = port_dinov2(
        sd, depth, prefix="feature_extractor.dinov2."
    )
    params["affine_regressor"] = _port_affine_regressor(sd, "affine_regressor")
    dpt_p, dpt_s = _port_dpt(sd, "offset_regressor.dpt_head")
    params["dpt_head"] = dpt_p
    stats["dpt_head"] = dpt_s
    fd_p, fd_s = _port_flow_decoder(sd, "offset_regressor.flow_decoder", num_levels)
    params["flow_decoder"] = fd_p
    stats["flow_decoder"] = fd_s
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str) -> dict:
    """``torch.load`` of a reference checkpoint file, onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)
