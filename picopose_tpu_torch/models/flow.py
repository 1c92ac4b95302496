"""Stage-3 flow decoder: coarse-to-fine RAFT-style refinement.

Counterpart of picopose_tpu/models/flow.py (``MotionEncoder``, ``XHead``,
``_fused_xheads`` :139, ``FlowDecoder`` :175).  Per level l in {0, 1, 2}
at 16*2^l cells:

  proj: one 1x1 conv + BN applied to both feature maps (the query side at
        its own batch, B / group);
  corr: windowed lookup, pyramid depth l+1, radius radius // 2
        (ops/corr.py, kernel K4);
  motion = MotionEncoder(corr, flow) -> 126 ch + flow = 128;
  x = [tem_feat, warp(real_feat, flow) (ops/sample.py, kernel K5), motion];
  flow += flow head(x); certainty += mask head(x) (by default the two
  XHeads as one 640 -> 1024 conv and two grouped convs; ``fuse_xheads=False``
  runs them one after the other);
  between levels: flow -> 2 * bilinear x2, certainty -> bilinear x2
  (align_corners=True).

``quantize=True`` (the int8 serving mode, ops/qconv.py) runs the motion
encoder's five convs and each XHead's layers_0 / layers_1 as int8
convolutions with the same parameters; the proj convs (they feed
BatchNorm) and the small predict convs stay float, and the heads run
unfused (each conv has its own activation scale).

Feature maps are NHWC at the public surface and stay NHWC-contiguous in
memory: the convs run on NCHW views of that memory (channels_last), so the
(B, P, C) rows the kernels take are views, not copies.  Convs compute in
the features' dtype with fp32 parameters cast at the op; flow and
certainty stay fp32 through the residual adds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from picopose_tpu_torch.models.layers import BatchNorm2d, Conv2d
from picopose_tpu_torch.ops.corr import corr_lookup
from picopose_tpu_torch.ops.qconv import quantized_conv
from picopose_tpu_torch.ops.resize import resize_bilinear
from picopose_tpu_torch.ops.sample import warp_by_flow


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_relu(conv: Conv2d, x: torch.Tensor, quantize: bool) -> torch.Tensor:
    """relu(conv(x)), the conv in int8 (ops/qconv.py) when ``quantize``."""
    if quantize:
        return F.relu(quantized_conv(x, conv.weight, conv.bias, conv.padding[0]))
    return F.relu(conv(x))


class MotionEncoder(nn.Module):
    """corr_net (1x1 -> 256, 3x3 -> 192), flow_net (7x7 -> 128, 3x3 -> 64),
    out_net (3x3 -> 126), all with ReLU; output [out, flow] (128 ch)."""

    def __init__(self, corr_channels: int):
        super().__init__()
        self.corr_net_0 = Conv2d(corr_channels, 256, 1)
        self.corr_net_1 = Conv2d(256, 192, 3, padding=1)
        self.flow_net_0 = Conv2d(2, 128, 7, padding=3)
        self.flow_net_1 = Conv2d(128, 64, 3, padding=1)
        self.out_net_0 = Conv2d(256, 126, 3, padding=1)

    def forward(self, corr: torch.Tensor, flow: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """corr (B, H, W, L*25), flow (B, H, W, 2) -> (B, H, W, 128)."""
        q = quantize
        c = _conv_relu(self.corr_net_1, _conv_relu(self.corr_net_0, _nchw(corr), q), q)
        f = _conv_relu(self.flow_net_1, _conv_relu(self.flow_net_0, _nchw(flow), q), q)
        out = _conv_relu(self.out_net_0, torch.cat([_nhwc(c), _nhwc(f)], dim=-1).permute(0, 3, 1, 2), q)
        return torch.cat([_nhwc(out), flow], dim=-1)


class XHead(nn.Module):
    """One XHead: 3x3 640 -> 512 and 3x3 512 -> 256, each with ReLU, then a
    predict conv (3x3 for the flow head, 1x1 for the mask head).  The
    decoder runs it fused with its twin (``fused_xheads``) unless asked
    for the unfused or the int8 path."""

    def __init__(self, out_ch: int, predict_k: int):
        super().__init__()
        self.layers_0 = Conv2d(640, 512, 3, padding=1)
        self.layers_1 = Conv2d(512, 256, 3, padding=1)
        self.predict = Conv2d(256, out_ch, predict_k, padding=predict_k // 2)

    def forward(self, x: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """x (B, 640, H, W) -> (B, H, W, out_ch) in x's dtype; the predict
        conv stays float."""
        h = _conv_relu(self.layers_1, _conv_relu(self.layers_0, x, quantize), quantize)
        return _nhwc(self.predict(h))


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Stride-1 SAME conv in x's dtype (fp32 parameters cast at the op)."""
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=w.shape[-1] // 2, groups=groups)


def fused_xheads(x: torch.Tensor, flow_head: XHead, mask_head: XHead):
    """The flow and mask XHeads as one conv stack over their shared input
    (picopose_tpu/models/flow.py::_fused_xheads): layers_0 concatenated on
    output channels (one 640 -> 1024 conv), layers_1 and predict as
    groups=2 convs; the mask head's 1x1 predict zero-padded to 3x3 with a
    dead second output channel.  x (B, 640, H, W) -> (dflow (B, H, W, 2),
    dcert (B, H, W, 1)) in x's dtype."""
    f, m = flow_head, mask_head
    h = F.relu(_conv_same(
        x, torch.cat([f.layers_0.weight, m.layers_0.weight]),
        torch.cat([f.layers_0.bias, m.layers_0.bias]),
    ))
    h = F.relu(_conv_same(
        h, torch.cat([f.layers_1.weight, m.layers_1.weight]),
        torch.cat([f.layers_1.bias, m.layers_1.bias]), groups=2,
    ))
    kmp = F.pad(m.predict.weight, (1, 1, 1, 1))  # (1, 256, 3, 3)
    kp = torch.cat([f.predict.weight, kmp, torch.zeros_like(kmp)])
    bp = torch.cat([f.predict.bias, m.predict.bias, torch.zeros_like(m.predict.bias)])
    p = _nhwc(_conv_same(h, kp, bp, groups=2))
    return p[..., :2], p[..., 2:3]


class FlowDecoder(nn.Module):
    """``quantize``: int8 motion-encoder and XHead convs (implies the
    unfused heads); ``fuse_xheads``: the flow and mask heads as one conv
    stack.  Both are plain attributes over one parameter set, so a model
    switches path without new weights."""

    num_levels = 3
    radius = 4  # the reference's config radius; each lookup uses radius // 2

    def __init__(self, quantize: bool = False, fuse_xheads: bool = True):
        super().__init__()
        self.quantize, self.fuse_xheads = quantize, fuse_xheads
        n = 2 * (self.radius // 2) + 1
        L = range(self.num_levels)
        self.proj_conv = nn.ModuleList(Conv2d(256, 256, 1) for _ in L)
        self.proj_bn = nn.ModuleList(BatchNorm2d(256) for _ in L)
        self.encoder = nn.ModuleList(MotionEncoder((l + 1) * n * n) for l in L)
        self.flow_pred = nn.ModuleList(XHead(2, 3) for _ in L)
        self.mask_pred = nn.ModuleList(XHead(1, 1) for _ in L)

    def forward(self, tem_feats, real_feats, init_flow, init_certainty):
        """tem_feats: DPT levels [(B, 16, 16, 256), (B, 32, 32, 256),
        (B, 64, 64, 256)]; real_feats the same at B / group; init flow
        (B, 16, 16, 2) and certainty (B, 16, 16, 1).  Returns per-level
        lists of flows (B, H, W, 2) and certainty logits (B, H, W, 1)."""
        bt, br = tem_feats[0].shape[0], real_feats[0].shape[0]
        if bt % br != 0:
            raise ValueError(
                f"template batch {bt} is not a multiple of query batch {br}; "
                "the hypothesis-shared query features need an integer group"
            )
        group = bt // br
        flow, certainty = init_flow, init_certainty
        pred_flow, pred_certainty = [], []
        for level in range(self.num_levels):
            proj = lambda x: _nhwc(self.proj_bn[level](self.proj_conv[level](_nchw(x))))
            ft, fr = proj(tem_feats[level]), proj(real_feats[level])
            corr = corr_lookup(ft, fr, flow, self.radius // 2, level + 1, group=group)
            motion = self.encoder[level](corr.to(ft.dtype), flow.to(ft.dtype), self.quantize)
            fr_hat = warp_by_flow(fr, flow, group=group)
            x = _nchw(torch.cat([ft, fr_hat, motion], dim=-1))
            if self.fuse_xheads and not self.quantize:
                dflow, dcert = fused_xheads(x, self.flow_pred[level], self.mask_pred[level])
            else:
                dflow = self.flow_pred[level](x, self.quantize)
                dcert = self.mask_pred[level](x, self.quantize)
            flow = flow + dflow
            certainty = certainty + dcert
            pred_flow.append(flow)
            pred_certainty.append(certainty)
            if level != self.num_levels - 1:
                H, W = flow.shape[1:3]
                flow = 2.0 * resize_bilinear(flow, (2 * H, 2 * W))
                certainty = resize_bilinear(certainty, (2 * H, 2 * W))
        return pred_flow, pred_certainty
