"""Dynamic int8 convolution for the stage-3 conv stacks (serving mode).

Counterpart of picopose_tpu/ops/qconv.py::quantized_conv (:30), which is
XLA code there (no Pallas kernel), so the card runs it through a library
GEMM: an im2col of the int8 activations and ``torch._int_mm`` (cuBLASLt
s8 x s8 -> s32).  The scheme:

  * weights: symmetric per output channel, w_scale = max|w| / 127;
  * activations: symmetric per tensor, a_scale = max|x| / 127, computed
    on the device every call (a tensor, never read by the host);
  * products s8 x s8 -> s32, exact;
  * dequantisation y * (a_scale * w_scale) + bias in fp32, cast to x's
    dtype, in the JAX package's order.

``torch._int_mm`` takes M > 16 rows and K, N multiples of 8, so K (the
im2col width: 25 L for corr_net_0, 98 for flow_net_0) and N (126 for
out_net_0) are zero-padded.  The plain version, for CPU tensors, is an
exact fp64 convolution of the same int8 values, so both give the same s32
sums.  Off by default: it changes results against the float convs
(docs/PARITY.md records the JAX package's accuracy trade).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Cout, Cin, kh, kw) weight -> (int8 weight, (Cout,) fp32 scales)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 x, fp32 scalar scale), the scale a device tensor."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def int_conv_plain(xq: torch.Tensor, wq: torch.Tensor, padding: int) -> torch.Tensor:
    """Exact s32 sums of the int8 conv (NCHW x, OIHW w), as fp64 products
    of the int8 values (exact below 2^53), returned as int32 (B, H, W, Cout)."""
    y = F.conv2d(xq.double(), wq.double(), padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int_conv_cuda(xq: torch.Tensor, wq: torch.Tensor, padding: int) -> torch.Tensor:
    """The same s32 sums on the card: an im2col of the channels-last int8
    activations ((kh, kw, c) per row, K padded to a multiple of 8) times
    the (K, Cout) weight matrix by ``torch._int_mm``."""
    B, Cin = xq.shape[:2]
    Cout, _, kh, kw = wq.shape
    xh = F.pad(xq.permute(0, 2, 3, 1), (0, 0, padding, padding, padding, padding))  # NHWC
    Ho, Wo = xh.shape[1] - kh + 1, xh.shape[2] - kw + 1
    K, Kp, Np = kh * kw * Cin, _pad8(kh * kw * Cin), _pad8(Cout)
    cols = torch.empty(B, Ho, Wo, Kp, dtype=torch.int8, device=xq.device)
    cols[..., K:] = 0
    for t in range(kh * kw):
        i, j = divmod(t, kw)
        cols[..., t * Cin : (t + 1) * Cin] = xh[:, i : i + Ho, j : j + Wo]
    wmat = torch.zeros(Np, Kp, dtype=torch.int8, device=wq.device)
    wmat[:Cout, :K] = wq.permute(0, 2, 3, 1).reshape(Cout, K)
    y = torch._int_mm(cols.view(-1, Kp), wmat.t())  # (B Ho Wo, Np) int32
    return y[:, :Cout].reshape(B, Ho, Wo, Cout)


def quantized_conv(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, padding: int = 0
) -> torch.Tensor:
    """Stride-1 int8 convolution with float parameters: x (B, Cin, H, W)
    (an NCHW view of channels-last memory, as the decoder's convs take it),
    weight (Cout, Cin, kh, kw), bias (Cout,) -> (B, Cout, H', W') in x's
    dtype, channels-last in memory."""
    wq, w_scale = quantize_weight(weight)
    xq, a_scale = quantize_activation(x)
    if x.device.type == "cpu":
        y = int_conv_plain(xq, wq, padding)
    else:
        y = int_conv_cuda(xq, wq, padding)
    out = y.float() * (a_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).permute(0, 3, 1, 2)
