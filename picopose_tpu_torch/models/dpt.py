"""DPT feature pyramid head (stage 3, cached per view in the template bank).

Counterpart of picopose_tpu/models/dpt.py: projects[i] 1x1 -> resize
(x4 convT / x2 convT / identity / 3x3 s2) -> layerN_rn 3x3 (no bias) ->
fusion blocks producing [path_4 (16^2), path_3 (32^2), path_2 (64^2)].
Eval-mode BatchNorm (eps 1e-5).  NHWC in and out; inside, the convs run
on NCHW views of channels-last memory.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from picopose_tpu_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d
from picopose_tpu_torch.ops.resize import resize_bilinear

DPT_LEVELS = 3  # the pyramid's levels, coarse to fine: the flow decoder's at most


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> bn -> relu -> conv3x3 -> bn, plus the skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(F.relu(x)))
        out = self.bn2(self.conv2(F.relu(out)))
        return out + x


class FeatureFusionBlock(nn.Module):
    """Fusion + upsample-to-size (bilinear, align_corners=True) + 1x1 conv."""

    def __init__(self, features: int, with_residual: bool):
        super().__init__()
        if with_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x, res=None, *, size: tuple[int, int]):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        x = resize_bilinear(x.permute(0, 2, 3, 1), size)
        return self.out_conv(x.permute(0, 3, 1, 2))


class DPTHead(nn.Module):
    def __init__(
        self,
        in_channels: int = 1024,
        features: int = 256,
        out_channels: Sequence[int] = (256, 512, 1024, 1024),
    ):
        super().__init__()
        oc = out_channels
        self.projects = nn.ModuleList(Conv2d(in_channels, c, 1) for c in oc)
        self.resize_0 = ConvTranspose2d(oc[0], oc[0], 4, stride=4)
        self.resize_1 = ConvTranspose2d(oc[1], oc[1], 2, stride=2)
        self.resize_3 = Conv2d(oc[3], oc[3], 3, stride=2, padding=1)
        for i, c in enumerate(oc):
            setattr(self, f"layer{i + 1}_rn", Conv2d(c, features, 3, padding=1, bias=False))
        self.refinenet4 = FeatureFusionBlock(features, with_residual=False)
        self.refinenet3 = FeatureFusionBlock(features, with_residual=True)
        self.refinenet2 = FeatureFusionBlock(features, with_residual=True)

    def forward(self, levels: list[torch.Tensor]) -> list[torch.Tensor]:
        """4 x (B, 16, 16, in_channels) taps -> [path_4 (16^2), path_3 (32^2),
        path_2 (64^2)], each (B, ., ., 256) in the taps' dtype."""
        if len(levels) != 4:
            raise ValueError("DPTHead takes four backbone levels")
        resize = (self.resize_0, self.resize_1, None, self.resize_3)
        outs = []
        for i, x in enumerate(levels):
            x = self.projects[i](x.permute(0, 3, 1, 2))
            if resize[i] is not None:
                x = resize[i](x)
            outs.append(getattr(self, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = outs  # 64^2, 32^2, 16^2, 8^2
        path4 = self.refinenet4(l4, size=l3.shape[2:])
        path3 = self.refinenet3(path4, l3, size=l2.shape[2:])
        path2 = self.refinenet2(path3, l2, size=l1.shape[2:])
        return [p.permute(0, 2, 3, 1) for p in (path4, path3, path2)]
