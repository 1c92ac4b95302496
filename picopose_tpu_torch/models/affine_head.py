"""Stage-2 global affine regressor on NHWC similarity volumes.

Counterpart of picopose_tpu/models/affine_head.py: conv1x1 + GN(32) + ReLU
-> conv3x3/s2 (no bias) + GN + ReLU -> fc1/fc2 with LeakyReLU(0.1) ->
three MLP heads (translation 2, scale 1, in-plane cos/sin 2 with tanh +
L2 normalisation).  Runs in fp32.  fc1 reads the (8, 8, C) map flattened
in NHWC order, as the JAX model does.  Inside
``parallel.collectives.model_parallel`` fc1 runs column-parallel and fc2
row-parallel over the model group, the pair the JAX package's
tensor-parallel rules split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from picopose_tpu_torch.models.layers import Conv2d, GroupNorm, Linear, row_parallel
from picopose_tpu_torch.ops.matching import l2_normalize
from picopose_tpu_torch.parallel.collectives import model_mesh, to_model_parallel


def _mlp_head(hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(
        Linear(hidden, hidden), nn.ReLU(), Linear(hidden, hidden), nn.ReLU(),
        Linear(hidden, out),
    )


class AffineRegressor(nn.Module):
    def __init__(self, in_channel: int = 256, hidden_dim: int = 256, grid: int = 16):
        super().__init__()
        self.conv0 = Conv2d(in_channel, hidden_dim, 1)
        self.gn0 = GroupNorm(32, hidden_dim)
        self.conv1 = Conv2d(hidden_dim, hidden_dim, 3, stride=2, padding=1, bias=False)
        self.gn1 = GroupNorm(32, hidden_dim)
        self.fc1 = Linear((grid // 2) ** 2 * hidden_dim, 1024)
        self.fc2 = Linear(1024, 256)
        self.translation_predictor = _mlp_head(hidden_dim, 2)
        self.scale_predictor = _mlp_head(hidden_dim, 1)
        self.inplane_predictor = _mlp_head(hidden_dim, 2)

    def forward(self, sim: torch.Tensor):
        """sim (B, 16, 16, S=256) -> (translation (B, 2), scale (B,),
        inplane (B, 2) unit cos/sin)."""
        x = sim.permute(0, 3, 1, 2)
        x = F.relu(self.gn0(self.conv0(x)))
        x = F.relu(self.gn1(self.conv1(x)))  # (B, hidden, 8, 8)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        mesh = model_mesh()
        if mesh is not None:  # fc1 column-parallel, fc2 row-parallel (the JAX rules' fc1 -> fc2 pair)
            x = F.leaky_relu(self.fc1(to_model_parallel(x, mesh)), 0.1)
            x = F.leaky_relu(row_parallel(self.fc2, x, mesh), 0.1)
        else:
            x = F.leaky_relu(self.fc1(x), 0.1)
            x = F.leaky_relu(self.fc2(x), 0.1)
        translation = self.translation_predictor(x)
        scale = self.scale_predictor(x)[:, 0]
        inplane = l2_normalize(torch.tanh(self.inplane_predictor(x)), dim=-1)
        return translation, scale, inplane
