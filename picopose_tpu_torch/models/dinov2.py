"""DINOv2 vision transformer: the stage-1 trunk and its multi-level taps.

Counterpart of picopose_tpu/models/dinov2.py: patch embed 14x14/s14, cls
token, bicubic-interpolated position embeddings with the DINOv2 +0.1
offset, pre-norm blocks with LayerScale and an exact-erf GELU MLP (SwiGLU
for the giant model), LayerNorm eps 1e-6 through ops/layernorm.py and
attention through ops/attention.py (CUDA kernels on the card).
``FeatureExtractor`` returns raw block outputs at ``blocks_to_take``, cls
stripped, NHWC, with no final LayerNorm.

Parameters stay fp32 and are cast to the compute dtype at each op; the LN
scale and bias enter the kernel in fp32.  ``remat`` recomputes each
block's activations in the backward (``torch.utils.checkpoint``, as the JAX
package's ``nn.remat``): the recompute launches K1 and K2 again.
Inside ``parallel.collectives.model_parallel`` the attention and the MLP
run Megatron-split over the model group (parallel/shardings.py lays the
weights out): qkv column-parallel by heads, so K2 runs on the rank's
H / n heads, fc1 / w12 column-parallel, proj / fc2 / w3 row-parallel with
one all-reduce each and the bias added after it; K1 stays on full rows.  The
blocks draw no random numbers, so the checkpoint does not stash the RNG
state, which a CUDA graph capture refuses to read.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from picopose_tpu_torch.models.layers import Conv2d, Linear, row_parallel
from picopose_tpu_torch.ops.attention import attention
from picopose_tpu_torch.ops.layernorm import layernorm
from picopose_tpu_torch.parallel.collectives import model_mesh, to_model_parallel


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int, scale: float, device: torch.device) -> torch.Tensor:
    """``bicubic_resize_matrix`` on ``device``, uploaded once (a CUDA graph
    cannot hold a host copy) as a normal tensor, usable under autograd."""
    with torch.inference_mode(False):
        return torch.as_tensor(bicubic_resize_matrix(in_size, out_size, scale), dtype=torch.float32, device=device)


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    pos_grid: int = 37  # pretrain img 518 / 14
    mlp_ratio: float = 4.0
    ffn_layer: str = "mlp"  # "mlp" | "swiglufused"
    init_values: float = 1.0
    interpolate_offset: float = 0.1


VIT_CONFIGS = {
    "dinov2_vits14": ViTConfig(384, 12, 6),
    "dinov2_vitb14": ViTConfig(768, 12, 12),
    "dinov2_vitl14": ViTConfig(1024, 24, 16),
    "dinov2_vitg14": ViTConfig(1536, 40, 24, ffn_layer="swiglufused"),
    # test-scale trunk with no pretrained counterpart
    "vit_tiny_test": ViTConfig(128, 4, 4),
}


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel with a=-0.75 (torch's bicubic)."""
    x = np.abs(x)
    return np.where(
        x <= 1,
        (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
    )


def bicubic_resize_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) separable torch-bicubic interpolation matrix.

    F.interpolate(mode='bicubic', align_corners=False) with an explicit
    scale_factor maps src = (dst + 0.5) / scale - 0.5 and clamps tap
    indices (replication at the borders).
    """
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for d in range(out_size):
        src = (d + 0.5) / scale - 0.5
        f = np.floor(src)
        taps = np.array([f - 1, f, f + 1, f + 2], dtype=np.int64)
        w = _cubic_kernel(src - taps)
        taps = np.clip(taps, 0, in_size - 1)
        for ti, wi in zip(taps, w):
            W[d, ti] += wi
    return W.astype(np.float32)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis through ops/layernorm.py."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = model_mesh()
        if mesh is not None:  # fc1 column-parallel, fc2 row-parallel
            return row_parallel(self.fc2, F.gelu(self.fc1(to_model_parallel(x, mesh))), mesh)
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFNFused(nn.Module):
    """hidden = round-to-8(2/3 * 4 * dim); w12 holds gate and value."""

    def __init__(self, dim: int):
        super().__init__()
        hidden = (int(dim * 4 * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(dim, 2 * hidden)
        self.w3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = model_mesh()
        if mesh is not None:  # w12 column-parallel (gate and value of the rank's units), w3 row-parallel
            x1, x2 = self.w12(to_model_parallel(x, mesh)).chunk(2, dim=-1)
            return row_parallel(self.w3, F.silu(x1) * x2, mesh)
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, N, C)
        B, N, C = x.shape
        mesh = model_mesh()
        if mesh is not None:  # qkv column-parallel by heads, proj row-parallel
            H = self.num_heads // mesh.n_model
            qkv = self.qkv(to_model_parallel(x, mesh)).reshape(B, N, 3, H, C // self.num_heads)
        else:
            H = self.num_heads
            qkv = self.qkv(x).reshape(B, N, 3, H, C // H)
        # (B, H, N, D) views, which the kernels read in place; their
        # output is a view of a (B, N, H, D) buffer, so the merge is a view
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = attention(q, k, v).transpose(1, 2).reshape(B, N, -1)
        return self.proj(out) if mesh is None else row_parallel(self.proj, out, mesh)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        self.norm1 = LayerNorm(c.embed_dim)
        self.attn = Attention(c.embed_dim, c.num_heads)
        self.ls1 = LayerScale(c.embed_dim, c.init_values)
        self.norm2 = LayerNorm(c.embed_dim)
        if c.ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFNFused(c.embed_dim)
        else:
            self.mlp = Mlp(c.embed_dim, int(c.embed_dim * c.mlp_ratio))
        self.ls2 = LayerScale(c.embed_dim, c.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoViT(nn.Module):
    """The transformer trunk.  ``forward`` returns the token stream after
    each of the first ``depth`` blocks.  ``remat``: keep no block's
    activations for the backward; recompute them there."""

    def __init__(self, cfg: ViTConfig, compute_dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.compute_dtype, self.remat = cfg, compute_dtype, remat
        self.patch_embed = Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.pos_grid * c.pos_grid + 1, c.embed_dim))
        self.blocks = nn.ModuleList(Block(c) for _ in range(c.depth))

    def _interpolated_pos_embed(self, h: int, w: int) -> torch.Tensor:
        """Bicubic interpolation of the (1, G*G+1, C) table to (1, h*w+1, C)
        as two fp32 matrix products."""
        c, pe = self.cfg, self.pos_embed
        G = c.pos_grid
        if (h, w) == (G, G):
            return pe
        Wy = _resize_matrix(G, h, (h + c.interpolate_offset) / G, pe.device)
        Wx = _resize_matrix(G, w, (w + c.interpolate_offset) / G, pe.device)
        grid = pe[:, 1:].reshape(G, G, -1).float()
        grid = torch.einsum("yg,ghc->yhc", Wy, grid)
        grid = torch.einsum("xh,yhc->yxc", Wx, grid)
        return torch.cat([pe[:, :1].float(), grid.reshape(1, h * w, -1)], dim=1)

    def forward(self, images: torch.Tensor, depth: int | None = None) -> list[torch.Tensor]:
        """images (B, H, W, 3) normalised crops -> list of (B, 1+N, C)
        token streams in the compute dtype."""
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(self.compute_dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C), patches row-major
        cls = self.cls_token.to(x.dtype).expand(B, 1, c.embed_dim)
        x = torch.cat([cls, x], dim=1)
        x = x + self._interpolated_pos_embed(gh, gw).to(x.dtype)
        outputs = []
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks[: c.depth if depth is None else depth]:
            x = checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False) if remat else blk(x)
            outputs.append(x)
        return outputs


class FeatureExtractor(nn.Module):
    """Multi-level NHWC taps: raw block outputs at ``blocks_to_take``, cls
    stripped.  Blocks after the last tap are not run (their outputs are
    unused)."""

    def __init__(
        self,
        vit_type: str = "dinov2_vitl14",
        blocks_to_take: Sequence[int] = (5, 11, 17, 23),
        compute_dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
    ):
        super().__init__()
        self.cfg = VIT_CONFIGS[vit_type]
        self.blocks_to_take = tuple(blocks_to_take)
        self.dinov2 = DinoViT(self.cfg, compute_dtype, remat)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        streams = self.dinov2(images, depth=max(self.blocks_to_take) + 1)
        return [
            streams[i][:, 1:, :].reshape(B, gh, gw, c.embed_dim)
            for i in self.blocks_to_take
        ]
