"""Stage-3 training noise: the noisy ground-truth affine that seeds the flow.

Counterpart of picopose_tpu/train/augment.py:28-69.  The GT template ->
query affine is perturbed in scale, rotation and translation; each
component's standard deviation is drawn per call from its ladder.  The
rotation angle is read with atan2(M10, M00), which keeps its sign (the JAX
package's deliberate fix of the reference's acos); the lower scale clamp
is negative (-0.5), as in the reference.

The draws are an ``AffineNoise``: drawn from a ``torch.Generator`` on the
affines' device (no host round trip), or given by the caller, which is how
the parity tests inject the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from picopose_tpu_torch.geom.affine import make_affine
from picopose_tpu_torch.geom.rotation import cos_sin, rotation_2d

STD_SCALES = (0.01, 0.05, 0.1, 0.15, 0.2)
STD_ROTS = (1.0, 2.0, 5.0, 10.0, 15.0)
STD_TRANS = (2.0, 5.0, 10.0, 15.0, 20.0)


class AffineNoise(NamedTuple):
    ladder: torch.Tensor  # (3,) int64: the indices into STD_SCALES, STD_ROTS, STD_TRANS
    scale: torch.Tensor   # (B,) standard normals
    rot: torch.Tensor     # (B,)
    trans: torch.Tensor   # (B, 2)


def draw_affine_noise(batch: int, generator: torch.Generator) -> AffineNoise:
    """One call's draws, on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
    return AffineNoise(
        torch.randint(0, len(STD_SCALES), (3,), **kw),
        torch.randn(batch, **kw), torch.randn(batch, **kw), torch.randn(batch, 2, **kw),
    )


@torch.no_grad()
def perturb_affine(
    gt_Ms: torch.Tensor,
    noise: AffineNoise | torch.Generator,
    min_scale: float = 0.5,
    max_scale: float = 1.5,
    max_rot_deg: float = 45.0,
    max_trans_px: float = 56.0,
) -> torch.Tensor:
    """(B, 3, 3) GT affines -> noisy affines: scale gt * clip(N(1, s),
    -min_scale, max_scale), angle gt + clip(N(0, s_deg), +-45 deg),
    translation gt + clip(N(0, s_px), +-56 px)."""
    if isinstance(noise, torch.Generator):
        noise = draw_affine_noise(gt_Ms.shape[0], noise)
    f32 = dict(dtype=torch.float32, device=gt_Ms.device)
    idx = noise.ladder.to(gt_Ms.device)
    s_scale, s_rot, s_trans = (torch.tensor(ladder, **f32)[idx[i]]
                               for i, ladder in enumerate((STD_SCALES, STD_ROTS, STD_TRANS)))
    gt_scale = torch.linalg.vector_norm(gt_Ms[:, 0, :2], dim=-1)
    gt_rot = torch.atan2(gt_Ms[:, 1, 0], gt_Ms[:, 0, 0])
    f_scale = torch.clamp(1.0 + s_scale * noise.scale, -min_scale, max_scale)
    d_rot = torch.clamp(s_rot * noise.rot, -max_rot_deg, max_rot_deg)
    d_trans = torch.clamp(s_trans * noise.trans, -max_trans_px, max_trans_px)
    noise_rot = gt_rot + torch.deg2rad(d_rot)
    R = rotation_2d(cos_sin(torch.remainder(noise_rot + 2 * torch.pi, 2 * torch.pi)))
    return make_affine(rotation=R, scale=gt_scale * f_scale, translation=gt_Ms[:, :2, 2] + d_trans)
