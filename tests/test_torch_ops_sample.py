"""The port's bilinear feature warp against the JAX package.

* ``warp_plain`` (the plain version of the CUDA kernel K5) against
  ``warp_pallas(interpret=True)`` in bf16: both round each bilinear weight
  to bf16, sum in fp32 and round the output once;
* ``warp_by_flow`` against ``_warp_by_flow_xla`` in fp32;
each with ``group`` in {1, 3} and flows that push samples past the edges.

Tolerances (measured max errors in brackets): bf16 may differ by one
bf16 step where the fp32 sums straddle a rounding boundary, rtol 2^-7
[0, equal]; fp32 lerps in another order than XLA, 1e-5 on values of ~1
[4.8e-7].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close

from picopose_tpu.geom.grids import pixel_coords_grid
from picopose_tpu.ops.pallas.warp import warp_pallas
from picopose_tpu.ops.sample import _warp_by_flow_xla
from picopose_tpu_torch.ops import sample as S


def _inputs(seed, B2, group, G, C):
    rng = np.random.default_rng(seed)
    B = B2 * group
    feat = rng.normal(size=(B2, G, G, C)).astype(np.float32)
    flow = (rng.normal(size=(B, G, G, 2)) * 4).astype(np.float32)
    flow[:, ::4] += rng.choice([-1.0, 1.0], size=(B, 1, G, 2)) * G * 0.8
    flow[:, 2, :2] = -1e4  # far off the map: exactly zero
    return feat, flow


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("G", [16, 32])
def test_warp_plain_matches_pallas_kernel_bf16(group, G):
    feat, flow = _inputs(G + group, 2, group, G, 64)
    B, B2 = flow.shape[0], feat.shape[0]
    jf = jnp.asarray(feat, jnp.bfloat16).reshape(B2, G * G, 64)
    cen = np.array((pixel_coords_grid(G, G) + jnp.asarray(flow)).reshape(B, G * G, 2))
    ref = warp_pallas(jf, jnp.asarray(cen), G, G, group=group, interpret=True)
    got = S.warp(torch.from_numpy(np.array(jf.astype(jnp.float32))).bfloat16(),
                 torch.from_numpy(cen), G, G, group=group)
    assert got.dtype == torch.bfloat16 and got.shape == (B, G * G, 64)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.all(got[:, 2 * G : 2 * G + 2] == 0)
    assert_close(got, ref, atol=0, rtol=2**-7, what="warp bf16")


@pytest.mark.parametrize("group", [1, 3])
def test_warp_by_flow_matches_xla_fp32(group):
    G = 16
    feat, flow = _inputs(5 + group, 2, group, G, 32)
    ref = _warp_by_flow_xla(jnp.asarray(feat), jnp.asarray(flow), group)
    got = S.warp_by_flow(torch.from_numpy(feat), torch.from_numpy(flow), group)
    assert got.shape == (flow.shape[0], G, G, 32)
    assert_close(got.numpy(), np.asarray(ref), atol=1e-5, what="warp fp32")


def test_warp_by_flow_needs_matching_batches():
    with pytest.raises(ValueError, match="flow batch"):
        S.warp_by_flow(torch.zeros(2, 4, 4, 8), torch.zeros(5, 4, 4, 2), group=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_sample_matches_jax(dtype):
    """``bilinear_sample`` at off-grid points, some past the edges, against
    the JAX function: fp32 within 1e-5; bf16 lerps in bf16 on both sides,
    where the order of the CPU's roundings may move a value by a step:
    rtol 2^-7 (plus 1e-6 for values that cancel to near zero)."""
    from picopose_tpu.ops.sample import bilinear_sample

    rng = np.random.default_rng(21)
    feat = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)
    grid = np.stack([rng.uniform(-2, 11, (2, 5, 7)), rng.uniform(-2, 13, (2, 5, 7))], -1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = bilinear_sample(jnp.asarray(feat, jd), jnp.asarray(grid))
    got = S.bilinear_sample(torch.from_numpy(feat).to(td), torch.from_numpy(grid))
    assert got.shape == (2, 5, 7, 8) and got.dtype == td
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        assert_close(got.numpy(), ref, atol=1e-5, what="bilinear_sample fp32")
    else:
        assert_close(got.float().numpy(), ref, atol=1e-6, rtol=2**-7, what="bilinear_sample bf16")


def test_bilinear_sample_shares_maps_over_groups():
    """Stream b reads map b // group: the sample of the repeated maps,
    bitwise."""
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.normal(size=(2, 6, 6, 4)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1, 6, (6, 3, 3, 2)).astype(np.float32))
    got = S.bilinear_sample(feat, grid, group=3)
    assert torch.equal(got, S.bilinear_sample(feat.repeat_interleave(3, 0), grid))
