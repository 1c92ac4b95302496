"""The port's windowed correlation lookup against the JAX package.

* ``corr_window_plain`` (the plain version of the CUDA kernel K4) against
  ``corr_window_pallas(..., transposed=True, interpret=True)``, one level,
  in fp32 and bf16, with ``group`` in {1, 3} and flows that push windows
  past every edge (some entirely off the map).
* the multi-level ``corr_lookup`` (all levels in one kernel launch on the
  card, level by level here) against ``_corr_lookup_xla`` in fp32, against
  the JAX package's public ``corr_lookup`` (its XLA path on the CPU) in
  fp32, and against ``corr_window_pallas`` in interpret mode level by level
  on maps pooled by the JAX package, in fp32 and bf16.

Tolerances (measured max errors in brackets): fp32 sums the products in
another order than XLA, 2e-5 on values of ~1 [1.3e-6]; bf16 outputs are
rounded once from fp32 on both sides, so they may differ by one bf16
step where the fp32 values straddle a rounding boundary: rtol 2^-7 [4.9e-4,
one step], plus 1e-6 absolute for taps that cancel to near zero, where
the fp32 sum order decides the last bits [7.5e-9 on ~5e-8]; the lookup
2e-5 [9.5e-7].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close

from picopose_tpu.geom.grids import pixel_coords_grid
from picopose_tpu.ops.corr import _corr_lookup_xla, corr_lookup
from picopose_tpu.ops.pallas.corr import corr_window_pallas
from picopose_tpu.ops.resize import avg_pool2d
from picopose_tpu_torch.ops import corr as C

R = 2  # lookup radius of the flow decoder (config radius 4 // 2)


def _inputs(seed, B2, group, G, Cc):
    rng = np.random.default_rng(seed)
    B = B2 * group
    f1 = rng.normal(size=(B, G, G, Cc)).astype(np.float32)
    f2 = rng.normal(size=(B2, G, G, Cc)).astype(np.float32)
    flow = (rng.normal(size=(B, G, G, 2)) * 3).astype(np.float32)
    # windows past the edges: shifts of about a map width, some far off
    flow[:, ::5] += rng.choice([-1.0, 1.0], size=(B, 1, G, 2)) * G * 0.9
    flow[:, 1, :3] = 1e4
    return f1, f2, flow


def _centres(flow, level):
    B, G = flow.shape[:2]
    return ((pixel_coords_grid(G, G) + flow) / 2.0**level).reshape(B, G * G, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("G,level", [(16, 0), (32, 0), (32, 1)])
def test_corr_window_plain_matches_pallas_kernel(dtype, group, G, level):
    f1, f2, flow = _inputs(G + level + group, 2, group, G, 64)
    B, B2 = f1.shape[0], f2.shape[0]
    jdt = jnp.dtype(dtype)
    j1 = jnp.asarray(f1, jdt).reshape(B, G * G, 64)
    j2 = jnp.asarray(f2, jdt)
    for _ in range(level):
        j2 = avg_pool2d(j2, 2)
    Hp = j2.shape[1]
    cen = np.array(_centres(jnp.asarray(flow), level))
    ref = corr_window_pallas(j1, j2.reshape(B2, Hp * Hp, 64), jnp.asarray(cen), Hp, Hp, R,
                             group=group, interpret=True, transposed=True)
    tdt = getattr(torch, dtype)
    got = C.corr_window_plain(
        torch.from_numpy(np.array(j1.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(j2.astype(jnp.float32))).to(tdt).reshape(B2, Hp * Hp, 64),
        torch.from_numpy(cen), Hp, Hp, R, group=group,
    )
    assert got.dtype == tdt and got.shape == (B, G * G, 25)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.all(got[:, G : G + 3] == 0) and np.all(ref[:, G : G + 3] == 0)  # far-off windows
    if dtype == "float32":
        assert_close(got, ref, atol=2e-5, what="corr window fp32")
    else:
        assert_close(got, ref, atol=1e-6, rtol=2**-7, what="corr window bf16")


@pytest.mark.parametrize("group,levels", [(1, 2), (3, 3)])
def test_corr_lookup_matches_xla(group, levels):
    G = 16
    f1, f2, flow = _inputs(7 + group, 2, group, G, 32)
    ref = _corr_lookup_xla(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(flow), R, levels, group)
    got = C.corr_lookup(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(flow), R, levels, group)
    assert got.shape == (f1.shape[0], G, G, levels * 25)
    assert_close(got.numpy(), np.asarray(ref), atol=2e-5, what="corr lookup")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,levels", [(1, 2), (3, 3)])
def test_corr_lookup_matches_pallas_kernel_per_level(dtype, group, levels):
    """All levels of one lookup against one interpret-mode Pallas call per
    level, concatenated as the JAX package's ``_corr_lookup_pallas_impl``
    does; the port pools feat2 itself (fp32 mean rounded once, as
    ``jnp.mean``)."""
    G, Cc = 16, 64
    f1, f2, flow = _inputs(11 + group, 2, group, G, Cc)
    B, B2 = f1.shape[0], f2.shape[0]
    jdt = jnp.dtype(dtype)
    j1, pooled = jnp.asarray(f1, jdt).reshape(B, G * G, Cc), jnp.asarray(f2, jdt)
    refs = []
    for i in range(levels):
        if i > 0:
            pooled = avg_pool2d(pooled, 2)
        Hp = pooled.shape[1]
        win = corr_window_pallas(j1, pooled.reshape(B2, Hp * Hp, Cc), _centres(jnp.asarray(flow), i),
                                 Hp, Hp, R, group=group, interpret=True, transposed=True)
        refs.append(np.asarray(win.astype(jnp.float32)).reshape(B, G, G, 25))
    ref = np.concatenate(refs, axis=-1)
    tdt = getattr(torch, dtype)
    to_t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jdt).astype(jnp.float32))).to(tdt)
    got = C.corr_lookup(to_t(f1), to_t(f2), torch.from_numpy(flow), R, levels, group)
    assert got.dtype == tdt and got.shape == (B, G, G, levels * 25)
    got = got.float().numpy()
    assert np.all(got[:, 1, :3] == 0)  # far-off windows, every level
    if dtype == "float32":
        assert_close(got, ref, atol=2e-5, what="corr lookup fp32")
    else:
        assert_close(got, ref, atol=1e-6, rtol=2**-7, what="corr lookup bf16")


@pytest.mark.parametrize("group,levels", [(1, 1), (3, 3)])
def test_corr_lookup_matches_jax_corr_lookup(group, levels):
    """The JAX package's public entry (on the CPU its XLA path) in fp32."""
    G = 16
    f1, f2, flow = _inputs(5 + levels, 2, group, G, 64)
    ref = corr_lookup(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(flow), R, levels, group=group)
    got = C.corr_lookup(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(flow), R, levels, group)
    assert_close(got.numpy(), np.asarray(ref), atol=2e-5, what="corr lookup vs JAX corr_lookup")


def test_corr_windows_takes_level_shifts():
    """A single level at shift s is the window of that map at centres / 2^s,
    in the channels of its position in the list."""
    f1, f2, flow = _inputs(3, 1, 1, 8, 16)
    grid = torch.from_numpy(np.array(_centres(jnp.asarray(flow), 0))).reshape(1, 8, 8, 2)
    a, m = torch.from_numpy(f1), torch.from_numpy(f2)[:, ::2, ::2].contiguous()
    got = C.corr_windows(a, [(torch.from_numpy(f2), 0), (m, 1)], grid, R)
    one = C.corr_window_plain(a.reshape(1, 64, 16), m.reshape(1, 16, 16), grid.reshape(1, 64, 2) / 2, 4, 4, R)
    assert got.shape == (1, 8, 8, 50)
    np.testing.assert_array_equal(got[..., 25:].reshape(1, 64, 25).numpy(), one.numpy())


def test_corr_windows_cuda_refuses_cpu_tensors():
    f1 = torch.zeros(1, 8, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        C.corr_windows_cuda(f1, [(f1, 0)], torch.zeros(1, 8, 8, 2), R)


def test_corr_lookup_needs_an_integer_group():
    f1 = torch.zeros(5, 8, 8, 16)
    f2 = torch.zeros(2, 8, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        C.corr_lookup(f1, f2, torch.zeros(5, 8, 8, 2), R, 1, group=2)


def test_corr_window_channel_order_walks_x_first():
    """A map that is zero but for one cell puts it at the tap whose outer
    index is the x offset: channel k = kx*(2r+1) + ky."""
    f1 = torch.ones(1, 1, 16)
    f2 = torch.zeros(1, 25, 16)
    f2[0, 1 * 5 + 3] = 4.0  # cell (x = 3, y = 1)
    out = C.corr_window_plain(f1, f2, torch.tensor([[[2.0, 2.0]]]), 5, 5, R)
    k = int(out[0, 0].argmax())
    assert (k // 5, k % 5) == (3, 1) and out[0, 0, k] == 4.0 * 16 * 16**-0.5
