"""The training losses, the stage-3 affine noise and train-mode BatchNorm in
the port against the JAX package on the same seeded inputs.

Tolerances: each loss in fp32 within 1e-5 relative (the sums run in
another order); ``perturb_affine`` with the JAX package's draws injected
within 1e-6 (atol: affines of O(1-100) entries, rtol 1e-6); BatchNorm in
train mode against flax's: the running statistics within 1e-5; the fp32
outputs within 1e-4, because both sides take the variance as E[x^2] -
E[x]^2 summed in other orders and the second batch (mean^2 / var = 36)
loses five bits to that cancellation [6.7e-5 measured]; bf16 outputs
within one bf16 step (rtol 2^-7).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.geom.affine import make_affine
from picopose_tpu.geom.rotation import cos_sin, rotation_2d
from picopose_tpu.train import augment as jaug
from picopose_tpu.train import losses as jl
from picopose_tpu_torch.models.layers import BatchNorm2d
from picopose_tpu_torch.train import augment as taug
from picopose_tpu_torch.train import losses as tl

t = torch.from_numpy


def _close(got, ref, what=""):
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=0, err_msg=what)


def _correspondences(rng, B, G, share):
    """Patch-unit grids on the G-grid, ``share`` of them valid, some
    targets pushed off the map."""
    cs = np.arange(G) + 0.5
    xx, yy = np.meshgrid(cs, cs)
    src = np.broadcast_to(np.stack([xx, yy], -1), (B, G, G, 2)).astype(np.float32)
    tar = (src + rng.normal(0, 3, src.shape)).astype(np.float32)
    tar[:, ::9] += 80.0
    valid = rng.random((B, G, G)) < share
    return src, tar, valid


@pytest.mark.parametrize("share", [0.6, 0.02, 0.0])
def test_info_nce_matches_jax(rng, share):
    B, h, C, G = 2, 16, 64, 64
    src_f = rng.normal(size=(B, h, h, C)).astype(np.float32)
    tar_f = (src_f + 0.5 * rng.normal(size=src_f.shape)).astype(np.float32)
    src, tar, valid = _correspondences(rng, B, G, share)
    got = tl.info_nce_loss(t(src_f), t(tar_f), t(src), t(tar), t(valid))
    ref = jl.info_nce_loss(src_f, tar_f, src, tar, valid)
    assert np.isfinite(float(got))
    _close(got, ref)


def test_stage2_loss_matches_jax(rng):
    B = 8
    pred_t = rng.normal(size=(B, 2)).astype(np.float32)
    pred_s = rng.uniform(-0.2, 2.0, B).astype(np.float32)  # some below the 5e-3 clamp
    a = rng.uniform(0, 2 * np.pi, B).astype(np.float32)
    pred_i = np.stack([np.cos(a + 0.3), np.sin(a + 0.3)], -1).astype(np.float32)
    pred_i[0] = [np.cos(a[0]), np.sin(a[0])]  # at the GT: the arccos clamp
    gt_t = rng.normal(0, 20, (B, 2)).astype(np.float32)
    gt_s = rng.uniform(0.5, 2.0, B).astype(np.float32)
    args = (pred_t, pred_s, pred_i, gt_t, gt_s, a)
    for i, (got, ref) in enumerate(zip(tl.stage2_loss(*map(t, args)), jl.stage2_loss(*args))):
        _close(got, ref, f"term {i}")


@pytest.mark.parametrize("H", [16, 32, 64])
def test_flow_level_loss_matches_jax(rng, H):
    B, G = 2, 64
    src, tar, valid = _correspondences(rng, B, G, 0.7)
    flow = rng.normal(0, 3, (B, H, H, 2)).astype(np.float32)
    cert = rng.normal(0, 3, (B, H, H, 1)).astype(np.float32)
    got = tl.flow_level_loss(t(flow), t(cert), t(tar * (G / H) / (G / H)), t(valid))
    ref = jl.flow_level_loss(flow, cert, tar, valid)
    _close(got[0], ref[0], "flow")
    _close(got[1], ref[1], "certainty")


@pytest.mark.parametrize("terms", [(1e6,), (40.0, 30.5, 2.25)])
def test_total_loss_sums_and_clamps_as_jax(terms):
    got = tl.total_loss({f"l{i}": torch.tensor(v) for i, v in enumerate(terms)})
    ref = jl.total_loss({f"l{i}": jnp.asarray(v) for i, v in enumerate(terms)})
    assert float(got) == float(ref) == min(sum(terms), 100.0)


def jax_affine_noise(key, B):
    """The draws ``picopose_tpu.train.augment.perturb_affine`` makes from
    ``key`` (augment.py:44-61), as the port's ``AffineNoise``."""
    k = jax.random.split(key, 6)
    ladder = [int(jax.random.randint(k[i], (), 0, 5)) for i in range(3)]
    return taug.AffineNoise(
        torch.tensor(ladder), t(np.asarray(jax.random.normal(k[3], (B,)))),
        t(np.asarray(jax.random.normal(k[4], (B,)))), t(np.asarray(jax.random.normal(k[5], (B, 2)))),
    )


def _affines(rng, B):
    theta = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    return np.array(make_affine(
        rotation=rotation_2d(cos_sin(jnp.asarray(theta))),
        scale=jnp.asarray(rng.uniform(0.5, 2, B).astype(np.float32)),
        translation=jnp.asarray(rng.normal(0, 20, (B, 2)).astype(np.float32)),
    ))


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_perturb_affine_with_injected_draws_matches_jax(rng, seed):
    B = 64
    M = _affines(rng, B)
    key = jax.random.PRNGKey(seed)
    got = taug.perturb_affine(t(M), jax_affine_noise(key, B))
    ref = jaug.perturb_affine(key, jnp.asarray(M))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_perturb_affine_draws_from_a_generator(rng):
    """A generator's draws: repeatable from its state, and within the
    JAX package's clamps (45 degrees, 56 px)."""
    B = 512
    M = t(_affines(rng, B))
    a = taug.perturb_affine(M, torch.Generator().manual_seed(3))
    b = taug.perturb_affine(M, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, taug.perturb_affine(M, torch.Generator().manual_seed(4)))
    ang = lambda x: torch.atan2(x[:, 1, 0], x[:, 0, 0])
    d = torch.remainder(ang(a) - ang(M) + torch.pi, 2 * torch.pi) - torch.pi
    assert d.abs().max() <= np.deg2rad(45.0) + 1e-3
    assert (a[:, :2, 2] - M[:, :2, 2]).abs().max() <= 56.0 + 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(rng, dtype):
    """Two calls in train mode (as a shared module runs in one step): each
    normalised with its own batch's statistics, the running statistics
    updated in call order, the variance biased; then eval mode uses them."""
    C = 32
    xs = [(rng.normal(size=(4, 8, 8, C)) * 2 + 1).astype(np.float32),
          (rng.normal(size=(2, 8, 8, C)) * 0.5 - 3).astype(np.float32)]
    scale, bias = (1 + 0.1 * rng.normal(size=C)).astype(np.float32), (0.1 * rng.normal(size=C)).astype(np.float32)
    mean0, var0 = (0.1 * rng.normal(size=C)).astype(np.float32), rng.uniform(0.5, 1.5, C).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    refs = []
    for x in xs:
        y, mut = bn.apply(variables, jnp.asarray(x, jdt), use_running_average=False, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        refs.append(np.asarray(y.astype(jnp.float32)))
    eval_ref = bn.apply(variables, jnp.asarray(xs[0], jdt), use_running_average=True).astype(jnp.float32)

    m = BatchNorm2d(C)
    with torch.no_grad():
        m.weight.copy_(t(scale)), m.bias.copy_(t(bias)), m.running_mean.copy_(t(mean0)), m.running_var.copy_(t(var0))
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=1e-2, rtol=2**-7)
    nchw = lambda x: t(x).to(tdt).permute(0, 3, 1, 2)
    m.train()
    for i, (x, ref) in enumerate(zip(xs, refs)):
        y = m(nchw(x))
        assert y.dtype == tdt
        np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(), ref, err_msg=f"call {i}", **tol)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5, rtol=1e-5)
    m.eval()
    before = (m.running_mean.clone(), m.running_var.clone())
    y = m(nchw(xs[0])).detach().float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, np.asarray(eval_ref), **tol)
    assert torch.equal(before[0], m.running_mean) and torch.equal(before[1], m.running_var)
