"""The port's models (picopose_tpu_torch/models) against the JAX package's
flax PicoPose at the same weights, carried across by
picopose_tpu_torch/utils/weights.py.

A small model (vit_tiny_test, taps 0-3, fp32, 224^2 crops) gets seeded
random flax variables.  Tolerances (fp32, both sides on the CPU): the
products are summed in other orders (oneDNN vs XLA), and for D = 32 the
attention scale lands on the scores instead of Q; after four blocks and
the conv stacks the largest error measured was 3e-5 on outputs of size
~14, so the bound is 5e-5 + 1e-5 relative.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, assert_close, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.models.layers import ConvTranspose2d
from picopose_tpu_torch.utils.weights import (
    _conv_transpose,
    init_random_,
    load_flax_variables,
    state_dict_from_flax,
)

TOL = dict(atol=5e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    tmodel = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return rng.normal(size=(2, 224, 224, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_feats(models, images):
    jmodel, variables, _ = models
    fn = jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.features))
    return [np.array(f) for f in fn(variables, jnp.asarray(images))]


@pytest.fixture(scope="module")
def torch_feats(models, images):
    with torch.inference_mode():
        return [f.numpy() for f in models[2].features(torch.from_numpy(images))]


@pytest.mark.parametrize("level", range(4))
def test_feature_taps_match(jax_feats, torch_feats, level):
    assert torch_feats[level].shape == (2, 16, 16, 128)
    assert_close(torch_feats[level], jax_feats[level], what=f"tap {level}", **TOL)


@pytest.fixture(scope="module")
def dpt_pair(models, jax_feats):
    jmodel, variables, tmodel = models
    fn = jax.jit(lambda v, f: jmodel.apply(v, f, method=jmodel.dpt))
    ref = [np.asarray(p) for p in fn(variables, [jnp.asarray(f) for f in jax_feats])]
    with torch.inference_mode():
        got = [p.numpy() for p in tmodel.dpt([torch.from_numpy(f) for f in jax_feats])]
    return ref, got


@pytest.mark.parametrize("level,grid", [(0, 16), (1, 32), (2, 64)])
def test_dpt_pyramid_matches(dpt_pair, level, grid):
    ref, got = dpt_pair
    assert got[level].shape == (2, grid, grid, 256)
    assert_close(got[level], ref[level], what=f"dpt level {level}", **TOL)


def test_stage2_outputs_match(models, jax_feats):
    jmodel, variables, tmodel = models
    rng = np.random.default_rng(2)
    tem_last = jax_feats[-1][::-1].copy()
    real_last = jax_feats[-1]
    tem_mask = (rng.random((2, 224, 224)) > 0.3).astype(np.float32)
    ref = jmodel.apply(
        variables, *(jnp.asarray(a) for a in (tem_last, real_last, tem_mask)),
        method=jmodel.stage2,
    )
    with torch.inference_mode():
        got = tmodel.stage2(*(torch.from_numpy(a) for a in (tem_last, real_last, tem_mask)))
    for name, g, r in zip(("translation", "scale", "inplane"), got, ref):
        assert_close(g.numpy(), r, what=name, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got[2].numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_convtranspose_needs_the_flip(k):
    """flax ConvTranspose applies its kernel unflipped; the converter's
    spatial flip makes torch's conv_transpose2d agree, and without it the
    two disagree."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(1, 5, 5, 3)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    mod = fnn.ConvTranspose(4, (k, k), strides=(k, k), padding="VALID")
    ref = np.asarray(mod.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))

    out = {}
    _conv_transpose(out, "t", {"kernel": kernel, "bias": bias})
    layer = ConvTranspose2d(3, 4, k, stride=k)
    layer.load_state_dict({"weight": torch.from_numpy(out["t.weight"].copy()), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        layer.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy()))
        unflipped = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(unflipped - ref).max() > 1e-2


def test_converter_fills_every_port_key(models):
    _, variables, tmodel = models
    sd = state_dict_from_flax(variables)
    port = tmodel.state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
        np.testing.assert_array_equal(port[k].numpy(), v, err_msg=k)


def test_init_random_is_seeded():
    a = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    b = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    init_random_(a, 7)
    init_random_(b, 7)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    init_random_(b, 8)
    assert not torch.equal(sa["affine_regressor.fc1.weight"], b.state_dict()["affine_regressor.fc1.weight"])
