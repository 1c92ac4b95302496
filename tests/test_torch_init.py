"""The port's from-scratch weights (utils/weights.py::init_random_) against
what the JAX package's ``model.init`` draws, at vit_tiny_test.

The two draw from different generators, so the test compares
distributions: per parameter the standard deviation of every tensor of at
least 4096 elements (its sampling error is then a few percent), the
truncation of every kernel at 2 / 0.8796 standard deviations of
N(0, 1 / fan_in) with fan_in as flax counts it, and every tensor the JAX
side initialises to a constant, bitwise.  Both draws are seeded, so the
test is deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.utils.weights import fan_in, init_random_, state_dict_from_flax

MIN_ELEMENTS = 4096
STD_RATIO = (0.9, 1.1)
TRUNCATION = 2.28  # 2 / 0.87962566 = 2.2737, the bound on |w| * sqrt(fan_in)


@pytest.fixture(scope="module")
def jax_state():
    model = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = jax.jit(model.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), jnp.ones((1, 224, 224)), True
    )
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def port():
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    init_random_(model, 0)
    return model, {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items()}


def _kernels(model):
    """(state-dict key, module, weight) of every kernel of at least two axes."""
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if p.ndim >= 2 and pname not in ("cls_token", "pos_embed"):
                yield f"{mname}.{pname}", module, p


def test_same_keys_and_shapes(jax_state, port):
    _, sd = port
    assert set(sd) == set(jax_state)
    assert all(sd[k].shape == jax_state[k].shape for k in sd)


def test_std_ratio_of_every_large_tensor(jax_state, port):
    _, sd = port
    large = [k for k in sd if sd[k].size >= MIN_ELEMENTS and jax_state[k].std() > 0]
    assert {"dpt_head.resize_0.weight", "dpt_head.resize_1.weight",
            "feature_extractor.dinov2.pos_embed"} <= set(large)
    ratios = {k: sd[k].std() / jax_state[k].std() for k in large}
    bad = {k: r for k, r in ratios.items() if not STD_RATIO[0] <= r <= STD_RATIO[1]}
    assert not bad, bad


def test_kernels_truncated_at_two_sigma(port):
    model, _ = port
    kernels = list(_kernels(model))
    assert len(kernels) > 40
    bad = {k: float(p.abs().max() * fan_in(m, p) ** 0.5) for k, m, p in kernels
           if p.abs().max() > TRUNCATION * fan_in(m, p) ** -0.5}
    assert not bad, bad


def test_convtranspose_fan_in_counts_the_window(port):
    model, _ = port
    resize_0 = model.dpt_head.resize_0
    assert fan_in(resize_0, resize_0.weight) == resize_0.in_channels * 16
    std = resize_0.weight.std().item() * (resize_0.in_channels * 16) ** 0.5
    assert 0.9 < std < 1.1


def test_cls_token_is_tiny(jax_state, port):
    _, sd = port
    key = "feature_extractor.dinov2.cls_token"
    assert 0 < sd[key].std() <= 1e-5
    assert jax_state[key].std() <= 1e-5


def test_constants_equal_the_jax_init(jax_state, port):
    """Norm scales, biases, LayerScale gammas and BatchNorm statistics."""
    _, sd = port
    const = [k for k, v in jax_state.items() if v.std() == 0]
    assert any(k.endswith("running_var") for k in const)
    assert any(k.endswith("ls1.gamma") for k in const)
    bad = [k for k in const if not np.array_equal(sd[k], jax_state[k])]
    assert not bad, bad
