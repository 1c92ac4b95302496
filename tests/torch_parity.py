"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

A small JAX ``PicoPose`` gets its variables drawn from a numpy seed (flax
shapes from ``jax.eval_shape``; every array filled with numpy), so both
sides run the same non-trivial weights: biases, norm scales and BatchNorm
statistics are all off their init values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SMALL = dict(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3))


def random_flax_variables(model, seed: int = 0) -> dict:
    """Seeded random variables with the shapes of ``model.init``."""
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            jnp.ones((1, 224, 224)), True,
        )
    )
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "gamma"):
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape)
        if name in ("cls_token", "pos_embed"):
            return 0.1 * rng.normal(size=shape)
        return 0.1 * rng.normal(size=shape)  # bias, mean

    tree = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def assert_close(got, ref, atol, rtol=0.0, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=what)
