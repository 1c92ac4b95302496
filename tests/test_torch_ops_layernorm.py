"""The port's LayerNorm (picopose_tpu_torch/ops/layernorm.py) against the
JAX package's Pallas kernel (interpret mode) and its XLA form.

Tolerances: fp32 differs only in summation order (1e-5 on O(1) outputs);
bf16 outputs carry ~2^-8 relative rounding, and the XLA form squares in
fp32 where the kernel squares in bf16, so 0.05 on outputs of size ~3
(the bound tests/test_layernorm.py holds the Pallas kernel to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.ops.layernorm import layernorm_xla
from picopose_tpu.ops.pallas.layernorm import layernorm_pallas
from picopose_tpu_torch import kernels
from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS
from picopose_tpu_torch.ops.layernorm import (
    check_width,
    layernorm,
    layernorm_cuda,
    layernorm_plain,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.5, 3.0, shape).astype(np.float32)
    scale = rng.normal(1.0, 0.2, shape[-1:]).astype(np.float32)
    bias = rng.normal(0.0, 0.5, shape[-1:]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 257, 256), (2, 17, 128)])
def test_plain_matches_pallas_and_xla(dtype, shape):
    jdt, tdt, atol = DTYPES[dtype]
    x, scale, bias = _inputs(shape)
    xj = jnp.asarray(x, jdt)
    ref_k = np.asarray(layernorm_pallas(xj, jnp.asarray(scale), jnp.asarray(bias), interpret=True), np.float32)
    ref_x = np.asarray(layernorm_xla(xj, jnp.asarray(scale), jnp.asarray(bias)), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = layernorm_plain(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref_k, atol=atol)
    np.testing.assert_allclose(got, ref_x, atol=atol)


def test_cpu_dispatch_is_plain_and_launches_nothing():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 9, 64)))
    kernels.reset_launches()
    got = layernorm(x, scale, bias)
    assert torch.equal(got, layernorm_plain(x, scale, bias))
    assert kernels.LAUNCHES["layernorm"] == 0
    with pytest.raises(ValueError):
        layernorm_cuda(x, scale, bias)


VIT_WIDTHS = sorted({c.embed_dim for c in VIT_CONFIGS.values()})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("C", VIT_WIDTHS)
def test_plain_matches_pallas_at_vit_widths(dtype, C):
    """Every width of models/dinov2.py::VIT_CONFIGS, which the kernel keeps
    in registers, against the Pallas kernel (interpret mode)."""
    jdt, tdt, atol = DTYPES[dtype]
    x, scale, bias = _inputs((2, 17, C), seed=C)
    xj = jnp.asarray(x, jdt)
    ref = np.asarray(layernorm_pallas(xj, jnp.asarray(scale), jnp.asarray(bias), interpret=True), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol)


def test_kernel_widths_fill_whole_vectors():
    assert VIT_WIDTHS == [128, 384, 768, 1024, 1536]  # the widths layernorm.cu keeps in registers
    for C in (*VIT_WIDTHS, 64, 8):
        check_width(C, torch.bfloat16)
    check_width(4, torch.float32)
    for C, dtype in ((100, torch.bfloat16), (6, torch.float32), (0, torch.float32)):
        with pytest.raises(ValueError, match="multiple of"):
            check_width(C, dtype)
