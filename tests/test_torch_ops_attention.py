"""The port's attention (picopose_tpu_torch/ops/attention.py) against the
JAX package's Pallas flash kernel (interpret mode) and ``attention_xla``.

Tolerances: fp32 differs in summation order and, for D = 32, in where the
non-power-of-two scale is applied (scores vs Q): 1e-5 on outputs of size
~1.  bf16: P and the output are rounded to bf16 (~2^-8 relative) at
slightly different points than the XLA form, so 3e-2, the bound
tests/test_attention.py holds the Pallas kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.ops.attention import attention_xla
from picopose_tpu.ops.pallas.flash_attention import flash_attention
from picopose_tpu_torch import kernels
from picopose_tpu_torch.ops.attention import attention, attention_cuda, attention_plain


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 257, 64), (2, 4, 257, 32), (1, 3, 17, 64)])
def test_plain_matches_pallas_and_xla_fp32(shape):
    q, k, v = _qkv(shape)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_k = np.asarray(flash_attention(jq, jk, jv, interpret=True))
    ref_x = np.asarray(attention_xla(jq, jk, jv))
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, ref_k, atol=1e-5)
    np.testing.assert_allclose(got, ref_x, atol=1e-5)


def test_plain_matches_pallas_bf16():
    q, k, v = _qkv((1, 2, 257, 64), seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(flash_attention(jq, jk, jv, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (jq, jk, jv))
    got = attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2)


def test_cpu_dispatch_is_plain_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 33, 32)))
    kernels.reset_launches()
    assert torch.equal(attention(q, k, v), attention_plain(q, k, v))
    assert kernels.LAUNCHES["attention"] == 0
    with pytest.raises(ValueError):
        attention_cuda(q, k, v)

