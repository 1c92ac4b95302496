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
from picopose_tpu_torch.ops.attention import (
    HOPPER_MAX_KEYS,
    attention,
    attention_cuda,
    attention_plain,
    copy_reason,
)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 257, 64), (2, 4, 257, 32), (1, 3, 17, 64), (1, 3, 16, 32), (2, 2, 5, 64)])
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



def _qkv_views(qkv: torch.Tensor):
    """(B, H, N, D) views of a (B, N, 3, H, D) projection, as the ViT hands them."""
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,D", [(1, 257, 2, 64), (2, 17, 3, 32)])
def test_attention_on_qkv_views_matches_pallas_and_xla(dtype, B, N, H, D):
    """The main path's call: views of one qkv buffer, made from numpy, on
    both sides; fp32 at 1e-5, bf16 at 3e-2 (module docstring)."""
    jdt, tdt, atol = {"float32": (jnp.float32, torch.float32, 1e-5),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    qkv = np.random.default_rng(3).normal(size=(B, N, 3, H, D)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3), jdt) for i in range(3))
    ref_k = np.asarray(flash_attention(jq, jk, jv, interpret=True), np.float32)
    ref_x = np.asarray(attention_xla(jq, jk, jv), np.float32)
    tq, tk, tv = _qkv_views(torch.from_numpy(qkv).to(tdt))
    assert not tq.is_contiguous()
    got = attention(tq, tk, tv)
    assert got.shape == (B, H, N, D) and got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref_k, atol=atol)
    np.testing.assert_allclose(got, ref_x, atol=atol)


def test_copy_reason_takes_qkv_views_in_place():
    """Which inputs the Hopper kernel reads where they lie (the rule the
    wrapper applies on the card, checked here on CPU tensors)."""
    qkv = torch.zeros(2, 257, 3, 4, 64, dtype=torch.bfloat16)
    assert copy_reason(*_qkv_views(qkv)) is None
    contiguous = [t.contiguous() for t in _qkv_views(qkv)]
    assert copy_reason(*contiguous) is None
    # fp32: the FFMA kernel reads views on the 16-byte grid in place, at any N
    assert copy_reason(*_qkv_views(qkv.float())) is None
    assert copy_reason(*_qkv_views(torch.zeros(1, 512, 3, 2, 32))) is None
    shifted32 = torch.zeros(2 * 257 * 3 * 4 * 64 + 1)[1:].view(2, 257, 3, 4, 64)
    assert "16-byte" in copy_reason(*_qkv_views(shifted32))
    odd = torch.zeros(2, 257, 3, 4, 66)[..., :64]  # rows 66 floats apart
    assert "16-byte" in copy_reason(*_qkv_views(odd))
    long = torch.zeros(1, HOPPER_MAX_KEYS + 1, 3, 2, 64, dtype=torch.bfloat16)
    assert "N >" in copy_reason(*_qkv_views(long))
    shifted = torch.zeros(2 * 257 * 3 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 257, 3, 4, 64)
    assert "16-byte" in copy_reason(*_qkv_views(shifted))
    q, k, v = _qkv_views(qkv)
    assert "16-byte" in copy_reason(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def test_plain_matches_pallas_at_the_loops_shape_fp32():
    """The accuracy loop's ViT-S attention, (2, 6, 257, 64) fp32, from views
    of one (B, N, 3, H, D) projection, against the Pallas kernel and
    ``attention_xla`` (1e-5, module docstring)."""
    B, N, H, D = 2, 257, 6, 64
    qkv = np.random.default_rng(16).normal(size=(B, N, 3, H, D)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    ref_k = np.asarray(flash_attention(jq, jk, jv, interpret=True))
    ref_x = np.asarray(attention_xla(jq, jk, jv))
    tq, tk, tv = _qkv_views(torch.from_numpy(qkv))
    assert copy_reason(tq, tk, tv) is None
    got = attention(tq, tk, tv).numpy()
    np.testing.assert_allclose(got, ref_k, atol=1e-5)
    np.testing.assert_allclose(got, ref_x, atol=1e-5)
