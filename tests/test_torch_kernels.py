"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Without a
card the ``cuda`` tests skip; the source checks run everywhere.

Tolerances: fp32 differs in summation order only (1e-5); bf16 outputs may
differ by one bf16 rounding step (rtol 2^-7) where the fp32 value before
rounding differs in its last bits.
"""

import os
import re

import numpy as np
import pytest
import torch

from picopose_tpu_torch import kernels
from picopose_tpu_torch.ops import attention as A
from picopose_tpu_torch.ops import layernorm as L
from picopose_tpu_torch.ops import matching as M


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_tol(dtype):
    return dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-2, rtol=2**-7)


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_every_kernel_source_exports_its_entry_point(name):
    source, entry, argtypes = kernels.KERNELS[name]
    text = open(os.path.join(kernels.CSRC_DIR, source)).read()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert m, f"{source} does not export {entry}"
    assert len(m.group(1).split(",")) == len(argtypes)
    assert "PP_EXPORT_ERROR_STRING" in text


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(16, 257, 1024, generator=g, device=cuda_device) * 3 + 1.5).to(dtype)
    scale = torch.randn(1024, generator=g, device=cuda_device) * 0.2 + 1
    bias = torch.randn(1024, generator=g, device=cuda_device) * 0.5
    got = L.layernorm_cuda(x, scale, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), L.layernorm_plain(x, scale, bias).float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,N", [(64, 257), (32, 257), (64, 17)])
def test_attention_kernel_matches_plain(cuda_device, dtype, D, N):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(3, 16, N, D, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    got = A.attention_cuda(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), A.attention_plain(q, k, v).float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,C", [(256, 1024), (256, 128), (48, 32)])
def test_match_kernel_matches_plain(cuda_device, dtype, S, C):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, N = 4, 11
    t = M.l2_normalize(torch.randn(N, S, C, generator=g, device=cuda_device))
    noise = torch.randn(B, S, C, generator=g, device=cuda_device) * (0.5 * C**-0.5)
    q = M.l2_normalize(t[:B] + noise)  # each query a noisy copy of one view
    qm = (torch.rand(B, S, generator=g, device=cuda_device) > 0.3).float()
    qm[0, 0] = 0.0  # a masked row 0: its zeros still enter the column maxima
    q, t = q.to(dtype), t.to(dtype)
    got = M.match_scores_cuda(q, qm, t)
    torch.cuda.synchronize()
    ref = M.match_scores_plain(q, qm, t)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(1).cpu().numpy(), np.arange(B))


@pytest.mark.cuda
def test_launch_counts_and_cpu_dispatch(cuda_device):
    x = torch.randn(2, 5, 64, device=cuda_device)
    w, b = torch.ones(64, device=cuda_device), torch.zeros(64, device=cuda_device)
    kernels.reset_launches()
    L.layernorm(x, w, b)
    L.layernorm(x.cpu(), w.cpu(), b.cpu())
    assert kernels.LAUNCHES["layernorm"] == 1
