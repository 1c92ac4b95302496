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
from picopose_tpu_torch.geom.grids import pixel_coords_grid
from picopose_tpu_torch.ops import attention as A
from picopose_tpu_torch.ops import corr as CO
from picopose_tpu_torch.ops import layernorm as L
from picopose_tpu_torch.ops import matching as M
from picopose_tpu_torch.ops import sample as S


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


def test_stage3_kernels_are_in_the_table():
    assert kernels.KERNELS["corr_window"][0] == "corr.cu"
    assert kernels.KERNELS["warp"][0] == "warp.cu"


def _centres(g, B, G, level, device):
    """(B, G*G, 2) window centres of a level-``level`` lookup: the pixel
    grid plus a flow that pushes some windows past every edge and a few
    far off the map."""
    flow = torch.randn(B, G, G, 2, generator=g, device=device) * 3
    flow[:, ::5] += torch.sign(torch.randn(B, 1, G, 2, generator=g, device=device)) * G * 0.9
    flow[:, 1, :3] = 1e4
    return ((pixel_coords_grid(G, G, device=device) + flow) / 2.0**level).reshape(B, G * G, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,level,group", [(16, 0, 1), (32, 1, 5), (64, 0, 5), (64, 2, 5), (32, 0, 3)])
def test_corr_window_kernel_matches_plain(cuda_device, dtype, G, level, group):
    g = torch.Generator(device=cuda_device).manual_seed(G + level)
    B2, C, Hp = 2, 256, G >> level
    f1 = torch.randn(B2 * group, G * G, C, generator=g, device=cuda_device).to(dtype)
    f2 = torch.randn(B2, Hp * Hp, C, generator=g, device=cuda_device).to(dtype)
    cen = _centres(g, B2 * group, G, level, cuda_device)
    got = CO.corr_window_cuda(f1, f2, cen, Hp, Hp, 2, group)
    torch.cuda.synchronize()
    ref = CO.corr_window_plain(f1, f2, cen, Hp, Hp, 2, group)
    assert got.dtype == dtype and got.shape == (B2 * group, G * G, 25)
    assert bool((got[:, G : G + 3] == 0).all())  # windows far off the map
    torch.testing.assert_close(got.float(), ref.float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,group", [(16, 1), (32, 5), (64, 5)])
def test_warp_kernel_matches_plain(cuda_device, dtype, G, group):
    g = torch.Generator(device=cuda_device).manual_seed(G + group)
    B2, C = 2, 256
    feat = torch.randn(B2, G * G, C, generator=g, device=cuda_device).to(dtype)
    cen = _centres(g, B2 * group, G, 0, cuda_device)
    got = S.warp_cuda(feat, cen, G, G, group)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool((got[:, G : G + 3] == 0).all())
    torch.testing.assert_close(got.float(), S.warp_plain(feat, cen, G, G, group).float(), **_bf16_tol(dtype))


@pytest.mark.cuda
def test_stage3_launch_counts(cuda_device):
    f1 = torch.randn(6, 32, 32, 64, device=cuda_device)
    f2 = torch.randn(2, 32, 32, 64, device=cuda_device)
    flow = torch.randn(6, 32, 32, 2, device=cuda_device)
    kernels.reset_launches()
    CO.corr_lookup(f1, f2, flow, 2, 3, group=3)
    S.warp_by_flow(f2, flow, group=3)
    assert kernels.LAUNCHES["corr_window"] == 3 and kernels.LAUNCHES["warp"] == 1


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
    q = torch.randn(1, 2, 17, 32, device=cuda_device).bfloat16()
    kernels.reset_launches()
    L.layernorm(x, w, b)
    L.layernorm(x.cpu(), w.cpu(), b.cpu())
    A.attention(q, q, q)
    A.attention(q.cpu(), q.cpu(), q.cpu())
    assert kernels.LAUNCHES["layernorm"] == 1 and kernels.LAUNCHES["attention"] == 1


def _qkv_views(g, B, N, H, D, dtype, device):
    """(B, H, N, D) views of a (B, N, 3, H, D) projection, as the ViT hands them."""
    qkv = torch.randn(B, N, 3, H, D, generator=g, device=device).to(dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [17, 257, 272, 273, 512])
@pytest.mark.parametrize("B,H", [(1, 16), (32, 16)])
def test_attention_kernel_on_qkv_views(cuda_device, dtype, D, N, B, H):
    """Every attention kernel on the ViT's strided views: the Hopper kernel
    (bf16, N <= 272), the two-pass wmma kernel (bf16, N > 272) and the fp32
    kernel, at BH = 16 and at a bank chunk's BH = 512."""
    g = torch.Generator(device=cuda_device).manual_seed(N + D)
    q, k, v = _qkv_views(g, B, N, H, D, dtype, cuda_device)
    got = A.attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (B, H, N, D) and got.dtype == dtype
    torch.testing.assert_close(got.float(), A.attention_plain(q, k, v).float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [17, 257, 272])
def test_attention_reads_qkv_views_in_place(cuda_device, D, N):
    """bf16 with N <= 272 (the main path) allocates its output and nothing
    else: no copy of q, k or v."""
    g = torch.Generator(device=cuda_device).manual_seed(N)
    B, H = 4, 8
    q, k, v = _qkv_views(g, B, N, H, D, torch.bfloat16, cuda_device)
    A.attention_cuda(q, k, v)  # built and warm
    torch.cuda.synchronize()
    copies = dict(A.INPUT_COPIES)
    before = torch.cuda.memory_allocated(cuda_device)
    got = A.attention_cuda(q, k, v)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(cuda_device) - before
    out_bytes = got.numel() * got.element_size()
    assert out_bytes <= grown < 2 * out_bytes  # the output's block; a copy of q alone would double it
    assert dict(A.INPUT_COPIES) == copies
    assert got.transpose(1, 2).is_contiguous()  # a (B, N, H, D) buffer: the head merge is a view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [128, 384, 768, 1024, 1536])  # models/dinov2.py::VIT_CONFIGS
def test_layernorm_kernel_at_vit_widths(cuda_device, dtype, C):
    """Each ViT width (register-resident rows) with a row count that is no
    multiple of the 8 rows a block takes."""
    g = torch.Generator(device=cuda_device).manual_seed(C)
    x = (torch.randn(3, 333, C, generator=g, device=cuda_device) * 3 + 1.5).to(dtype)
    scale = torch.randn(C, generator=g, device=cuda_device) * 0.2 + 1
    bias = torch.randn(C, generator=g, device=cuda_device) * 0.5
    got = L.layernorm_cuda(x, scale, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-3, rtol=2**-7)
    torch.testing.assert_close(got.float(), L.layernorm_plain(x, scale, bias).float(), **tol)
