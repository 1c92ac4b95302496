"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Without a
card the ``cuda`` tests skip; the source checks run everywhere.

Tolerances: fp32 differs in summation order only (1e-5); bf16 outputs may
differ by one bf16 rounding step (rtol 2^-7) where the fp32 value before
rounding differs in its last bits.  K3's int8 branch computes every sim
bitwise as its plain version does (exact s32 sums, one fp32 rescale); its
scores, like the other branches', sum the row maxima in another order
(1e-5).

Gradients: the kernel wrappers are autograd Functions whose backward
recomputes the JAX package's XLA form (ops/vjp.py); on the card they are
held against the same function through the plain versions, differentiated
natively: fp32 within 1e-4 relative (summation order), bf16 within 2^-5 of
the largest gradient (the backward's form rounds at other points than the
plain version).
"""

import os
import re

import numpy as np
import pytest
import torch

from picopose_tpu_torch import kernels
from picopose_tpu_torch.geom.grids import pixel_coords_grid
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.ops import attention as A
from picopose_tpu_torch.ops import corr as CO
from picopose_tpu_torch.ops import layernorm as L
from picopose_tpu_torch.ops import matching as M
from picopose_tpu_torch.ops import sample as S
from picopose_tpu_torch.ops.resize import resize_bilinear
from picopose_tpu_torch.ops.vjp import index_select
from picopose_tpu_torch.utils.weights import init_random_

TRAIN_B = 8  # configs/base.yaml train_dataloader.bs


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(q, t, dtype):
    """Normalised fp32 q and t as the match kernel's operands: int8 as the
    serving mode quantises them, else rounded to ``dtype``."""
    if dtype == torch.int8:
        return M.quantize_int8(q), M.quantize_int8(t)
    return q.to(dtype), t.to(dtype)


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


def _grid(g, B, G, device, W=None):
    """(B, G, W, 2) level-0 window centres: the pixel grid plus a flow that
    pushes some windows past every edge and a few far off the map."""
    W = G if W is None else W
    flow = torch.randn(B, G, W, 2, generator=g, device=device) * 3
    flow[:, ::5] += torch.sign(torch.randn(B, 1, W, 2, generator=g, device=device)) * G * 0.9
    flow[:, 1, :3] = 1e4
    return pixel_coords_grid(G, W, device=device) + flow


def _centres(g, B, G, level, device):
    """(B, G*G, 2) window centres of a level-``level`` lookup."""
    return (_grid(g, B, G, device) / 2.0**level).reshape(B, G * G, 2)


def _smooth_grid(g, B, G, device, scale=1.1, angle=0.3, shift=(2.0, -3.0)):
    """(B, G, G, 2) centres as the flow decoder sees them on an object: a
    similarity about the map centre (per stream a little different) plus a
    smooth sub-cell flow."""
    p = pixel_coords_grid(G, G, device=device) - (G - 1) / 2
    ang = angle + 0.1 * torch.randn(B, 1, 1, generator=g, device=device)
    s = scale * (1 + 0.05 * torch.randn(B, 1, 1, generator=g, device=device))
    x = s * (torch.cos(ang) * p[..., 0] - torch.sin(ang) * p[..., 1]) + (G - 1) / 2 + shift[0]
    y = s * (torch.sin(ang) * p[..., 0] + torch.cos(ang) * p[..., 1]) + (G - 1) / 2 + shift[1]
    noise = torch.randn(B, G // 4, G // 4, 2, generator=g, device=device).permute(0, 3, 1, 2)
    noise = torch.nn.functional.interpolate(noise, size=(G, G), mode="bilinear", align_corners=True)
    return torch.stack([x, y], dim=-1) + 0.5 * noise.permute(0, 2, 3, 1)


def _pyramid(g, B2, G, C, levels, dtype, device, W=None):
    """[(f2 (B2, G >> i, W >> i, C), i)] for i < levels."""
    W = G if W is None else W
    return [(torch.randn(B2, G >> i, W >> i, C, generator=g, device=device).to(dtype), i)
            for i in range(levels)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,level,group", [(16, 0, 1), (32, 1, 5), (64, 0, 5), (64, 2, 5), (32, 0, 3)])
def test_corr_window_kernel_matches_plain(cuda_device, dtype, G, level, group):
    """One pyramid level (a map at shift ``level``) per launch."""
    g = torch.Generator(device=cuda_device).manual_seed(G + level)
    B2, C, Hp = 2, 256, G >> level
    f1 = torch.randn(B2 * group, G, G, C, generator=g, device=cuda_device).to(dtype)
    f2 = torch.randn(B2, Hp, Hp, C, generator=g, device=cuda_device).to(dtype)
    grid = _grid(g, B2 * group, G, cuda_device)
    got = CO.corr_windows_cuda(f1, [(f2, level)], grid, 2, group)
    torch.cuda.synchronize()
    ref = CO.corr_windows_plain(f1, [(f2, level)], grid, 2, group)
    assert got.dtype == dtype and got.shape == (B2 * group, G, G, 25)
    assert bool((got[:, 1, :3] == 0).all())  # windows far off the map
    torch.testing.assert_close(got.float(), ref.float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 3, 5])
@pytest.mark.parametrize("G", [16, 32, 64])
@pytest.mark.parametrize("centres", ["smooth", "wild"])
def test_corr_kernel_levels_match_plain(cuda_device, dtype, group, G, centres):
    """Three pyramid levels in one launch against the plain version level by
    level: centres from a similarity (the tile path, mostly) and wild ones
    (the per-pixel path, mostly)."""
    g = torch.Generator(device=cuda_device).manual_seed(G * group)
    B2, C = 2, 256
    f1 = torch.randn(B2 * group, G, G, C, generator=g, device=cuda_device).to(dtype)
    maps = _pyramid(g, B2, G, C, 3, dtype, cuda_device)
    make = _smooth_grid if centres == "smooth" else _grid
    grid = make(g, B2 * group, G, cuda_device)
    got = CO.corr_windows_cuda(f1, maps, grid, 2, group)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B2 * group, G, G, 75)
    ref = CO.corr_windows_plain(f1, maps, grid, 2, group)
    for i in range(3):
        torch.testing.assert_close(got[..., 25 * i : 25 * (i + 1)].float(),
                                   ref[..., 25 * i : 25 * (i + 1)].float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 128, 256])
def test_corr_kernel_takes_both_paths_in_one_launch(cuda_device, C):
    """Streams with a smooth similarity (tiles on the box path, some of them
    straddling the map's edge) beside streams with wild centres (far-off and
    scattered windows, the per-pixel path), on a 24 x 40 grid whose tiles
    overhang nothing and a 20 x 12 one whose edge tiles are partial."""
    g = torch.Generator(device=cuda_device).manual_seed(C)
    for H, W in ((24, 40), (20, 12)):
        B2, group = 2, 3
        f1 = torch.randn(B2 * group, H, W, C, generator=g, device=cuda_device).bfloat16()
        maps = _pyramid(g, B2, H, C, 2, torch.bfloat16, cuda_device, W=W)
        grid = _grid(g, B2 * group, H, cuda_device, W=W)
        smooth = torch.stack(torch.meshgrid(
            torch.arange(W, device=cuda_device, dtype=torch.float32) * 1.05 + 3.0,
            torch.arange(H, device=cuda_device, dtype=torch.float32) * 0.95 - 2.0, indexing="xy"), -1)
        grid[::2] = smooth  # windows across the left, top and right edges
        stats = torch.zeros(3, dtype=torch.int32, device=cuda_device)
        got = CO.corr_windows_cuda(f1, maps, grid, 2, group, stats=stats)
        torch.cuda.synchronize()
        ref = CO.corr_windows_plain(f1, maps, grid, 2, group)
        torch.testing.assert_close(got.float(), ref.float(), **_bf16_tol(torch.bfloat16))
        tiles, mixed, pixels = stats.tolist()
        assert tiles == B2 * group * -(-H // 8) * -(-W // 8) * 2
        assert 0 < mixed < tiles and pixels > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("G", [16, 32, 64])
@pytest.mark.parametrize("centres", ["wild", "smooth"])
def test_warp_kernel_matches_plain(cuda_device, dtype, G, group, centres):
    """The warp kernel at the decoder's three grids: wild centres (taps
    scattered, past every edge and far off the map) and smooth ones (a
    similarity: neighbouring pixels share most of their taps).
    16 query maps x 5 as on the main path for G = 64 and group 5."""
    g = torch.Generator(device=cuda_device).manual_seed(G + group)
    B2, C = (16 if (G, group) == (64, 5) else 2), 256
    feat = torch.randn(B2, G * G, C, generator=g, device=cuda_device).to(dtype)
    if centres == "wild":
        cen = _centres(g, B2 * group, G, 0, cuda_device)
    else:
        cen = _smooth_grid(g, B2 * group, G, cuda_device).reshape(B2 * group, G * G, 2)
    got = S.warp_cuda(feat, cen, G, G, group)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if centres == "wild":
        assert bool((got[:, G : G + 3] == 0).all())
    torch.testing.assert_close(got.float(), S.warp_plain(feat, cen, G, G, group).float(), **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 8), (torch.bfloat16, 72), (torch.bfloat16, 264),
                                     (torch.float32, 4), (torch.float32, 132)])
def test_warp_kernel_partial_channel_passes(cuda_device, dtype, C):
    """Channel counts that leave lanes idle in the last pass over C, on a
    13 x 19 map (a warp's pixels cross row and stream ends; the pixel
    count is no multiple of a block's)."""
    g = torch.Generator(device=cuda_device).manual_seed(C)
    H, W, group = 13, 19, 3
    feat = torch.randn(2, H, W, C, generator=g, device=cuda_device).to(dtype)
    flow = torch.randn(6, H, W, 2, generator=g, device=cuda_device) * 2
    got = S.warp_by_flow(feat, flow, group)
    torch.cuda.synchronize()
    grid = (pixel_coords_grid(H, W, device=cuda_device) + flow).reshape(6, H * W, 2)
    ref = S.warp_plain(feat.reshape(2, H * W, C), grid, H, W, group).reshape(6, H, W, C)
    torch.testing.assert_close(got.float(), ref.float(), **_bf16_tol(dtype))


def _grad_close(got, ref, dtype, what):
    got, ref = got.float(), ref.float()
    top = ref.abs().max().item()
    assert top > 0 and bool(torch.isfinite(got).all()), what
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-4 * top, rtol=1e-4, msg=what)
    else:
        assert (got - ref).abs().max().item() <= 2**-5 * top, what


def _check_grads(out, inputs, plain_out, dtype, name, launches):
    """``out``: the wrapper's output on CUDA inputs that require grad (its
    forward launched ``name`` ``launches`` times); ``plain_out``: the same
    function through the plain versions.  Without the autograd Function the
    kernel's output had no grad_fn and the gradients stopped there."""
    assert out.grad_fn is not None and kernels.LAUNCHES[name] == launches
    g = torch.randn_like(out.float()).to(out.dtype)
    got = torch.autograd.grad(out, inputs, g)
    ref = torch.autograd.grad(plain_out, inputs, g)
    assert kernels.LAUNCHES[name] == launches  # the backward launches no kernel
    for i, (a, b) in enumerate(zip(got, ref)):
        _grad_close(a, b, dtype, f"{name} input {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_is_differentiable(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(4, 257, 1024, generator=g, device=cuda_device) * 3 + 1.5).to(dtype).requires_grad_()
    scale = (torch.randn(1024, generator=g, device=cuda_device) * 0.2 + 1).requires_grad_()
    bias = (torch.randn(1024, generator=g, device=cuda_device) * 0.5).requires_grad_()
    kernels.reset_launches()
    out = L.layernorm(x, scale, bias)
    _check_grads(out, (x, scale, bias), L.layernorm_plain(x, scale, bias), dtype, "layernorm", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "qkv views"])
def test_attention_kernel_is_differentiable(cuda_device, dtype, layout):
    """On the ViT's qkv views the gradient lands on the projection."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, H, N, D = 2, 16, 257, 64
    if layout == "contiguous":
        leaves = [torch.randn(B, H, N, D, generator=g, device=cuda_device).to(dtype).requires_grad_()
                  for _ in range(3)]
        q, k, v = leaves
    else:
        qkv = torch.randn(B, N, 3, H, D, generator=g, device=cuda_device).to(dtype).requires_grad_()
        leaves = [qkv]
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    kernels.reset_launches()
    A.INPUT_COPIES.clear()
    out = A.attention(q, k, v)
    assert dtype == torch.float32 or not A.INPUT_COPIES
    _check_grads(out, leaves, A.attention_plain(q, k, v), dtype, "attention", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_lookup_kernel_is_differentiable(cuda_device, dtype, monkeypatch):
    """Three pyramid levels in one launch, group 3, windows past the edges;
    the plain path is the same lookup with the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B2, group, G, C = 2, 3, 32, 64
    f1 = torch.randn(B2 * group, G, G, C, generator=g, device=cuda_device).to(dtype).requires_grad_()
    f2 = torch.randn(B2, G, G, C, generator=g, device=cuda_device).to(dtype).requires_grad_()
    flow = (_grid(g, B2 * group, G, cuda_device) - pixel_coords_grid(G, G, device=cuda_device)).requires_grad_()
    kernels.reset_launches()
    out = CO.corr_lookup(f1, f2, flow, 2, 3, group)
    monkeypatch.setattr(CO, "corr_windows", CO.corr_windows_plain)
    plain = CO._corr_lookup(f1, f2, flow, 2, 3, group)
    _check_grads(out, (f1, f2, flow), plain, dtype, "corr_window", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [1, 3, 4])
@pytest.mark.parametrize("centres", ["smooth", "wild"])
def test_corr_kernel_at_other_radii_matches_plain(cuda_device, dtype, radius, centres):
    """Lookup radii 1, 3 and 4 (config radius 2-9; RAFT's published 4 is
    config 8), five pyramid levels: two launches (four levels, then one),
    each writing its levels' channels; bf16 takes the tile kernel's path of
    that radius, and both of its paths on wild centres."""
    g = torch.Generator(device=cuda_device).manual_seed(40 + radius)
    B2, group, G, C = 2, 5, 32, 256
    n = (2 * radius + 1) ** 2
    f1 = torch.randn(B2 * group, G, G, C, generator=g, device=cuda_device).to(dtype)
    maps = _pyramid(g, B2, G, C, 5, dtype, cuda_device)
    grid = (_smooth_grid if centres == "smooth" else _grid)(g, B2 * group, G, cuda_device)
    stats = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    kernels.reset_launches()
    got = CO.corr_windows_cuda(f1, maps, grid, radius, group, stats=stats)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B2 * group, G, G, 5 * n)
    assert kernels.LAUNCHES["corr_window"] == 2
    ref = CO.corr_windows_plain(f1, maps, grid, radius, group)
    for i in range(5):
        torch.testing.assert_close(got[..., n * i : n * (i + 1)].float(), ref[..., n * i : n * (i + 1)].float(),
                                   **_bf16_tol(dtype))
    if dtype == torch.bfloat16:
        tiles, mixed, pixels = stats.tolist()
        assert tiles == B2 * group * (G // 8) ** 2 * 5  # tile-levels over both launches
        assert mixed < tiles and (pixels > 0 if centres == "wild" else True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [0, 5, 8])
def test_corr_kernel_at_any_radius_matches_plain(cuda_device, dtype, radius):
    """Radii outside the templates (0 and 5 and up) take the runtime-radius
    kernel, one launch for three levels."""
    g = torch.Generator(device=cuda_device).manual_seed(50 + radius)
    B2, group, G, C = 2, 3, 16, 64
    f1 = torch.randn(B2 * group, G, G, C, generator=g, device=cuda_device).to(dtype)
    maps = _pyramid(g, B2, G, C, 3, dtype, cuda_device)
    grid = _grid(g, B2 * group, G, cuda_device)
    kernels.reset_launches()
    got = CO.corr_windows_cuda(f1, maps, grid, radius, group)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_window"] == 1
    torch.testing.assert_close(got.float(), CO.corr_windows_plain(f1, maps, grid, radius, group).float(),
                               **_bf16_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_lookup_kernel_is_differentiable_at_radius_4(cuda_device, dtype, monkeypatch):
    """As ``test_corr_lookup_kernel_is_differentiable`` at lookup radius 4
    (config radius 8)."""
    g = torch.Generator(device=cuda_device).manual_seed(45)
    B2, group, G, C = 2, 3, 32, 64
    f1 = torch.randn(B2 * group, G, G, C, generator=g, device=cuda_device).to(dtype).requires_grad_()
    f2 = torch.randn(B2, G, G, C, generator=g, device=cuda_device).to(dtype).requires_grad_()
    flow = (_grid(g, B2 * group, G, cuda_device) - pixel_coords_grid(G, G, device=cuda_device)).requires_grad_()
    kernels.reset_launches()
    out = CO.corr_lookup(f1, f2, flow, 4, 3, group)
    assert out.shape == (B2 * group, G, G, 3 * 81)
    monkeypatch.setattr(CO, "corr_windows", CO.corr_windows_plain)
    plain = CO._corr_lookup(f1, f2, flow, 4, 3, group)
    _check_grads(out, (f1, f2, flow), plain, dtype, "corr_window", 1)


def _backward_twice(fn, *inputs):
    """Gradients of two backward passes of ``fn`` on the same inputs and
    cotangent."""
    outs = []
    for _ in range(2):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        y = fn(*xs)
        cot = torch.randn(y.shape, generator=torch.Generator(device=y.device).manual_seed(1), device=y.device)
        outs.append(torch.autograd.grad(y, xs, cot.to(y.dtype)))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 5])
def test_warp_by_flow_backward_is_repeatable(cuda_device, dtype, group):
    """Two backward passes of the warp are bitwise equal (its gathers'
    backward sums each target's taps in a fixed order, ops/vjp.py), with
    flows that send many pixels to the same cells; so are the corr
    lookup's and the bilinear resize's."""
    g = torch.Generator(device=cuda_device).manual_seed(60 + group)
    G, C = 64, 256
    feat = torch.randn(2, G, G, C, generator=g, device=cuda_device).to(dtype)
    f1 = torch.randn(2 * group, G, G, C, generator=g, device=cuda_device).to(dtype)
    flow = torch.randn(2 * group, G, G, 2, generator=g, device=cuda_device) * 3
    flow[:, ::2] *= 0.1  # contraction: several pixels per source cell
    for fn, xs in ((lambda f, fl: S.warp_by_flow(f, fl, group), (feat, flow)),
                   (lambda a, b, fl: CO.corr_lookup(a, b, fl, 2, 3, group), (f1, feat, flow)),
                   (lambda f: resize_bilinear(f, (2 * G + 1, 3 * G)), (feat,))):
        first, second = _backward_twice(fn, *xs)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fixed_order_index_select_syncs_nothing(cuda_device):
    """The fixed-order gather's forward and backward run without a host
    synchronisation (a training step's CUDA graph needs that)."""
    x = torch.randn(64, 256, device=cuda_device, requires_grad=True)
    idx = torch.randint(0, 64, (1000,), device=cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = index_select(x, 0, idx)
        (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(g[:, 0], torch.bincount(idx, minlength=64).float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 5])
def test_warp_by_flow_kernel_is_differentiable(cuda_device, dtype, group, monkeypatch):
    g = torch.Generator(device=cuda_device).manual_seed(6 + group)
    G, C = 32, 256
    feat = torch.randn(2, G, G, C, generator=g, device=cuda_device).to(dtype).requires_grad_()
    flow = (_grid(g, 2 * group, G, cuda_device) - pixel_coords_grid(G, G, device=cuda_device)).requires_grad_()
    kernels.reset_launches()
    out = S.warp_by_flow(feat, flow, group)
    monkeypatch.setattr(S, "warp", S.warp_plain)
    plain = S._warp_by_flow(feat, flow, group)
    _check_grads(out, (feat, flow), plain, dtype, "warp", 1)


@pytest.mark.cuda
def test_stage2_ignores_the_process_tf32_flags(cuda_device):
    """Stage 2 (fp32 convs on cuDNN, fp32 geometry) under PyTorch's default
    ``cudnn.allow_tf32 = True``, and with the matmul flag on too, is bitwise
    the same call with both off; the caller's flags are as they were."""
    model = PicoPose("vit_tiny_test", (0, 1, 2, 3), torch.float32, device=cuda_device)
    init_random_(model, 0)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    tem = torch.randn(8, 16, 16, 128, generator=g, device=cuda_device)
    real = tem.flip(0) + 0.3 * torch.randn(8, 16, 16, 128, generator=g, device=cuda_device)
    mask = (torch.rand(8, 224, 224, generator=g, device=cuda_device) > 0.3).float()
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    outs = {}
    try:
        for flags in ((False, False), (False, True), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            with torch.inference_mode():
                outs[flags] = model.stage2(tem, real, mask)
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    for flags in ((False, True), (True, True)):
        for a, b in zip(outs[flags], outs[False, False]):
            assert torch.equal(a, b), flags


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage3_launch_counts(cuda_device, dtype):
    """The decoder's three lookups (1, 2 and 3 pyramid levels) are three
    corr-window launches; CPU tensors launch nothing."""
    f1 = torch.randn(6, 32, 32, 64, device=cuda_device).to(dtype)
    f2 = torch.randn(2, 32, 32, 64, device=cuda_device).to(dtype)
    flow = torch.randn(6, 32, 32, 2, device=cuda_device)
    kernels.reset_launches()
    for levels in (1, 2, 3):
        CO.corr_lookup(f1, f2, flow, 2, levels, group=3)
        CO.corr_lookup(f1.cpu(), f2.cpu(), flow.cpu(), 2, levels, group=3)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("C", [1024, 128, 32])
@pytest.mark.parametrize("S", [256, 48, 80, 320])
def test_match_kernel_masks_and_ties(cuda_device, dtype, S, C):
    """Row blocks and column chunks past S (48, 80: zero-filled rows and
    columns that must not win a maximum; 320: a second 256-column chunk and
    a third row block), masked rows, a query with no unmasked row, and exact
    ties: view column 5 equal to column 0 (the row argmax stays 0) and query
    row 3 equal to row 0 (the column argmax stays 0)."""
    g = torch.Generator(device=cuda_device).manual_seed(S + C)
    B, N = 4, 9
    t = M.l2_normalize(torch.randn(N, S, C, generator=g, device=cuda_device))
    t[:, 5] = t[:, 0]
    q = M.l2_normalize(t[:B] + torch.randn(B, S, C, generator=g, device=cuda_device) * (0.5 * C**-0.5))
    q[:, 3] = q[:, 0]
    qm = (torch.rand(B, S, generator=g, device=cuda_device) > 0.3).float()
    qm[:, 0] = qm[:, 3] = 1.0
    qm[2, 7] = 0.0
    qm[1] = 0.0  # every row masked: no index passes, the score is 0
    q, t = _operands(q, t, dtype)
    got = M.match_scores_cuda(q, qm, t)
    torch.cuda.synchronize()
    ref = M.match_scores_plain(q, qm, t)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    assert bool((got[1] == 0).all())
    np.testing.assert_array_equal(got[[0, 2, 3]].argmax(1).cpu().numpy(), [0, 2, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_match_kernel_negative_sims_beat_padding(cuda_device, dtype):
    """With every sim negative (views anti-aligned with the query), the
    maxima are negative: a zero-filled pad row or column would win them."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, N, S, C = 2, 3, 48, 64
    q = M.l2_normalize(torch.rand(B, S, C, generator=g, device=cuda_device) + 0.5)
    t = -M.l2_normalize(torch.rand(N, S, C, generator=g, device=cuda_device) + 0.5)
    qm = torch.ones(B, S, device=cuda_device)
    q, t = _operands(q, t, dtype)
    got = M.match_scores_cuda(q, qm, t)
    torch.cuda.synchronize()
    ref = M.match_scores_plain(q, qm, t)
    assert bool((ref < 0).all())
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_match_kernel_int8_sims_are_exact(cuda_device):
    """One (query, view) pair whose score is a single row maximum: with one
    unmasked row whose argmaxes are not 0, the score is that row's maximum
    / S (S a power of two), so the kernel's sim there is compared bitwise
    with the plain one."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    S, C = 64, 1024
    q = M.quantize_int8(M.l2_normalize(torch.randn(1, S, C, generator=g, device=cuda_device)))
    t = M.quantize_int8(M.l2_normalize(torch.randn(1, S, C, generator=g, device=cuda_device)))
    t[0, 5] = q[0, 5]  # row 5's maximum is its copy at column 5, the largest in column 5
    qm = torch.zeros(1, S, device=cuda_device)
    qm[0, 5] = 1.0
    got = M.match_scores_cuda(q, qm, t)
    torch.cuda.synchronize()
    ref = M.match_scores_plain(q, qm, t)
    assert ref.item() > 0
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_match_kernel_dtype_codes(cuda_device):
    """bf16, fp32 and int8 operands launch; int8 counts as its own kernel;
    other or mixed types raise before any launch."""
    q = M.l2_normalize(torch.randn(2, 16, 32, device=cuda_device))
    qm = torch.ones(2, 16, device=cuda_device)
    kernels.reset_launches()
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        a, b = _operands(q, q, dtype)
        torch.testing.assert_close(M.match_scores_cuda(a, qm, b), M.match_scores_plain(a, qm, b),
                                   atol=1e-5, rtol=0)
    assert kernels.LAUNCHES["match_scores"] == 2 and kernels.LAUNCHES["match_scores_int8"] == 1
    for a, b in ((q.half(), q.half()), (M.quantize_int8(q), q.bfloat16()), (q.to(torch.int16), q.to(torch.int16))):
        with pytest.raises(TypeError):
            M.match_scores_cuda(a, qm, b)
    assert sum(kernels.LAUNCHES.values()) == 3


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


def _levels_and_grids(g, device):
    """The flow decoder's lookups and warps at a training step: (G, pyramid
    levels) 16^2 / 1, 32^2 / 2, 64^2 / 3, B = 8, C = 256, group 1, bf16,
    every input requiring grad."""
    for G, levels in ((16, 1), (32, 2), (64, 3)):
        feat = lambda: torch.randn(TRAIN_B, G, G, 256, generator=g, device=device).bfloat16().requires_grad_()
        flow = (_smooth_grid(g, TRAIN_B, G, device) - pixel_coords_grid(G, G, device=device)).requires_grad_()
        yield G, levels, feat(), feat(), flow


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["layernorm", "attention", "corr_window", "warp"])
def test_kernels_at_training_shapes(cuda_device, name, monkeypatch):
    """K1 at (8, 257, 1024), K2 on the qkv views at B = 8, K4 and K5 at the
    decoder's three levels at group 1, bf16: each forward against its plain
    version (one bf16 step) and its gradients against the plain path's."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=cuda_device)
    calls = []
    if name == "layernorm":
        x = (rn(TRAIN_B, 257, 1024) * 3 + 1.5).bfloat16().requires_grad_()
        scale, bias = (rn(1024) * 0.2 + 1).requires_grad_(), (rn(1024) * 0.5).requires_grad_()
        calls.append(((x, scale, bias), lambda: L.layernorm(x, scale, bias), lambda: L.layernorm_plain(x, scale, bias)))
    elif name == "attention":
        qkv = rn(TRAIN_B, 257, 3, 16, 64).bfloat16().requires_grad_()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        calls.append(((qkv,), lambda: A.attention(q, k, v), lambda: A.attention_plain(q, k, v)))
    else:
        for G, levels, f1, f2, flow in _levels_and_grids(g, cuda_device):
            if name == "corr_window":
                calls.append(((f1, f2, flow), lambda f1=f1, f2=f2, fl=flow, n=levels: CO.corr_lookup(f1, f2, fl, 2, n, 1),
                              lambda f1=f1, f2=f2, fl=flow, n=levels: CO._corr_lookup(f1, f2, fl, 2, n, 1)))
            else:
                calls.append(((f2, flow), lambda f=f2, fl=flow: S.warp_by_flow(f, fl, 1),
                              lambda f=f2, fl=flow: S._warp_by_flow(f, fl, 1)))
    for inputs, kernel, plain in calls:
        kernels.reset_launches()
        out = kernel()
        with monkeypatch.context() as m:
            m.setattr(CO, "corr_windows", CO.corr_windows_plain)
            m.setattr(S, "warp", S.warp_plain)
            ref = plain()
        torch.testing.assert_close(out.float(), ref.float(), **_bf16_tol(torch.bfloat16))
        _check_grads(out, inputs, ref, torch.bfloat16, name, 1)


@pytest.mark.cuda
def test_train_step_launches_on_the_card(cuda_device):
    """One ``train_step`` at vit_tiny_test width (4 blocks, batch 2 of
    synthetic sphere pairs): the forward launches K1 (2 per block per
    ``features`` call), K2, K4 and K5 (3 each), the backward none; with
    remat the backward recomputes the blocks through K1 and K2 again."""
    from picopose_tpu_torch.data.synthetic import make_pose, make_view
    from picopose_tpu_torch.train import step as ts

    views = {"tem": [make_view(make_pose(0.3 * i, 0.4, 0.45)) for i in range(2)],
             "real": [make_view(make_pose(0.3 * i + 0.15, 0.5, 0.6)) for i in range(2)]}
    batch = {f"{side}_{key}": np.stack([getattr(v, key) for v in vs])
             for side, vs in views.items() for key in ("rgb", "mask", "M", "K", "pose", "full_depth")}
    for remat in (False, True):
        state = ts.init_state(ts.make_optimizer(), 0, vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3),
                              remat_vit=remat)
        noise = torch.Generator(device=cuda_device).manual_seed(1)
        kernels.reset_launches()
        losses = ts.forward_train(state.model, batch, noise)
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == {"layernorm": 16, "attention": 8, "corr_window": 3, "warp": 3}
        kernels.reset_launches()
        losses["loss"].backward()
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == ({"layernorm": 16, "attention": 8} if remat else {})
        assert all(bool(torch.isfinite(v)) for v in losses.values())
        before = state.model.feature_extractor.dinov2.blocks[0].attn.qkv.weight.detach().clone()
        state.optimizer.step()
        assert not torch.equal(before, state.model.feature_extractor.dinov2.blocks[0].attn.qkv.weight)


@pytest.mark.cuda
def test_device_prefetch_uploads_every_batch_intact(cuda_device):
    """train/loop.py::device_prefetch on the card: pinned copies on a side
    stream, three ahead; a slow consumer that overwrites each batch on its
    own stream still reads every later batch as it was produced, in order."""
    import time

    from picopose_tpu_torch.train.loop import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"real_rgb": rng.standard_normal((8, 224, 224, 3)).astype(np.float32),
                "real_K": np.full((8, 3, 3), i, np.float32)} for i in range(12)]
    seen = 0
    for i, b in enumerate(device_prefetch(iter(batches), cuda_device, depth=3)):
        assert b["real_rgb"].device.type == "cuda"
        assert torch.equal(b["real_rgb"].cpu(), torch.from_numpy(batches[i]["real_rgb"]))
        assert torch.equal(b["real_K"].cpu(), torch.from_numpy(batches[i]["real_K"]))
        b["real_rgb"].mul_(0.0)  # the consumer's work on the batch
        time.sleep(0.05)
        seen += 1
    assert seen == len(batches)


# ---- the compiled training step (train/step.py::make_train_step): replays against eager steps


def _train_world(device, grad_accum=1, opt_type="AdamW", seed=0):
    """A vit_tiny_test state (bf16 compute, fp32 weights from ``seed``), its
    batch of 2 synthetic sphere pairs on the card and a noise generator."""
    from picopose_tpu_torch.data.synthetic import make_pose, make_view
    from picopose_tpu_torch.train import step as ts

    views = {"tem": [make_view(make_pose(0.3 * i, 0.4, 0.45)) for i in range(2)],
             "real": [make_view(make_pose(0.3 * i + 0.15, 0.5, 0.6)) for i in range(2)]}
    batch = {f"{side}_{key}": torch.as_tensor(np.stack([getattr(v, key) for v in vs]), device=device)
             for side, vs in views.items() for key in ("rgb", "mask", "M", "K", "pose", "full_depth")}
    tx = ts.make_optimizer(base_lr=1e-3, max_iters=100, warmup_iters=2, opt_type=opt_type, grad_accum=grad_accum)
    state = ts.init_state(tx, seed, vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3))
    return state, batch, torch.Generator(device=device).manual_seed(seed + 1)


def _train_tensors(state) -> dict:
    """Parameters, BatchNorm statistics, gradients, moments and ``count``."""
    opt = state.optimizer
    out = dict(state.model.state_dict())
    out.update({f"grad {i}": g for i, g in enumerate(opt.grads)})
    out.update({f"{k} {i}": t for k, m in opt.moments.items() for i, t in enumerate(m)})
    out["count"] = opt.count
    return out


def _assert_train_states_equal(a, b, what):
    ta, tb = _train_tensors(a), _train_tensors(b)
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not bad, (what, bad[:5])
    oa, ob = a.optimizer, b.optimizer
    assert (a.step, oa.updates, oa.mini_step) == (b.step, ob.updates, ob.mini_step), what


@pytest.mark.cuda
def test_train_step_makes_no_host_sync(cuda_device):
    """One eager step (its second: the first builds the kernels and uploads
    the cached constants) under ``set_sync_debug_mode("error")``: no op of
    the forward, the backward or the update waits on the card."""
    from picopose_tpu_torch.train import step as ts

    state, batch, noise = _train_world(cuda_device)
    ts.train_step(state, batch, noise)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = ts.train_step(state, batch, noise)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(v)) for v in losses.values())


@pytest.mark.cuda
@pytest.mark.parametrize("opt_type", ["AdamW", "SGD"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_compiled_step_equals_eager_steps(cuda_device, grad_accum, opt_type):
    """Three calls of ``make_train_step``'s step bitwise three eager steps
    from an equal state and noise generator: losses, parameters, running
    statistics, gradients, moments, ``count`` and the generator's state.
    With ``grad_accum`` 2 the calls replay two programs (accumulate,
    update)."""
    from picopose_tpu_torch.train import step as ts

    eager, batch, g_eager = _train_world(cuda_device, grad_accum, opt_type)
    graphed, _, g_graph = _train_world(cuda_device, grad_accum, opt_type)
    step = ts.make_train_step(graphed)
    for call in range(3):
        ref = ts.train_step(eager, batch, g_eager)
        got = step(graphed, batch, g_graph)
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], ref[k]) for k in ref), call
        _assert_train_states_equal(graphed, eager, call)
        assert torch.equal(g_graph.get_state(), g_eager.get_state()), call
    programs = 1 if grad_accum == 1 else 2
    assert sum(step.graphs.captures.values()) == programs and step.graphs.replays["train_step"] == 3


@pytest.mark.cuda
def test_first_compiled_call_is_one_step(cuda_device):
    """The capturing call (warm-up, capture, replay) leaves the state as one
    eager step does: the warm-up's update is undone.  The wrappers count
    the warm-up's launches (one step's forward), a replay's none; a replay's
    trace holds one step's kernels.  A swapped optimizer is captured anew."""
    from picopose_tpu_torch.train import step as ts

    eager, batch, g_eager = _train_world(cuda_device)
    graphed, _, g_graph = _train_world(cuda_device)
    step = ts.make_train_step(graphed)
    kernels.reset_launches()
    ts.train_step(eager, batch, g_eager)
    torch.cuda.synchronize()
    one_step = dict(kernels.LAUNCHES)
    assert one_step == {"layernorm": 16, "attention": 8, "corr_window": 3, "warp": 3}
    kernels.reset_launches()
    step(graphed, batch, g_graph)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == one_step
    _assert_train_states_equal(graphed, eager, "first call")
    assert step.graphs.captures["train_step"] == 1 and step.graphs.replays["train_step"] == 1
    kernels.reset_launches()
    traced = _traced_launches(lambda: step(graphed, batch, g_graph))
    assert not kernels.LAUNCHES and traced == one_step
    graphed.optimizer = graphed.optimizer.spec.init(graphed.model.parameters())
    step(graphed, batch, g_graph)
    assert step.graphs.captures["train_step"] == 2


# ---- compiled inference programs (utils/graphs.py): replays against eager calls

GRAPH_HYP, GRAPH_ITERS, GRAPH_VIEWS = 3, 16, 6


@pytest.fixture(scope="module")
def graph_world():
    """vit_tiny_test in bf16 with precast weights on the card, two 6-view
    banks of one shape and two query batches of 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.utils.precast import precast_inference_params

    dev = torch.device("cuda")
    model = PicoPose("vit_tiny_test", (0, 1, 2, 3), torch.bfloat16, device=dev)
    init_random_(model, 0)
    precast_inference_params(model)
    rng = np.random.default_rng(0)

    def bank_arrays():
        n = GRAPH_VIEWS
        pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        pose[:, 2, 3] = 0.5
        K = np.tile(np.diag([300.0, 300.0, 1.0]).astype(np.float32), (n, 1, 1))
        return [torch.as_tensor(a, device=dev) for a in (
            rng.normal(size=(n, 224, 224, 3)).astype(np.float32), (rng.random((n, 224, 224)) > 0.3).astype(np.float32),
            (rng.normal(size=(n, 64, 64, 3)) + [0, 0, 1]).astype(np.float32), pose, K,
            np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))]

    def batch():
        return {"real_rgb": torch.as_tensor(rng.normal(size=(2, 224, 224, 3)).astype(np.float32), device=dev),
                "real_mask": torch.as_tensor((rng.random((2, 224, 224)) > 0.3).astype(np.float32), device=dev),
                "real_M": torch.eye(3, device=dev).repeat(2, 1, 1),
                "real_K": torch.as_tensor(np.diag([300.0, 300.0, 1.0]), dtype=torch.float32, device=dev).repeat(2, 1, 1)}

    arrays = bank_arrays()
    banks = [P.build_bank(model, *arrays, chunk=4), P.build_bank(model, *bank_arrays(), chunk=4)]
    return P, model, arrays, banks, [batch(), batch()]


def _run_pair(P, graphs, model, batch, bank, g_graph, g_eager):
    """(EvalOutput, ids, order) of a graphed and an eager run_batch."""
    args = (model, batch, bank, GRAPH_HYP, GRAPH_ITERS, None)
    return P._ranked_graphed(graphs, *args, g_graph), P._ranked(*args, g_eager, None)


# the CUDA kernels each wrapper's entry point launches, as a profiler trace names them
KERNEL_SYMBOLS = {
    "layernorm": r"\blayernorm_(row|loop)_kernel<",
    "attention": r"\battention_(hopper|tc|f32)_kernel<",
    "match_scores": r"\bmatch_scores_(hopper_kernel<__nv_bfloat16>|f32_kernel\b)",
    "match_scores_int8": r"\bmatch_scores_hopper_kernel<signed char>",
    "corr_window": r"\bcorr_(tile|f32|any)_kernel\b",
    "warp": r"\bwarp_kernel<",
}


def _traced_launches(fn) -> dict:
    """Executions of each wrapper's kernels during ``fn()`` on the card, by
    kernel name in a torch.profiler trace (a graph's replay included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name, pattern in KERNEL_SYMBOLS.items():
            if re.search(pattern, e.key):
                seen[name] = seen.get(name, 0) + e.count
    return seen


def _assert_replay_equals_eager(got, ref):
    """Template ids, ranking order, success, ratios and scores bitwise; R
    and t within 1e-5 (fp32 PnP on the same correspondences and draws)."""
    (out, ids, order), (rout, rids, rorder) = got, ref
    assert torch.equal(ids, rids) and torch.equal(order, rorder)
    assert torch.equal(out.pnp_success, rout.pnp_success)
    assert torch.equal(out.inlier_ratio, rout.inlier_ratio)
    assert torch.equal(out.template_score, rout.template_score)
    torch.testing.assert_close(out.R, rout.R, atol=1e-5, rtol=0)
    torch.testing.assert_close(out.t, rout.t, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_run_batch_replay_equals_eager(graph_world):
    """The first call (warm-up, capture, replay) and the second (replay)
    equal the first and second eager calls from an equal generator state;
    warm-up and capture leave the caller's generator as an eager call
    leaves it.  Launches: the wrappers count the warm-up's (the eager
    call's), not the capture's, and nothing on a replay; the profiler
    trace of a replay holds the eager call's kernels."""
    from picopose_tpu_torch.utils.graphs import GraphCache

    P, model, _, banks, batches = graph_world
    graphs = GraphCache("cuda")
    g_graph = torch.Generator(device="cuda").manual_seed(3)
    g_eager = torch.Generator(device="cuda").manual_seed(3)
    for call in range(2):
        got, ref = _run_pair(P, graphs, model, batches[0], banks[0], g_graph, g_eager)
        torch.cuda.synchronize()
        _assert_replay_equals_eager(got, ref)
        assert torch.equal(g_graph.get_state(), g_eager.get_state()), call
    assert graphs.captures["run_batch"] == 1 and graphs.replays["run_batch"] == 2
    kw = dict(hyp=GRAPH_HYP, pnp_iters=GRAPH_ITERS)
    kernels.reset_launches()
    traced_eager = _traced_launches(lambda: P.run_batch(model, batches[0], banks[0], generator=g_eager, **kw))
    eager = dict(kernels.LAUNCHES)
    assert eager == traced_eager == {"layernorm": 8, "attention": 4, "match_scores": 1, "corr_window": 3, "warp": 3}
    kernels.reset_launches()
    P.run_batch_graphed(GraphCache("cuda"), model, batches[0], banks[0], generator=g_graph, **kw)
    assert dict(kernels.LAUNCHES) == eager  # the warm-up; the capture and its replay count nothing
    kernels.reset_launches()
    replay = _traced_launches(lambda: P.run_batch_graphed(graphs, model, batches[0], banks[0], generator=g_graph, **kw))
    assert not kernels.LAUNCHES and replay == eager


@pytest.mark.cuda
def test_queued_calls_do_not_alias(graph_world):
    """Two calls queued with different inputs before any is read each keep
    their own results."""
    from picopose_tpu_torch.utils.graphs import GraphCache

    P, model, _, banks, batches = graph_world
    graphs = GraphCache("cuda")
    g_graph = torch.Generator(device="cuda").manual_seed(5)
    g_eager = torch.Generator(device="cuda").manual_seed(5)
    args = (GRAPH_HYP, GRAPH_ITERS, None)
    got = [P._ranked_graphed(graphs, model, b, banks[0], *args, g_graph) for b in batches]
    ref = [P._ranked(model, b, banks[0], *args, g_eager, None) for b in batches]
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _assert_replay_equals_eager(a, b)
    assert not torch.equal(got[0][0].template_score, got[1][0].template_score)


@pytest.mark.cuda
def test_bank_swap_gives_each_banks_eager_result(graph_world):
    """Banks of one shape share one program and one slot: each call copies
    in the bank it is given when the slot holds another."""
    from picopose_tpu_torch.utils.graphs import GraphCache

    P, model, _, banks, batches = graph_world
    graphs = GraphCache("cuda")
    g_graph = torch.Generator(device="cuda").manual_seed(7)
    g_eager = torch.Generator(device="cuda").manual_seed(7)
    for bank in (banks[0], banks[1], banks[1], banks[0]):
        got, ref = _run_pair(P, graphs, model, batches[0], bank, g_graph, g_eager)
        torch.cuda.synchronize()
        _assert_replay_equals_eager(got, ref)
    assert graphs.captures["run_batch"] == 1 and graphs.replays["run_batch"] == 4
    assert len(graphs._slots) == 1


@pytest.mark.cuda
def test_bank_and_preprocess_programs_equal_eager(graph_world):
    """build_bank_graphed (chunks of 4 and 2: two programs, three replays)
    and preprocess_frame_graphed equal the eager functions bitwise."""
    from picopose_tpu_torch.ops.preprocess import preprocess_frame, preprocess_frame_graphed
    from picopose_tpu_torch.utils.graphs import GraphCache

    P, model, arrays, banks, _ = graph_world
    graphs = GraphCache("cuda")
    got = P.build_bank_graphed(graphs, model, *arrays, chunk=4)
    for a, b in zip(got.feats + got.dpt, banks[0].feats + banks[0].dpt):
        assert torch.equal(a, b)
    assert graphs.captures["bank_chunk"] == 2 and graphs.replays["bank_chunk"] == 2
    g = torch.Generator(device="cuda").manual_seed(1)
    frame = torch.randint(0, 256, (240, 320, 3), generator=g, device="cuda", dtype=torch.uint8)
    masks = torch.zeros(3, 240, 320, dtype=torch.uint8, device="cuda")
    for i, (y, x) in enumerate([(10, 20), (100, 150), (30, 200)]):
        masks[i, y : y + 60 + 10 * i, x : x + 50] = 1
    for call in range(2):
        got = preprocess_frame_graphed(graphs, frame, masks, out=224, pts=64)
        ref = preprocess_frame(frame, masks, out=224, pts=64)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (call, k)
        frame = frame.flip(0).contiguous()
    assert graphs.captures["preprocess_frame"] == 1 and graphs.replays["preprocess_frame"] == 2


@pytest.mark.cuda
def test_capture_failure_raises(graph_world):
    """A program that reads a value back to the host cannot be captured:
    the call raises, no program is kept, the launch counts are as before
    and nothing ran eagerly in its place."""
    from picopose_tpu_torch.utils.graphs import GraphCache

    graphs = GraphCache("cuda")
    x = torch.randn(4, 64, device="cuda")
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")

    def program(x):
        y = L.layernorm(x, w, b)
        return y * float(y.sum())  # a host read: refused under capture

    kernels.reset_launches()
    for _ in range(2):
        with pytest.raises(Exception):
            graphs.run("bad", program, (x,))
    torch.cuda.synchronize()
    assert not graphs._programs and not graphs.replays
    assert dict(kernels.LAUNCHES) == {"layernorm": 2}  # the two warm-ups, nothing more
