#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PicoPose on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit; build every CUDA kernel of the port
     from picopose_tpu_torch/kernels/csrc (one nvcc per source, in parallel);
  2. each kernel at the main path's shapes against its plain PyTorch
     version (stated tolerance), with kernel / plain / library-call device
     times (kernel time per call in a torch.profiler trace, inputs rotated
     so L2 does not hold them), the per-call time back to back on the
     host clock where the host can dominate (K1, K2), and its bound; K1 at
     the query batch's and a bank chunk's (rows, 257, 1024); K2 at
     contiguous (16, 16, 257, 64) and on views of a (B, 257, 3, 16, 64)
     qkv projection for B = 16 and 32, with SDPA on the same tensors; K3
     beside a cuBLAS bf16 GEMM of the table alone and with the reductions,
     and its int8 branch on the same queries and views quantised as the
     serving mode does, beside torch._int_mm of the table alone and with
     the reductions;
     the corr-window kernel once per decoder level (16^2 with one pyramid
     level, 32^2 with two, 64^2 with three) on wild centres (windows
     scattered and pushed past the map edges: mostly its per-pixel path,
     with its tile counts) and the warp kernel at its three grids, 80
     streams sharing 16 query maps (group 5), on wild centres (few taps
     shared between neighbouring pixels), per grid beside grid_sample and
     its bound;
  3. the main path at full ViT-L width (dinov2_vitl14, taps 5/11/17/23,
     bf16, seeded random weights): build_bank over 162 views (chunk 32),
     then run_batch for 16 queries x 5 hypotheses with 150 PnP
     iterations, with every kernel's launch counter set to 0 just before
     and read just after (168 attention, 336 LN, 3 corr-window and 3 warp
     launches; attention copies no q, k, v), the flow decoder's lookup
     inputs captured; outputs checked (shapes,
     finite, R^T R = I, ratios in [-1, 1] ranked best first; each query
     finds its own template view); then bank-build times and a profile of
     one bank build (K1/K2 device ms, copy kernels), the stages-1-2 batch
     time alone, the run_batch time and crops/s, and profiles (device time
     by kernel, the share of the stage-3 convs and of PnP, idle share);
     then the corr-window and warp kernels on the captured main-path
     inputs (the flow decoder's lookups and warps) against their plain
     versions, timed per level and grid (K4 with its tile counts, K5
     beside grid_sample and its bound): these times are the JSON line's;
  4. the same path at a small size (vit_tiny_test, 6 views, 2 queries) on
     the card against the plain CPU path at the same weights, fp32 and
     bf16: stages 1-2, the stage-3 flows and certainties, and ransac_pnp
     on identical correspondences with identical draws;
  5. the serving entry point at full ViT-L width: a seeded bf16
     ``PoseEstimator`` (precast weights) with the 162-view bank registered,
     one 960 x 1280 uint8 frame holding 16 template views on a 4 x 4 grid
     of 224^2 squares, 16 full-square masks plus one RLE and one bbox-only
     detection (18: two chunks of 16, the second padded).  Host and
     on-device crops of both chunks agree within 1e-3; ``estimate`` with
     each, with the launch counts of one call (set to 0 just before, read
     just after), the ranked poses of every chunk checked and the top-1
     view of each detection the pasted one; ms per frame (median of 10
     after a warm-up), host decode ms and preprocess_frame device ms; the
     serving modes, each with the launch counts of one ``estimate``:
     PICOPOSE_MATCH_INT8=1 (K3's int8 branch, two launches, top-1 as bf16
     on the 16 pasted crops), PICOPOSE_MATCH_FP32=1 (K3's fp32 path),
     quantize_stage3 (flows against the float path as relative RMS, stage-3
     device time of both); TF32: with the caller's matmul and cuDNN TF32
     flags on, one ``estimate`` and ``stage2_poses`` bitwise equal to the
     calls with both off, the flags as the caller set them afterwards; the
     bank build with and without precast (device busy, copy kernels; banks
     bitwise equal); and a bank file round trip, bitwise;
  6. gradients at full width (``gradient_phase``): ViT-L features of 2
     crops and one flow-decoder pass at 16^2 / 32^2 / 64^2 for 1 query x 5
     hypotheses, a seeded random projection as the loss, gradients to the
     images, both pyramids, the initial flow, every LN scale and every qkv
     weight: finite and non-zero, within a relative RMS of the same
     computation through the plain versions, and the forward's launches
     (48 LN, 24 attention, 3 corr-window, 3 warp; none in the backward).
Then the kernels as one JSON line (K3's int8 row with its launches from
the int8-matching ``estimate``), the card line, and the result line.
The script leaves PyTorch's TF32 flags at their defaults (cuDNN may take
TF32 for fp32 convolutions): the package pins its fp32 work itself
(``device.full_fp32``), and phase 5 checks that.  Inputs and weights
are drawn from SEED; the stage-3 heads' predict convs are scaled
(``calm_stage3_heads_``) so stage 3 refines the stage-2 seed and PnP sees
thousands of correspondences per hypothesis, as a trained model gives it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# the kernels of the default path; K3's int8 branch runs under PICOPOSE_MATCH_INT8=1
DEFAULT_PATH_KERNELS = ("layernorm", "attention", "match_scores", "corr_window", "warp")
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_INT8_OPS = 1979e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, inputs, iters: int = 20) -> float:
    """Mean ms per call over ``iters`` calls after warm-up, cycling through
    ``inputs`` (argument tuples) so consecutive calls read different data."""
    for a in inputs:
        fn(*a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def device_ms(fn, inputs, iters: int = 20, floor_ms: float = 0.0, or_events: bool = False) -> float:
    """Device ms per call: the kernel time of ``iters`` calls, summed over a
    torch.profiler trace (so host overhead between launches is left out),
    inputs cycled as in ``cuda_ms``.  A trace whose time per call is below
    ``floor_ms`` (the work's bound: no call can be faster) lost device
    events and is taken again; after three such traces ``or_events`` times
    the calls with CUDA events instead (``cuda_ms``), else the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in inputs:
        fn(*a)
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
        us = sum(dev_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if us > 0 and us / iters / 1e3 >= floor_ms:
            return us / iters / 1e3
        print(f"[profile] a trace held {us!r} us of device time for {iters} calls, below the bound "
              f"{floor_ms!r} ms per call; profiling again")
    if or_events:
        ms = cuda_ms(fn, inputs, iters)
        print(f"[profile] timed with CUDA events instead: {ms!r} ms per call")
        return ms
    check(False, "the profiler saw the device time of every call")


def timed(fn, inputs, iters: int = 20) -> tuple[float, float]:
    """(device ms per call, ms per call back to back on the host clock)."""
    return device_ms(fn, inputs, iters), cuda_ms(fn, inputs, iters)


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(g: torch.Generator) -> dict:
    """Phase 2: every kernel at main-path shapes against its plain version."""
    import torch.nn.functional as F

    from picopose_tpu_torch.ops import attention as A
    from picopose_tpu_torch.ops import layernorm as L
    from picopose_tpu_torch.ops import matching as M

    dev = torch.device("cuda")
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = {}

    # K1: LayerNorm of the bf16 residual stream, query batch and bank chunk
    scale, bias = rn(1024) * 0.2 + 1, rn(1024) * 0.5
    w16, b16 = scale.bfloat16(), bias.bfloat16()
    for rows in (16, 32):
        xs = [(rn(rows, 257, 1024) * 3 + 1.5).bfloat16() for _ in range(8)]  # 8 x >= 8.4 MB > 50 MB L2
        args = [(x, scale, bias) for x in xs]
        got, ref = L.layernorm_cuda(*args[0]), L.layernorm_plain(*args[0])
        torch.cuda.synchronize()
        # one bf16 rounding step apart at most: rtol 2^-7
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3, rtol=2**-7)
        r = dict(
            err=(got.float() - ref.float()).abs().max().item(), tol="atol 1e-3 + rtol 2^-7",
            ms_call=cuda_ms(L.layernorm_cuda, args), plain_ms=device_ms(L.layernorm_plain, args),
            bound=bound(2 * xs[0].numel() * 2 + 2 * 1024 * 4, 8 * xs[0].numel(), H100_FP32_FLOPS),
        )
        r["ms"], r["library_ms"], r["library_call"] = (
            device_ms(L.layernorm_cuda, args),
            *timed(lambda x, s, b: F.layer_norm(x, (1024,), w16, b16, 1e-6), args),
        )
        print(f"[kernel] layernorm ({rows}, 257, 1024) bf16: device ms kernel {r['ms']!r}, "
              f"F.layer_norm {r['library_ms']!r}; per call back to back kernel {r['ms_call']!r}, "
              f"F.layer_norm {r['library_call']!r}; bound {r['bound'][0]!r} ms")
        out.setdefault("layernorm", r)  # the query batch's shape goes in the JSON line
        del xs, args, got, ref

    # K2: the ViT-L's attention in bf16: contiguous (16, 16, 257, 64), then
    # the main path's layout (views of a (B, N, 3, H, D) qkv projection) at
    # the query batch (B = 16) and a bank chunk (B = 32); SDPA on the same
    # tensors
    N, H, D = 257, 16, 64
    for layout, B in (("contiguous", 16), ("qkv views", 16), ("qkv views", 32)):
        sets = []
        for _ in range(3):  # 3 x >= 25 MB: rotated past L2
            if layout == "contiguous":
                sets.append(tuple(rn(B, H, N, D).bfloat16() for _ in range(3)))
            else:
                qkv = rn(B, N, 3, H, D).bfloat16()
                sets.append(tuple(qkv[:, :, i].transpose(1, 2) for i in range(3)))
        A.INPUT_COPIES.clear()
        got, ref = A.attention_cuda(*sets[0]), A.attention_plain(*sets[0])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=2**-7)
        check(not A.INPUT_COPIES, f"attention reads {layout} in place: {dict(A.INPUT_COPIES)}")
        BH = B * H
        r = dict(
            err=(got.float() - ref.float()).abs().max().item(), tol="atol 1e-2 + rtol 2^-7",
            ms_call=cuda_ms(A.attention_cuda, sets), plain_ms=device_ms(A.attention_plain, sets[:1], 5),
            bound=bound(4 * BH * N * D * 2, 4 * BH * N * N * D, H100_BF16_FLOPS),
        )
        r["ms"] = device_ms(A.attention_cuda, sets)
        r["library_ms"], r["library_call"] = timed(F.scaled_dot_product_attention, sets)
        print(f"[kernel] attention ({B}, {H}, {N}, {D}) bf16 {layout}: max_abs_err {r['err']!r}; device ms "
              f"kernel {r['ms']!r}, SDPA {r['library_ms']!r}; per call back to back kernel "
              f"{r['ms_call']!r}, SDPA {r['library_call']!r}; bound {r['bound'][0]!r} ms")
        if (layout, B) == ("qkv views", 16):
            out["attention"] = r  # the main path's query batch goes in the JSON line
        del sets, got, ref

    # K3: 16 queries against a 162-view bf16 bank (S = 256, C = 1024); each
    # query is a noisy copy of one view so the table has structure
    B, Nv, S, C = 16, 162, 256, 1024
    t = M.l2_normalize(rn(Nv, S, C))
    q = M.l2_normalize(t[torch.arange(B, device=dev) * 10] + 0.5 * C**-0.5 * rn(B, S, C))
    qm = (torch.rand(B, S, generator=g, device=dev) > 0.3).float()
    q32, t32 = q, t
    q, t = q.bfloat16(), t.bfloat16()
    margs = [(q, qm, t)]
    got, ref = M.match_scores_cuda(*margs[0]), M.match_scores_plain(*margs[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    check(bool((got.argmax(1) == torch.arange(B, device=dev) * 10).all()), "planted views win")

    def library(q, qm, t):  # cuBLAS bf16 GEMM of the whole table + reductions
        sim = torch.matmul(q.reshape(B * S, C), t.reshape(Nv * S, C).T).view(B, S, Nv, S)
        sim = sim * qm[:, :, None, None].to(sim.dtype)
        rowmax, colmax = sim.amax(3), sim.amax(1)
        ok = (qm[:, :, None] > 0) & (sim[..., 0] < rowmax) & (sim[:, 0].transpose(1, 2) < colmax.transpose(1, 2))
        return (rowmax.float() * ok).sum(1) / S

    out["match_scores"] = dict(
        err=(got - ref).abs().max().item(), tol="atol 1e-5",
        ms=device_ms(M.match_scores_cuda, margs, iters=10),
        plain_ms=device_ms(M.match_scores_plain, margs, iters=5),
        library_ms=device_ms(library, margs, iters=5),
        bound=bound(q.numel() * 2 + qm.numel() * 4 + t.numel() * 2 + B * Nv * 4,
                    2 * B * Nv * S * S * C, H100_BF16_FLOPS),
    )
    gemm = device_ms(lambda q, qm, t: torch.matmul(q.reshape(B * S, C), t.reshape(Nv * S, C).T), margs, iters=5)
    r = out["match_scores"]
    print(f"[kernel] match_scores ({B}, {Nv}, {S}, {C}) bf16: device ms kernel {r['ms']!r}, cuBLAS bf16 GEMM "
          f"of the table alone {gemm!r}, GEMM + reductions {r['library_ms']!r}; bound {r['bound'][0]!r} ms "
          f"= {r['bound'][0] / r['ms']!r} of the bf16 peak")
    out["match_scores_int8"] = match_int8_checks(q32, qm, t32)
    out.update(stage3_kernel_checks(g))
    for name, r in out.items():
        print(f"[kernel] {name}: max_abs_err {r['err']!r} ({r['tol']}), kernel {r['ms']!r} ms, "
              f"plain {r['plain_ms']!r} ms, library {r['library_ms']!r} ms, "
              f"bound {r['bound'][0]!r} ms ({r['bound'][1]})")
    return out


def match_int8_checks(q32: torch.Tensor, qm: torch.Tensor, t32: torch.Tensor) -> dict:
    """K3's int8 branch at the main path's shape: the serving mode's
    quantisation of the same normalised q and t as the bf16 check, against
    the plain version (exact sums; the scores sum the row maxima in
    another order, atol 1e-5), beside torch._int_mm (cuBLASLt s8 x s8 ->
    s32) of the whole table alone and with the same reductions."""
    from picopose_tpu_torch.ops import matching as M

    B, S, C = q32.shape
    Nv = t32.shape[0]
    q, t = M.quantize_int8(q32), M.quantize_int8(t32)
    args = [(q, qm, t)]
    got, ref = M.match_scores_cuda(*args[0]), M.match_scores_plain(*args[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    ref32 = M.match_scores_plain(q32, qm, t32)
    check(bool((got.argmax(1) == ref32.argmax(1)).all()), "int8 scores pick the fp32 scores' views")

    def gemm(q, qm, t):  # (B S, C) x (C, N S) -> s32; the second operand column-major
        return torch._int_mm(q.reshape(B * S, C), t.reshape(Nv * S, C).t())

    def library(q, qm, t):
        sim = (gemm(q, qm, t).float() * M.INT8_INV_SQ).view(B, S, Nv, S) * qm[:, :, None, None]
        rowmax, colmax = sim.amax(3), sim.amax(1)
        ok = (qm[:, :, None] > 0) & (sim[..., 0] < rowmax) & (sim[:, 0].transpose(1, 2) < colmax.transpose(1, 2))
        return (rowmax * ok).sum(1) / S

    torch.testing.assert_close(library(*args[0]), ref, atol=1e-5, rtol=0)
    r = dict(
        err=(got - ref).abs().max().item(), tol="atol 1e-5 (sims exact; the score sums in another order)",
        ms=device_ms(M.match_scores_cuda, args, iters=10),
        plain_ms=device_ms(M.match_scores_plain, args, iters=3),
        library_ms=device_ms(library, args, iters=5),
        bound=bound(q.numel() + qm.numel() * 4 + t.numel() + B * Nv * 4, 2 * B * Nv * S * S * C, H100_INT8_OPS),
    )
    g_ms = device_ms(gemm, args, iters=5)
    print(f"[kernel] match_scores int8 ({B}, {Nv}, {S}, {C}): max_abs_err {r['err']!r} against the plain version "
          f"({(got - ref32).abs().max().item()!r} against fp32 operands); device ms kernel {r['ms']!r}, "
          f"torch._int_mm of the table alone {g_ms!r}, _int_mm + reductions {r['library_ms']!r}; bound "
          f"{r['bound'][0]!r} ms = {r['bound'][0] / r['ms']!r} of the int8 peak")
    return r


def stage3_kernel_checks(g: torch.Generator) -> dict:
    """K4 and K5 at the flow decoder's shapes for 16 queries x 5 hypotheses
    (80 streams over 16 query maps, C = 256, bf16).  Times are summed over
    the launches of one batch (K4: one per decoder level, on wild centres;
    K5: three grids) and reported per launch, so launches x ms is the
    batch's device time."""
    from picopose_tpu_torch.geom.grids import pixel_coords_grid

    dev = torch.device("cuda")
    B2, group, C = 16, 5, 256
    B = B2 * group
    sets = {16: 6, 32: 3, 64: 1}  # input sets rotated per call: > 50 MB of L2

    def centres(G, level):
        flow = torch.randn(B, G, G, 2, generator=g, device=dev) * 3
        flow[:, ::5] += torch.sign(torch.randn(B, 1, G, 2, generator=g, device=dev)) * G * 0.9
        return ((pixel_coords_grid(G, G, device=dev) + flow) / 2.0**level).reshape(B, G * G, 2)

    def rows(n, P):
        return torch.randn(n, P, C, generator=g, device=dev).bfloat16()

    tol = dict(atol=1e-2, rtol=2**-7)  # one bf16 step where fp32 sums straddle a rounding boundary
    res = {}
    pyramid = lambda G, L: [(rows(B2, (G >> i) ** 2).view(B2, G >> i, G >> i, C), i) for i in range(L)]
    args = [[(rows(B, G * G).view(B, G, G, C), pyramid(G, L), centres(G, 0).view(B, G, G, 2), 2, group)
             for _ in range(sets[G])] for G, L in ((16, 1), (32, 2), (64, 3))]
    res["corr_window"] = corr_timing("wild centres", args, tol)
    del args

    res["warp"] = warp_timing("wild centres", [
        [(rows(B2, G * G), centres(G, 0), G, G, group) for _ in range(sets[G])] for G in (16, 32, 64)])
    return res


def warp_timing(what: str, calls: list) -> dict:
    """K5 per grid, each a list of (feat, cen, H, W, group) argument sets
    rotated per call: the kernel against the plain version (one bf16 step
    at most), device ms of the kernel, the plain version and F.grid_sample
    (one call on the expanded NCHW maps and a normalised grid), the bound.
    Returns the row for one batch, per launch (a launch is one grid)."""
    import torch.nn.functional as F

    from picopose_tpu_torch.ops import sample as SA

    tot = dict(ms=0.0, plain_ms=0.0, lib=0.0, b=0.0, err=0.0)
    for sets in calls:
        feat, cen, H, W, group = sets[0]
        B2, P, C = feat.shape
        B = cen.shape[0]
        got, ref = SA.warp_cuda(*sets[0]), SA.warp_plain(*sets[0])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=2**-7)
        err = (got.float() - ref.float()).abs().max().item()

        def library_args(feat, cen, H, W, group):
            # expanded NCHW input and normalised grid; grid_sample takes one
            # dtype, so the grid is in the features' dtype too
            x = feat.reshape(B2, H, W, C).permute(0, 3, 1, 2).repeat_interleave(group, 0).contiguous()
            norm = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=cen.device)
            return x, (cen * norm - 1.0).reshape(B, H, W, 2).to(x.dtype)

        nbytes = (feat.numel() + got.numel()) * feat.element_size() + cen.numel() * 4
        bd = bound(nbytes, B * P * 4 * C * 2, H100_BF16_FLOPS)
        lib_args = [library_args(*a) for a in sets]
        lib = device_ms(lambda x, grid: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                                      align_corners=True), lib_args, floor_ms=bd[0], or_events=True)
        ms = device_ms(SA.warp_cuda, sets, floor_ms=bd[0])
        plain = device_ms(SA.warp_plain, sets[:1], iters=3, floor_ms=bd[0])
        print(f"[kernel] warp {what} G={H}: max_abs_err {err!r}, kernel {ms!r} ms, plain {plain!r} ms, "
              f"grid_sample {lib!r} ms, bound {bd[0]!r} ms ({bd[1]}) = {bd[0] / ms!r} of the kernel's time")
        tot.update(ms=tot["ms"] + ms, plain_ms=tot["plain_ms"] + plain, lib=tot["lib"] + lib,
                   err=max(tot["err"], err), b=tot["b"] + bd[0])
        del lib_args, got, ref
    n = len(calls)
    print(f"[kernel] warp {what} per batch ({n} launches): kernel {tot['ms']!r} ms, plain {tot['plain_ms']!r} ms, "
          f"grid_sample {tot['lib']!r} ms, bound {tot['b']!r} ms = {tot['b'] / tot['ms']!r} of the kernel's time")
    return dict(
        err=tot["err"], tol="atol 1e-2 + rtol 2^-7", ms=tot["ms"] / n, plain_ms=tot["plain_ms"] / n,
        library_ms=tot["lib"] / n, bound=(tot["b"] / n, "bytes"),
    )


def corr_timing(what: str, calls: list, tol: dict) -> dict:
    """K4 per decoder level, each a list of (f1, maps, grid, radius, group)
    argument sets rotated per call: the kernel against the plain version,
    device ms, the tile counts of the first set, the bound.  Returns the
    row for one batch, per launch (a launch is one decoder level)."""
    from picopose_tpu_torch.ops import corr as CO

    tot = dict(ms=0.0, plain_ms=0.0, b=0.0, f=0.0, err=0.0)
    for sets in calls:
        f1, maps, grid, radius, group = sets[0]
        B, G, W, C = f1.shape
        L = len(maps)
        stats = torch.zeros(3, dtype=torch.int32, device=f1.device)
        got = CO.corr_windows_cuda(*sets[0], stats=stats)
        ref = CO.corr_windows_plain(*sets[0])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        use = (diff / (tol["atol"] + tol["rtol"] * ref.float().abs())).max().item()
        ms = device_ms(CO.corr_windows_cuda, sets)
        plain = device_ms(CO.corr_windows_plain, sets[:1], iters=3)
        nbytes = (f1.numel() + sum(m.numel() for m, _ in maps)) * f1.element_size() + grid.numel() * 4 \
            + got.numel() * got.element_size()
        flops = B * G * W * L * 36 * C * 2  # the 36 cells of each window
        bd = bound(nbytes, flops, H100_BF16_FLOPS)
        tiles, mixed, pixels = stats.tolist()
        print(f"[kernel] corr_window {what} G={G} levels={L}: max_abs_err {err!r} (largest |plain| "
              f"{ref.float().abs().max().item()!r}; at most {use!r} of the tolerance), kernel {ms!r} ms, "
              f"plain {plain!r} ms, bound {bd[0]!r} ms ({bd[1]}); tile-levels {tiles}, with per-pixel "
              f"pixels {mixed}, per-pixel pixel-levels {pixels} of {B * G * W * L}")
        tot.update(ms=tot["ms"] + ms, plain_ms=tot["plain_ms"] + plain, err=max(tot["err"], err),
                   b=tot["b"] + nbytes / H100_BYTES_PER_S * 1e3, f=tot["f"] + flops / H100_BF16_FLOPS * 1e3)
    n = len(calls)
    print(f"[kernel] corr_window {what} per batch ({n} launches): kernel {tot['ms']!r} ms, "
          f"plain {tot['plain_ms']!r} ms, bound {max(tot['b'], tot['f'])!r} ms")
    return dict(
        err=tot["err"], tol="atol 1e-2 + rtol 2^-7", ms=tot["ms"] / n, plain_ms=tot["plain_ms"] / n,
        library_ms=None, bound=(max(tot["b"], tot["f"]) / n, "bytes" if tot["b"] >= tot["f"] else "operations"),
    )


@torch.inference_mode()
def corr_on_main_path(seen: list) -> dict:
    """K4 on the flow decoder's inputs captured from one run_batch (its three
    corr_lookup calls): the JSON line's K4 times."""
    from picopose_tpu_torch.geom.grids import pixel_coords_grid
    from picopose_tpu_torch.ops.resize import avg_pool2d

    calls = []
    for feat1, feat2, flow, radius, L, group in seen:
        G, W = feat1.shape[1:3]
        grid = pixel_coords_grid(G, W, device=flow.device) + flow.float()
        maps, pooled = [], feat2
        for i in range(L):
            pooled = pooled if i == 0 else avg_pool2d(pooled, 2)
            maps.append((pooled, i))
        n = {16: 6, 32: 3}.get(G, 1)  # copies rotated per call: > 50 MB of L2
        calls.append([(feat1, maps, grid, radius, group)] + [
            (feat1.clone(), [(m.clone(), i) for m, i in maps], grid.clone(), radius, group) for _ in range(n - 1)])
    return corr_timing("main-path centres", calls, dict(atol=1e-2, rtol=2**-7))


@torch.inference_mode()
def warp_on_main_path(seen: list) -> dict:
    """K5 on the flow decoder's inputs captured from one run_batch (its three
    warp_by_flow calls): the JSON line's K5 times."""
    from picopose_tpu_torch.geom.grids import pixel_coords_grid

    calls = []
    for feat, flow, group in seen:
        B2, G, W, C = feat.shape
        cen = (pixel_coords_grid(G, W, device=flow.device) + flow.float()).reshape(flow.shape[0], G * W, 2)
        f = feat.reshape(B2, G * W, C)
        n = {16: 6, 32: 3}.get(G, 1)  # copies rotated per call: > 50 MB of L2
        calls.append([(f, cen, G, W, group)] + [(f.clone(), cen.clone(), G, W, group) for _ in range(n - 1)])
    return warp_timing("main-path centres", calls)


def calm_stage3_heads_(model) -> None:
    """Scale the flow heads' predict convs by 0.01 and set the mask heads'
    predict bias to 4: stage 3 then refines the stage-2 seed and keeps most
    cells valid.  Unscaled random heads scramble the flow and leave ~1% of
    the cells valid, on which RANSAC works on a handful of noisy points."""
    with torch.no_grad():
        for head in model.flow_decoder.flow_pred:
            head.predict.weight.mul_(0.01)
        for head in model.flow_decoder.mask_pred:
            head.predict.bias.fill_(4.0)


def synthetic_world(n_views: int, queries: list[int], seed: int):
    """Seeded template bank inputs and a query batch whose crop i is an exact
    copy of template view queries[i] (so stage 1 must select that view)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rgb = rng.normal(size=(n_views, 224, 224, 3)).astype(f32)
    yy, xx = np.mgrid[:224, :224]
    cx, cy, rad = (rng.uniform(80, 144, (3, n_views)) * [[1], [1], [0.8]])
    mask = ((xx - cx[:, None, None]) ** 2 + (yy - cy[:, None, None]) ** 2 < rad[:, None, None] ** 2).astype(f32)
    pose = np.zeros((n_views, 4, 4))
    for i in range(n_views):
        qr, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose[i, :3, :3] = qr * np.sign(np.linalg.det(qr))
    pose[:, :3, 3] = np.c_[rng.normal(0, 0.02, (n_views, 2)), rng.uniform(0.4, 0.8, n_views)]
    pose[:, 3, 3] = 1
    K = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]]), (n_views, 1, 1))
    s = rng.uniform(0.8, 1.6, n_views)
    M = np.zeros((n_views, 3, 3))
    M[:, 0, 0] = M[:, 1, 1] = s
    M[:, :2, 2] = rng.uniform(-300, -100, (n_views, 2))
    M[:, 2, 2] = 1
    pts3d = rng.normal(size=(n_views, 64, 64, 3)).astype(f32)
    bank = (rgb, mask, pts3d, pose.astype(f32), K.astype(f32), M.astype(f32))
    qi = np.asarray(queries)
    batch = {"real_rgb": rgb[qi], "real_mask": mask[qi], "real_M": M[qi].astype(f32), "real_K": K[qi].astype(f32)}
    return bank, batch


def run_slice(model, bank_np, batch, hyp, chunk):
    from picopose_tpu_torch.eval.pipeline import build_bank, select_templates, stage2_poses

    bank = build_bank(model, *bank_np, chunk=chunk)
    feats_real, scores, ids = select_templates(model, batch, bank, hyp=hyp)
    pred_Ms, poses = stage2_poses(model, batch, bank, feats_real, ids)
    return bank, scores, ids, pred_Ms, poses


def check_outputs(name, scores, ids, pred_Ms, poses, n_views, expected_top1):
    for what, x in (("scores", scores), ("pred_Ms", pred_Ms), ("poses", poses)):
        check(bool(torch.isfinite(x).all()), f"{name}: {what} finite")
    check(bool(((ids >= 0) & (ids < n_views)).all()), f"{name}: ids in [0, {n_views})")
    top1 = ids[:, 0].cpu().numpy()
    hits = int((top1 == np.asarray(expected_top1)).sum())
    print(f"[{name}] top-1 is the query's own view for {hits}/{len(top1)} queries")
    check(hits == len(top1), f"{name}: every query selects its own template view")
    R = poses[:, :3, :3].double()
    orth = (R.transpose(1, 2) @ R - torch.eye(3, dtype=R.dtype, device=R.device)).abs().amax().item()
    print(f"[{name}] max |R^T R - I| = {orth!r}")
    check(orth < 1e-4, f"{name}: stage-2 rotations orthonormal")


def profile_batch(run, top: int = 16) -> tuple[float, float, list]:
    """Device time by kernel over one call of ``run`` (torch.profiler);
    returns the device's busy ms, the device ms under aten::conv2d and
    aten::conv_transpose2d, and the device events by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tot_us = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    conv_ms = sum(tot_us(e) for e in averages if e.key in ("aten::conv2d", "aten::conv_transpose2d")) / 1e3
    print(f"[profile] device busy {busy_ms!r} ms, convolutions {conv_ms!r} ms "
          f"({wall_ms!r} ms wall under the profiler)")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"[profile] {dev_us(e) / 1e3!r} ms x{e.count} {e.key[:100]}")
    return busy_ms, conv_ms, events


def profile_bank(build) -> None:
    """One bank build's device time, its trunk kernels (K1, K2) and every
    copy kernel in it; fails if attention took another kernel than the
    Hopper one."""
    busy, _, events = profile_batch(build, top=12)
    k1 = count_kernels(events, lambda k: "layernorm" in k)
    k2 = count_kernels(events, lambda k: "attention_hopper" in k)
    other = count_kernels(events, lambda k: "attention_" in k and "hopper" not in k)
    copies = [e for e in events if "copy" in e.key.lower()]
    print(f"[bank] device busy {busy!r} ms; K1 layernorm {k1[0]!r} ms x{k1[1]}; K2 attention "
          f"{k2[0]!r} ms x{k2[1]}; copy kernels {sum(dev_us(e) for e in copies) / 1e3!r} ms")
    for e in copies:
        print(f"[bank] copy kernel {dev_us(e) / 1e3!r} ms x{e.count} {e.key[:120]}")
    check(k2[1] == 144 and other[1] == 0, "the bank build's 144 attention launches all take the Hopper kernel")


def host_ms(fn, runs: int) -> list[float]:
    """Host-clock ms of ``runs`` calls of ``fn``, each around synchronised work."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check_eval_output(name: str, out, B: int, hyp: int) -> None:
    """run_batch's ranked poses: shapes, finite, rotations, ranked ratios.
    A non-finite pose is printed with its hypothesis before the failure."""
    R, t, ratio, ok, score = out
    check(R.shape == (B, hyp, 3, 3) and t.shape == (B, hyp, 3), f"{name}: pose shapes")
    check(ratio.shape == (B, hyp) and ok.shape == (B, hyp) and score.shape == (B, hyp), f"{name}: shapes")
    bad = ~(torch.isfinite(R).flatten(2).all(-1) & torch.isfinite(t).all(-1))
    for b, h in bad.nonzero().tolist():
        print(f"[{name}] non-finite pose at query {b}, ranked hypothesis {h}: success "
              f"{bool(ok[b, h])}, ratio {ratio[b, h].item()!r}, R {R[b, h].tolist()}, t {t[b, h].tolist()}")
    check(not bool(bad.any()), f"{name}: every R and t finite")
    check(bool(torch.isfinite(score).all()), f"{name}: template scores finite")
    Rd = R.double()
    orth = (Rd.transpose(-1, -2) @ Rd - torch.eye(3, dtype=Rd.dtype, device=Rd.device)).abs().amax().item()
    check(orth < 1e-4, f"{name}: rotations orthonormal (max |R^T R - I| = {orth!r})")
    check(bool(((ratio >= -1) & (ratio <= 1)).all()), f"{name}: inlier ratios in [-1, 1]")
    check(bool((ratio[:, :-1] >= ratio[:, 1:]).all()), f"{name}: ranked best first")
    print(f"[{name}] max |R^T R - I| = {orth!r}; PnP success share {ok.float().mean().item()!r}; "
          f"best inlier ratio per query {ratio[:, 0].tolist()!r}")


def full_width(seed: int) -> tuple[dict, list, list]:
    """Phase 3: the main path at full ViT-L width; returns the launch counts
    and the flow decoder's corr_lookup and warp_by_flow arguments."""
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.eval.pipeline import (
        build_bank, run_batch, select_templates, stage2_poses, stage3_correspondences,
    )
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.ops.attention import INPUT_COPIES
    from picopose_tpu_torch.ops.pnp import ransac_pnp
    from picopose_tpu_torch.utils.weights import init_random_

    n_views, B, hyp, chunk, iters = 162, 16, 5, 32, 150
    model = PicoPose("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16, device="cuda")
    init_random_(model, seed)
    calm_stage3_heads_(model)
    queries = list(range(0, n_views, 10))[:B]
    bank_np, batch = synthetic_world(n_views, queries, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    import picopose_tpu_torch.models.flow as flow_module

    seen, warps = [], []
    lookup, warp = flow_module.corr_lookup, flow_module.warp_by_flow

    def recording_lookup(*a, **kw):  # the flow decoder's K4 inputs, for corr_on_main_path
        seen.append((*a, kw.get("group", 1)))
        return lookup(*a, **kw)

    def recording_warp(feat, flow, group=1):  # its K5 inputs, for warp_on_main_path
        warps.append((feat, flow, group))
        return warp(feat, flow, group=group)

    kernels.reset_launches()
    INPUT_COPIES.clear()
    bank = build_bank(model, *bank_np, chunk=chunk)
    flow_module.corr_lookup, flow_module.warp_by_flow = recording_lookup, recording_warp
    try:
        out = run_batch(model, batch, bank, hyp=hyp, pnp_iters=iters, generator=g)
    finally:
        flow_module.corr_lookup, flow_module.warp_by_flow = lookup, warp
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[main] launches during the main-path run (build_bank + run_batch): {launches}")
    for name in DEFAULT_PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} launched on the main path")
    check("match_scores_int8" not in launches, "the default path scores bf16 operands")
    check(launches["corr_window"] == 3 and launches["warp"] == 3, "3 corr-window and 3 warp launches per batch")
    check(len(seen) == 3 and [s[4] for s in seen] == [1, 2, 3], "the decoder's three lookups were captured")
    check([w[0].shape[1] for w in warps] == [16, 32, 64], "the decoder's three warps were captured")
    # 24 blocks x (6 bank chunks + 1 query batch): one attention and two LNs each
    check(launches["attention"] == 168 and launches["layernorm"] == 336, "168 attention and 336 LN launches")
    check(not INPUT_COPIES, f"attention read q, k, v in place on the main path: {dict(INPUT_COPIES)}")
    print(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")
    check_eval_output("run_batch", out, B, hyp)

    dev_bank = [torch.as_tensor(a, device="cuda") for a in bank_np]
    dev_batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    feats_real, scores, ids = select_templates(model, dev_batch, bank, hyp=hyp)
    pred_Ms, poses = stage2_poses(model, dev_batch, bank, feats_real, ids)
    check(ids.shape == (B, hyp) and poses.shape == (B * hyp, 4, 4), "output shapes")
    check_outputs("main", scores, ids, pred_Ms, poses, n_views, queries)
    torch.testing.assert_close(out.template_score, scores, atol=1e-5, rtol=0)  # stage 1's scores

    # bank build and per-batch times, host clock around synchronised work
    def stages_1_2():
        feats_real, _, ids = select_templates(model, dev_batch, bank, hyp=hyp)
        stage2_poses(model, dev_batch, bank, feats_real, ids)

    def one_batch():
        run_batch(model, dev_batch, bank, hyp=hyp, pnp_iters=iters, generator=g)

    bank_ms = host_ms(lambda: build_bank(model, *dev_bank, chunk=chunk), 4)[1:]
    s12_ms = host_ms(stages_1_2, 21)[1:]
    batch_ms = host_ms(one_batch, 13)[1:]
    s12, per_batch = float(np.median(s12_ms)), float(np.median(batch_ms))
    print(f"[main] bank build (162 views, chunk 32) ms, 3 runs after one warm-up: {bank_ms!r}")
    print("[profile] one bank build (162 views, chunk 32):")
    profile_bank(lambda: build_bank(model, *dev_bank, chunk=chunk))
    print(f"[main] stages 1-2 per batch (16 queries, hyp 5) ms, 20 runs after one warm-up: "
          f"median {s12!r}, min {min(s12_ms)!r}, max {max(s12_ms)!r} = {B / s12 * 1e3!r} crops/s")
    print(f"[main] run_batch (16 queries, hyp 5, {iters} PnP iterations) ms, 12 runs after one "
          f"warm-up: median {per_batch!r}, min {min(batch_ms)!r}, max {max(batch_ms)!r} "
          f"= {B / per_batch * 1e3!r} crops/s at the median")

    # phase times of one batch on the host clock (synchronised between phases)
    corr = stage3_correspondences(model, dev_batch, bank, feats_real, ids, pred_Ms)
    real_K = dev_batch["real_K"].repeat_interleave(hyp, 0)
    pnp = lambda: ransac_pnp(corr.model_pts, corr.pts2d, real_K, corr.valid, iters=iters, generator=g)
    phases = {
        "stage 1": lambda: select_templates(model, dev_batch, bank, hyp=hyp),
        "stage 2": lambda: stage2_poses(model, dev_batch, bank, feats_real, ids),
        "stage 3": lambda: stage3_correspondences(model, dev_batch, bank, feats_real, ids, pred_Ms),
        "PnP": pnp,
    }
    print("[main] phase medians ms (5 runs after one warm-up): "
          + ", ".join(f"{k} {float(np.median(host_ms(f, 6)[1:]))!r}" for k, f in phases.items()))
    print(f"[main] valid correspondences per hypothesis: mean {corr.valid.float().sum(1).mean().item()!r} "
          f"of {corr.valid.shape[1]}")

    print("[profile] one batch of 16 queries, stages 1-2 (select_templates + stage2_poses):")
    busy12, _, _ = profile_batch(stages_1_2)
    print(f"[profile] stages 1-2 device idle share against the unprofiled median: {1 - busy12 / s12!r}")
    print("[profile] one run_batch of 16 queries x 5 hypotheses:")
    busy, _, _ = profile_batch(one_batch, top=24)
    print("[profile] stage 3 alone (query DPT + flow decoder + correspondences):")
    _, conv3, _ = profile_batch(phases["stage 3"], top=8)
    print("[profile] PnP alone:")
    busy_pnp, _, _ = profile_batch(pnp, top=8)
    print(f"[profile] run_batch: device busy {busy!r} ms of the {per_batch!r} ms median; idle share "
          f"{1 - busy / per_batch!r}; stage-3 convolutions {conv3!r} ms = {conv3 / busy!r} of busy; "
          f"PnP device {busy_pnp!r} ms = {busy_pnp / busy!r} of busy")
    return launches, seen, warps


FRAME_HW = (960, 1280)  # ITODD's frame size


def rle_counts(mask: np.ndarray) -> dict:
    """An uncompressed COCO RLE of a binary mask (column-major runs,
    starting with a background run)."""
    flat = mask.T.reshape(-1).astype(np.int8)
    edges = np.flatnonzero(np.diff(np.r_[0, flat, 1 - flat[-1]]))
    return {"size": list(mask.shape), "counts": np.diff(np.r_[0, edges]).tolist()}


def serve_world(seed: int, queries: list[int]):
    """The 162-view bank inputs of ``synthetic_world``, with views made of
    uint8 RGB images (CLIP-normalised BGR, as the crops are), and one
    960 x 1280 frame holding ``queries``' views on a 4 x 4 grid of 224^2
    squares.  Detections: each square with its full mask, then one
    RLE-encoded mask of the first square and one bbox-only detection of
    the sixth.  Returns (bank inputs, frame, K, detections, expected
    view per detection)."""
    from picopose_tpu_torch.data.crops import CLIP_MEAN, CLIP_STD

    bank_np, _ = synthetic_world(162, queries, seed)
    rng = np.random.default_rng(seed + 7)
    views = rng.integers(0, 256, size=(162, 224, 224, 3), dtype=np.uint8)
    rgb = ((views[..., ::-1] / 255.0 - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    frame = rng.integers(0, 256, size=(*FRAME_HW, 3), dtype=np.uint8)
    dets, expected = [], []
    for i, v in enumerate(queries):
        y0, x0 = 240 * (i // 4), 320 * (i % 4)
        frame[y0 : y0 + 224, x0 : x0 + 224] = views[v]
        mask = np.zeros(FRAME_HW, np.uint8)
        mask[y0 : y0 + 224, x0 : x0 + 224] = 1
        dets.append({"obj_id": 1, "mask": mask})
        expected.append(v)
    dets.append({"obj_id": 1, "segmentation": rle_counts(dets[0]["mask"])})
    dets.append({"category_id": 1, "bbox": [320 * 1, 240 * 1, 224, 224]})  # xywh of the sixth square
    expected += [queries[0], queries[5]]
    K = np.array([[1000.0, 0, 640.0], [0, 1000.0, 480.0], [0, 0, 1]], np.float32)
    return (rgb, *bank_np[1:]), frame, K, dets, expected


class Recorder:
    """Within ``with``, wrap ``module.name`` to append what ``keep(result,
    args)`` returns to ``self.seen``."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep, self.seen = module, name, keep, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            self.seen.append(self.keep(out, a))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def count_kernels(events, match) -> tuple[float, int]:
    sel = [e for e in events if match(e.key)]
    return sum(dev_us(e) for e in sel) / 1e3, sum(e.count for e in sel)


def serve_phase(seed: int) -> dict:
    """Phase 5: ``PoseEstimator`` at full ViT-L width on one 960 x 1280
    frame with 18 detections (two chunks of 16, the second padded): host
    and on-device preprocessing, the serving modes with their launch
    counts, precast, the bank file round trip.  Returns the launch counts
    of the int8-matching ``estimate``."""
    import os
    import tempfile
    import warnings

    from picopose_tpu_torch import kernels
    from picopose_tpu_torch import serve as SV
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.ops import matching as M
    from picopose_tpu_torch.ops.preprocess import preprocess_frame
    from picopose_tpu_torch.utils.precast import precast_inference_params
    from picopose_tpu_torch.utils.weights import init_random_

    queries = list(range(0, 162, 10))[:16]
    bank_np, frame, K, dets, expected = serve_world(seed, queries)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # seeded weights, on purpose
        est = SV.PoseEstimator(seed=seed)  # ViT-L, bf16 (precast), 5 hypotheses, 150 PnP iterations
    calm_stage3_heads_(est.model)
    bank = P.build_bank(est.model, *bank_np, chunk=32)
    est.register_bank(1, bank)
    check(est.objects == [1], "one object registered")
    n = len(dets)

    def run(tag: str) -> dict:
        """One estimate with every kernel's count set to 0 just before and
        read just after; the ranked poses and top-1 views recorded."""
        with Recorder(SV, "run_batch", lambda out, a: out) as rb, \
                Recorder(P, "match_templates", lambda out, a: out[1][:, 0]) as mt, \
                Recorder(M, "match_scores_cuda", lambda out, a: a[0].dtype) as ms:
            kernels.reset_launches()
            res = est.estimate(frame, K, dets)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        check(len(res) == n and all(r.obj_id == 1 for r in res), f"{tag}: {n} results in order")
        for i, out in enumerate(rb.seen):
            check_eval_output(f"{tag} chunk {i}", out, est.max_batch, est.hyp)
        top1 = torch.cat(mt.seen)[:n].tolist()
        hits = sum(a == b for a, b in zip(top1, expected))
        for r in res:
            check(np.isfinite(r.R).all() and np.isfinite(r.t).all(), f"{tag}: finite poses")
            check(np.abs(r.R.T @ r.R - np.eye(3)).max() < 1e-4, f"{tag}: orthonormal R")
        print(f"[serve] {tag}: launches {launches}; K3 operands {sorted(set(map(str, ms.seen)))}; top-1 is the "
              f"pasted view for {hits}/{n} detections; PnP success {sum(r.success for r in res)}/{n}")
        return dict(launches=launches, top1=top1, hits=hits, operands=set(ms.seen))

    # batch parity: host crops against on-device crops, both chunks
    for s0 in range(0, n, est.max_batch):
        chunk = dets[s0 : s0 + est.max_batch]
        pad = est.max_batch - len(chunk)
        host, dev = est._host_batch(frame, K, chunk, pad), est._device_batch(frame, K, chunk, pad)
        err = {k: (host[k].float() - dev[k].float()).abs().max().item() for k in host}
        print(f"[serve] chunk {s0 // est.max_batch} host vs device preprocessing max abs errors {err!r}")
        check(err["real_rgb"] <= 1e-3 and err["real_pts2d"] <= 1e-3, "rgb and pts2d within 1e-3")
        check(err["real_mask"] == 0 and err["real_K"] == 0, "masks and K equal")
        torch.testing.assert_close(dev["real_M"], host["real_M"], rtol=1e-5, atol=0)

    host_run = run("estimate, host preprocessing")
    check(host_run["hits"] == n, "top-1 is the pasted view for every detection")
    launches = host_run["launches"]
    for name in DEFAULT_PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} launched by estimate")
    check(launches.get("match_scores") == 2 and "match_scores_int8" not in launches, "two bf16 K3 launches")
    est.device_preprocess = True
    dev_run = run("estimate, on-device preprocessing")
    check(dev_run["hits"] == n, "top-1 is the pasted view for every detection (on-device crops)")
    est.device_preprocess = False

    # times: ms per frame, host decode, on-device preprocessing
    per_frame = {}
    for flag in (False, True):
        est.device_preprocess = flag
        per_frame[flag] = host_ms(lambda: est.estimate(frame, K, dets), 11)[1:]
    est.device_preprocess = False
    decode = host_ms(lambda: [est._host_batch(frame, K, dets[s : s + 16], max(0, s + 16 - n)) for s in (0, 16)], 6)[1:]
    ft = torch.as_tensor(frame, device=est.device)
    mk = torch.as_tensor(np.stack([d["mask"] for d in dets[:16]]), device=est.device)
    pre_ms = device_ms(lambda f, m: preprocess_frame(f, m), [(ft, mk)], iters=10)
    print(f"[serve] estimate ms per frame (18 detections, 2 chunks; 10 runs after one warm-up): host "
          f"preprocessing median {float(np.median(per_frame[False]))!r} (min {min(per_frame[False])!r}, max "
          f"{max(per_frame[False])!r}); on-device preprocessing median {float(np.median(per_frame[True]))!r} "
          f"(min {min(per_frame[True])!r}, max {max(per_frame[True])!r})")
    print(f"[serve] host decode of the 18 crops (both chunks) ms, median of 5: {float(np.median(decode))!r}; "
          f"preprocess_frame device ms (16 detections, 960 x 1280 frame): {pre_ms!r}")

    # serving modes, each with its launch counts during one estimate
    os.environ["PICOPOSE_MATCH_INT8"] = "1"
    try:
        int8_run = run("estimate, PICOPOSE_MATCH_INT8=1")
    finally:
        del os.environ["PICOPOSE_MATCH_INT8"]
    check(int8_run["launches"].get("match_scores_int8", 0) == 2 and "match_scores" not in int8_run["launches"],
          "int8 matching launches K3's int8 branch, once per chunk")
    agree = sum(a == b for a, b in zip(int8_run["top1"][:16], host_run["top1"][:16]))
    print(f"[serve] int8 matching: top-1 agrees with bf16 matching on {agree}/16 pasted crops")
    check(agree == 16, "int8 top-1 agrees with bf16 on the pasted crops")
    os.environ["PICOPOSE_MATCH_FP32"] = "1"
    try:
        fp32_run = run("estimate, PICOPOSE_MATCH_FP32=1")
    finally:
        del os.environ["PICOPOSE_MATCH_FP32"]
    check(fp32_run["operands"] == {torch.float32} and fp32_run["launches"].get("match_scores", 0) == 2,
          "fp32-operand matching launches K3's fp32 path")

    # quantize_stage3: flows against the float path, stage-3 device time
    batch = est._host_batch(frame, K, dets[:16], 0)
    feats_real, _, ids = P.select_templates(est.model, batch, bank, hyp=est.hyp)
    pred_Ms, _ = P.stage2_poses(est.model, batch, bank, feats_real, ids)
    stage3 = lambda: P.stage3_correspondences(est.model, batch, bank, feats_real, ids, pred_Ms)
    ref = stage3()
    print("[profile] stage 3 with the float (cuDNN bf16) convs:")
    busy_f, conv_f, _ = profile_batch(stage3, top=8)
    est.model.flow_decoder.quantize = True
    try:
        q_run = run("estimate, quantize_stage3")
        got = stage3()
        print("[profile] stage 3 with the int8 convs (im2col + torch._int_mm):")
        busy_q, _, ev_q = profile_batch(stage3, top=12)
    finally:
        est.model.flow_decoder.quantize = False
    check(q_run["hits"] == n, "quantize_stage3 keeps stage 1's choices")
    rel = lambda a, b: ((a.double() - b.double()).norm() / b.double().norm()).item()
    errs = {f"flow{l}": rel(a, b) for l, (a, b) in enumerate(zip(got.flows, ref.flows))}
    errs.update({f"cert{l}": rel(a, b) for l, (a, b) in enumerate(zip(got.certs, ref.certs))})
    int_mm = count_kernels(ev_q, lambda k: any(w in k.lower() for w in ("s8", "i8", "imma", "int8")))
    print(f"[serve] quantize_stage3 flows against the float path, relative RMS {errs!r}; stage-3 device busy "
          f"int8 {busy_q!r} ms (int8 GEMM kernels {int_mm[0]!r} ms x{int_mm[1]}) vs float {busy_f!r} ms "
          f"(cuDNN convs {conv_f!r} ms)")
    check(all(np.isfinite(v) for v in errs.values()) and errs["flow2"] < 0.1, "int8 stage-3 flows near the float ones")

    tf32_check(est, bank, frame, K, dets, batch, seed)

    # precast: the bank build without and with bf16 weight storage
    plain = PicoPose("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16, device=est.device)
    init_random_(plain, seed)
    with torch.inference_mode():
        dev_bank = [torch.as_tensor(a, device=est.device) for a in bank_np]
        build = lambda m: P.build_bank(m, *dev_bank, chunk=32)
        b_plain = build(plain)
        for a, b in zip(b_plain.feats + b_plain.dpt, bank.feats + bank.dpt):
            check(torch.equal(a, b), "precast bank build is bitwise equal to the fp32-weight one")
        stats = {}
        for tag, m in (("fp32 weights", plain), ("precast", est.model)):
            build(m)
            print(f"[profile] bank build, {tag}:")
            busy, _, ev = profile_batch(lambda: build(m), top=6)
            stats[tag] = (busy, *count_kernels(ev, lambda k: "copy" in k.lower()))
        precast_inference_params(plain)
        for a, b in zip(build(plain).feats, b_plain.feats):
            check(torch.equal(a, b), "precast in place keeps the bank bitwise")
    print(f"[serve] precast: bank build device busy / copy-kernel ms / copy launches: {stats!r}")
    del plain, b_plain, dev_bank

    # bank files: save and load on the card, bitwise
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        est.save_banks(d)
        other = SV.PoseEstimator.__new__(SV.PoseEstimator)
        other.device, other._banks = est.device, {}
        check(other.load_banks(d) == [1], "bank file found")
        a, b = est._banks[1], other._banks[1]
        for x, y in zip(a.feats + a.dpt + a[1:6], b.feats + b.dpt + b[1:6]):
            check(x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), "bank round trip bitwise")
        print(f"[serve] bank file {sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))} bytes, "
              "loads back bitwise equal")
    return int8_run["launches"]


class patched:
    """Within ``with``, set each (module, name) to its value; restore after."""

    def __init__(self, *triples):
        self.triples, self.saved = triples, []

    def __enter__(self):
        for module, name, value in self.triples:
            self.saved.append((module, name, getattr(module, name)))
            setattr(module, name, value)
        return self

    def __exit__(self, *exc):
        for module, name, value in reversed(self.saved):
            setattr(module, name, value)


GRAD_REL_RMS = 0.1


def gradient_phase(seed: int) -> None:
    """Phase 6: gradients at full width through the kernels' autograd
    Functions.  The ViT-L features of 2 crops (bf16, images requiring
    grad) and one flow-decoder pass over 16^2 / 32^2 / 64^2 pyramids for
    1 query x 5 hypotheses (group 5; both pyramids and the initial flow
    requiring grad); the loss is a seeded random projection of the taps,
    flows and certainties.  Against the same computation with the four
    dispatchers patched to the plain versions (differentiated natively):
    every LN scale, qkv weight and input gradient finite and non-zero, the
    two within GRAD_REL_RMS relative RMS (bf16: the forward rounds the
    same values at other points, and the backward recomputes the JAX
    package's forms, which round elsewhere than the plain versions), and
    the launch counts of the kernel run: the forward went through K1, K2,
    K4 and K5, the backward launched no kernel."""
    import picopose_tpu_torch.models.dinov2 as vit_module
    import picopose_tpu_torch.models.flow as flow_module
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.geom.grids import pixel_coords_grid
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.ops import attention as A
    from picopose_tpu_torch.ops import corr as CO
    from picopose_tpu_torch.ops import layernorm as L
    from picopose_tpu_torch.ops import sample as SA
    from picopose_tpu_torch.utils.weights import init_random_

    dev = torch.device("cuda")
    model = PicoPose("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16, device=dev)
    init_random_(model, seed)
    calm_stage3_heads_(model)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    B, hyp, C = 1, 5, 256
    images = rn(2, 224, 224, 3).requires_grad_()
    tem = [rn(B * hyp, s, s, C).bfloat16().requires_grad_() for s in (16, 32, 64)]
    real = [rn(B, s, s, C).bfloat16().requires_grad_() for s in (16, 32, 64)]
    # a similarity per hypothesis, as stage 2 seeds the decoder
    p = pixel_coords_grid(16, 16, device=dev) - 7.5
    ang = 0.4 * rn(hyp, 1, 1)
    sc = 1 + 0.1 * rn(hyp, 1, 1)
    target = torch.stack([sc * (torch.cos(ang) * p[..., 0] - torch.sin(ang) * p[..., 1]),
                          sc * (torch.sin(ang) * p[..., 0] + torch.cos(ang) * p[..., 1])], -1) + 7.5
    init_flow = (target - pixel_coords_grid(16, 16, device=dev) + 0.3 * rn(hyp, 16, 16, 2)).requires_grad_()
    cert = torch.ones(hyp, 16, 16, 1, device=dev)
    proj_taps = [rn(2, 16, 16, 1024) for _ in range(4)]
    proj_out = [(rn(hyp, s, s, 2), rn(hyp, s, s, 1)) for s in (16, 32, 64)]
    blocks = model.feature_extractor.dinov2.blocks
    ln = [m.weight for b in blocks for m in (b.norm1, b.norm2)]
    qkv = [b.attn.qkv.weight for b in blocks]
    inputs = [images, *tem, *real, init_flow]

    def run():
        taps = model.features(images)
        flows, certs = model.flow(tem, real, init_flow, cert)
        loss = sum((t.float() * r).sum() for t, r in zip(taps, proj_taps))
        loss = loss + sum((f * pf).sum() + (c * pc).sum() for f, c, (pf, pc) in zip(flows, certs, proj_out))
        grads = torch.autograd.grad(loss, inputs + ln + qkv)
        torch.cuda.synchronize()
        return grads

    kernels.reset_launches()
    t0 = time.perf_counter()
    got = run()
    k_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"[grad] launches during the forward and backward: {launches}")
    check(launches == {"layernorm": 48, "attention": 24, "corr_window": 3, "warp": 3},
          "the forward went through K1 (48), K2 (24), K4 (3) and K5 (3); the backward launched no kernel")

    plain_lookup = lambda f1, f2, fl, r, levels, group=1: CO._corr_lookup(f1, f2, fl, r, levels, group)
    plain_warp = lambda feat, fl, group=1: SA._warp_by_flow(feat, fl, group)
    with patched((vit_module, "layernorm", L.layernorm_plain), (vit_module, "attention", A.attention_plain),
                 (CO, "corr_windows", CO.corr_windows_plain), (flow_module, "corr_lookup", plain_lookup),
                 (SA, "warp", SA.warp_plain), (flow_module, "warp_by_flow", plain_warp)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        ref = run()
        p_s = time.perf_counter() - t0
    check(not kernels.LAUNCHES, "the plain run launched no kernel")

    names = ["images"] + [f"template pyramid {s}^2" for s in (16, 32, 64)] \
        + [f"query pyramid {s}^2" for s in (16, 32, 64)] + ["initial flow"] \
        + [f"block {i // 2} norm{i % 2 + 1} scale" for i in range(len(ln))] + [f"block {i} qkv weight" for i in range(len(qkv))]
    errs = {}
    for name, a, b in zip(names, got, ref):
        a, b = a.double(), b.double()
        check(bool(torch.isfinite(a).all()) and a.abs().max().item() > 0, f"{name}: gradient finite and non-zero")
        errs[name] = ((a - b).norm() / b.norm()).item()
    worst = max(errs, key=errs.get)
    print(f"[grad] kernel path vs plain path relative RMS: inputs "
          f"{ {k: v for k, v in errs.items() if 'block' not in k}!r}; LN scales max "
          f"{max(v for k, v in errs.items() if 'norm' in k)!r}, qkv weights max "
          f"{max(v for k, v in errs.items() if 'qkv' in k)!r}; worst {worst} {errs[worst]!r}, bound {GRAD_REL_RMS!r}")
    print(f"[grad] forward + backward host s (first call, includes warm-up): kernel path {k_s!r}, plain path {p_s!r}")
    check(errs[worst] <= GRAD_REL_RMS, "kernel-path gradients agree with the plain path")


def tf32_check(est, bank, frame, K, dets, batch, seed: int) -> None:
    """The caller's TF32 flags reach no fp32 work of the package: one
    ``estimate`` and stage 2 of one run_batch (``stage2_poses``) with both
    flags on are bitwise the calls with both off (the same PnP draws), and
    the flags are as the caller set them after each call.  The affine
    head's convs called directly, outside the package's entry points, show
    what the flags would move."""
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.ops.matching import feature_similarity_volume

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    default = flags()
    print(f"[tf32] PyTorch's flags in this process (matmul, cudnn): {default}")
    feats_real, _, ids = P.select_templates(est.model, batch, bank, hyp=est.hyp)
    with torch.inference_mode():
        sim = feature_similarity_volume(bank.feats[-1][ids[:, 0]].float(), feats_real[-1].float(),
                                        bank.mask[ids[:, 0]])
    outs = {}
    try:
        for f in ((False, False), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = f
            est.generator.manual_seed(seed)
            res = est.estimate(frame, K, dets)
            check(flags() == f, "estimate leaves the caller's flags as they were")
            s2 = P.stage2_poses(est.model, batch, bank, feats_real, ids)
            check(flags() == f, "stage2_poses leaves the caller's flags as they were")
            with torch.inference_mode():
                head = est.model.affine_regressor(sim)
            rows = np.stack([np.r_[r.R.ravel(), r.t, r.score, r.success, r.template_score] for r in res])
            outs[f] = (rows, s2, head)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = default
    on, off = outs[True, True], outs[False, False]
    moved = max((a.double() - b.double()).abs().max().item() for a, b in zip(on[2], off[2]))
    print(f"[tf32] estimate with the caller's flags on vs off bitwise equal: {np.array_equal(on[0], off[0])}; "
          f"stage2_poses: {all(torch.equal(a, b) for a, b in zip(on[1], off[1]))}; the affine head called "
          f"outside the entry points moves by up to {moved!r} with the flags on")
    check(np.array_equal(on[0], off[0]), "estimate bitwise equal with the caller's TF32 flags on and off")
    check(all(torch.equal(a, b) for a, b in zip(on[1], off[1])), "stage 2 bitwise equal with the flags on and off")


def pnp_scene(rng, B: int, N: int):
    """(pts3d, pts2d, K, valid) CPU tensors: B poses, N model points each
    projected with 0.3 px noise, 30% of them moved anywhere in the image,
    70% valid."""
    K = np.array([[572.4, 0, 320.0], [0, 573.6, 240.0], [0, 0, 1.0]])
    X = rng.uniform(-0.08, 0.08, size=(B, N, 3))
    px = np.empty((B, N, 2))
    for b in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = q * np.sign(np.linalg.det(q))
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.6, 1.5)])
        p = X[b] @ R.T + t
        px[b] = p[:, :2] / p[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]] + rng.normal(0, 0.3, (N, 2))
        out = rng.random(N) < 0.3
        px[b, out] = rng.uniform([0, 0], [640, 480], size=(int(out.sum()), 2))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return f32(X), f32(px), f32(np.tile(K, (B, 1, 1))), torch.as_tensor(rng.random((B, N)) < 0.7)


def small_reference(seed: int) -> None:
    """Phase 4: kernels on the card against the plain CPU path, same weights."""
    from picopose_tpu_torch.eval.pipeline import stage3_correspondences
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.ops.pnp import draw_samples, ransac_pnp
    from picopose_tpu_torch.utils.weights import init_random_

    def rel(got, ref):  # relative RMS error ||got - ref|| / ||ref||
        got, ref = got.cpu().double(), ref.cpu().double()
        return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()

    bank_np, batch = synthetic_world(6, [1, 4], seed + 1)
    # fp32: other summation orders only; bf16: other rounding points, and
    # only the selected (best) hypothesis is compared; stage 3 runs on the
    # CPU's template ids and stage-2 affines on both sides
    for dtype, tol, tol3 in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, 3e-2, 3e-2)):
        cpu = PicoPose("vit_tiny_test", (0, 1, 2, 3), dtype, device="cpu")
        init_random_(cpu, seed)
        calm_stage3_heads_(cpu)
        gpu = PicoPose("vit_tiny_test", (0, 1, 2, 3), dtype, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        ref = run_slice(cpu, bank_np, batch, 3, 4)
        got = run_slice(gpu, bank_np, batch, 3, 4)
        torch.cuda.synchronize()
        name = f"small-{str(dtype).split('.')[-1]}"
        check_outputs(name, *got[1:], 6, [1, 4])
        check(torch.equal(got[2][:, :1].cpu(), ref[2][:, :1]), f"{name}: same best template ids")
        errs = {f"tap{i}": rel(a, b) for i, (a, b) in enumerate(zip(got[0].feats, ref[0].feats))}
        errs.update({f"dpt{i}": rel(a, b) for i, (a, b) in enumerate(zip(got[0].dpt, ref[0].dpt))})
        best = slice(None) if dtype == torch.float32 else slice(None, None, 3)
        if dtype == torch.float32:
            check(torch.equal(got[2].cpu(), ref[2]), f"{name}: same template ids")
            errs["scores"] = rel(got[1], ref[1])
        errs["pred_Ms"] = rel(got[3][best], ref[3][best])
        errs["poses"] = rel(got[4][best], ref[4][best])
        print(f"[{name}] card vs CPU relative RMS errors: {errs!r}, bound {tol!r}")
        check(all(v <= tol for v in errs.values()), f"{name}: card agrees with the CPU path")

        ids, pred_Ms = ref[2], ref[3]
        with torch.inference_mode():
            f_ref = cpu.features(torch.as_tensor(batch["real_rgb"]))
            f_got = gpu.features(torch.as_tensor(batch["real_rgb"], device="cuda"))
        c_ref = stage3_correspondences(cpu, batch, ref[0], f_ref, ids, pred_Ms)
        c_got = stage3_correspondences(gpu, batch, got[0], f_got, ids.cuda(), pred_Ms.cuda())
        errs3 = {f"flow{l}": rel(a, b) for l, (a, b) in enumerate(zip(c_got.flows, c_ref.flows))}
        errs3.update({f"cert{l}": rel(a, b) for l, (a, b) in enumerate(zip(c_got.certs, c_ref.certs))})
        print(f"[{name}] stage 3 card vs CPU relative RMS errors: {errs3!r}, bound {tol3!r}; "
              f"valid masks equal for {(c_got.valid.cpu() == c_ref.valid).float().mean().item()!r} of cells")
        check(all(v <= tol3 for v in errs3.values()), f"{name}: stage 3 on the card agrees with the CPU")

    # PnP on identical correspondences with identical draws: a scene
    # whose points project through one pose (0.3 px noise, 30% outliers,
    # 70% valid), since the synthetic views' random points have no pose
    args = pnp_scene(np.random.default_rng(seed + 2), 6, 4096)
    draws = draw_samples(args[3], 150, 6, 1024, torch.Generator().manual_seed(seed))
    p_ref = ransac_pnp(*args, sample_idx=draws[0], subset_idx=draws[1])
    p_got = ransac_pnp(*(a.cuda() for a in args), sample_idx=draws[0].cuda(), subset_idx=draws[1].cuda())
    torch.cuda.synchronize()
    d = {k: (a.cpu().float() - b.float()).abs().max().item() for k, a, b in zip("R t ratio".split(), p_got, p_ref)}
    print(f"[small] ransac_pnp card vs CPU max abs errors {d!r}; success {p_got.success.tolist()} "
          f"vs {p_ref.success.tolist()}; ratios {p_ref.inlier_ratio.tolist()!r}")
    check(bool(p_ref.success.all()), "small: PnP solves the scene")
    check(torch.equal(p_got.success.cpu(), p_ref.success), "small: PnP success agrees")
    check(d["ratio"] <= 1e-3 and d["R"] <= 1e-3 and d["t"] <= 1e-3, "small: PnP on the card agrees with the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from picopose_tpu_torch import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = kernels.build(verbose=True)
    print(f"[build] {len(kernels.KERNELS)} kernels built in {time.perf_counter() - t0!r} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    checks = kernel_checks(g)
    print(f"[phase] kernel checks {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    launches, seen, warps = full_width(SEED)
    print(f"[phase] full-width main path {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    for name, on_main_path, captured in (("corr_window", corr_on_main_path, seen), ("warp", warp_on_main_path, warps)):
        wild = checks[name]
        checks[name] = on_main_path(captured)
        checks[name]["err"] = max(wild["err"], checks[name]["err"])
    del seen, warps
    print(f"[phase] K4 and K5 on main-path centres {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    small_reference(SEED)
    print(f"[phase] small reference {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    launches["match_scores_int8"] = serve_phase(SEED)["match_scores_int8"]
    print(f"[phase] serve {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    gradient_phase(SEED)
    print(f"[phase] gradients {time.perf_counter() - t0!r} s")

    src = "picopose_tpu_torch/kernels/csrc/"
    replaces = {
        "layernorm": "picopose_tpu/ops/pallas/layernorm.py:51",
        "attention": "picopose_tpu/ops/pallas/flash_attention.py:69",
        "match_scores": "picopose_tpu/ops/pallas/matching.py:81",
        "match_scores_int8": "picopose_tpu/ops/pallas/matching.py:37",
        "corr_window": "picopose_tpu/ops/pallas/corr.py:327",
        "warp": "picopose_tpu/ops/pallas/warp.py:102",
    }
    rows = []
    for name, (source, _, _) in kernels.KERNELS.items():
        r = checks[name]
        rows.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
