#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PicoPose on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit; build the port's host library
     (picopose_tpu_torch/native/csrc: the C++ crop / RLE fast path and the
     template rasterizer, one g++ call; its seconds, flags and the
     compiler's version), then every CUDA kernel of the port from
     picopose_tpu_torch/kernels/csrc (one nvcc per source, in parallel);
  2. each kernel at the main path's shapes against its plain PyTorch
     version (stated tolerance), with kernel / plain / library-call device
     times (kernel time per call in a torch.profiler trace, inputs rotated
     so L2 does not hold them), the per-call time back to back on the
     host clock where the host can dominate (K1, K2), and its bound; K1 at
     the query batch's and a bank chunk's (rows, 257, 1024); K2 at
     contiguous (16, 16, 257, 64) and on views of a (B, 257, 3, 16, 64)
     qkv projection for B = 16 and 32, with SDPA on the same tensors; K3
     beside a cuBLAS bf16 GEMM of the table alone and with the reductions,
     its fp32 branch (``PICOPOSE_MATCH_FP32=1``) on the same queries and
     views beside a cuBLAS fp32 GEMM, and its int8 branch on them
     quantised as the serving mode does, beside torch._int_mm of the
     table alone and with the reductions; each row with the kernel's
     share of its bound;
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
     on-device crops of both chunks agree within 1e-3; ``estimate`` (which
     replays its compiled programs, phase 10) with each, with the launch
     counts of one call (set to 0 just before, read just after): the
     wrappers' (one run_batch execution where the call captures
     run_batch's program, its warm-up, else none) and the trace's (the
     warm-up and two replays, else two), the ranked poses
     of every chunk checked and the top-1 view of each detection the
     pasted one; ms per frame (median of 10 after a warm-up), host decode
     ms and preprocess_frame device ms; the serving modes, each with the
     launch counts of one ``estimate``: PICOPOSE_MATCH_INT8=1 (K3's int8
     branch, one launch per run_batch execution, top-1 as bf16 on the 16
     pasted crops), PICOPOSE_MATCH_FP32=1 (K3's fp32 path), quantize_stage3
     (flows against the float path as relative RMS, stage-3 device time of
     both); TF32: with the caller's matmul and cuDNN TF32 flags on, one
     ``estimate`` (its programs captured under those flags) and
     ``stage2_poses`` bitwise equal to the calls with both off, the flags
     as the caller set them afterwards; the
     bank build with and without precast (device busy, copy kernels; banks
     bitwise equal); and a bank file round trip, bitwise;
     host crops through the C++ fast path and the numpy path
     (PICOPOSE_NO_FASTPATH=1) in turns (``host_crop_paths``): graphed
     ``estimate`` ms per frame with each, ``_host_batch``'s host ms per
     detection by part (RLE decode, mask box, rgb crop, mask crop, crop
     matrix and pts2d, the rest), the host library's calls (above zero on
     the C++ path, none on the numpy one) and the two paths' batches
     within 5e-4; each C entry point's host ms per call beside its numpy
     counterpart (``host_entry_point_ms``);
  6. gradients at full width (``gradient_phase``): ViT-L features of 2
     crops and one flow-decoder pass at 16^2 / 32^2 / 64^2 for 1 query x 5
     hypotheses, a seeded random projection as the loss, gradients to the
     images, both pyramids, the initial flow, every LN scale and every qkv
     weight: finite and non-zero, within a relative RMS of the same
     computation through the plain versions, and the forward's launches
     (48 LN, 24 attention, 3 corr-window, 3 warp; none in the backward);
  7. the BOP evaluation entry point at full width (``eval_cli_phase``): a
     BOP tree written with the script's own PNG encoder (two objects x 162
     RGBA views with 16-bit depth, two 960 x 1280 frames, 40 RLE
     detections) and a seeded ViT-L exported as a Lightning ``.ckpt``;
     ``picopose_tpu_torch.run_test.main`` runs twice in this process, with
     the checks and times listed at ``eval_cli_phase``, its crops through
     the C++ fast path (the host library's calls per run printed);
  8. the training step at full width (``train_phase``): ViT-L, bf16
     compute with fp32 weights, batch 8 of synthetic sphere pairs at 224^2
     (``data/synthetic.py``), AdamW as configs/base.yaml: the launches of
     one step (96 LN, 48 attention, 3 corr-window and 3 warp in the
     forward, none in the backward; with remat 96 LN and 48 attention
     more in the backward), two identical steps bitwise equal (losses and
     gradients), each gather's backward run twice in the package's
     fixed-order form (bitwise) and in the index_add_ form it replaced, the
     forward + backward's device time in both forms, in turns, remat's
     loss (bitwise) and gradients and the peak
     memory with and without it, one step through the kernels against the
     same step through the plain dispatchers (loss terms, gradients by
     parameter group), K1, K2, K4 and K5 at the step's shapes (group 1)
     against their plain versions with device ms and bounds, 30 steps at
     lr 3e-4 on the fixed batch (the loss below 0.9x its first), and the
     step's times: ms per step and samples/s, forward / backward /
     optimizer ms, the forward by layer, and a profile (device busy, idle
     share, top kernels); then the compiled step (``make_train_step``,
     ``compiled_step_phase``): three calls bitwise three eager steps from
     equal states (losses, parameters, statistics, gradients, moments,
     ``count``, the noise generator) for AdamW and SGD at grad_accum 1 and
     2, one with the caller's TF32 flags on; the wrappers' launches (the
     capturing call's warm-up, none on a replay); a replay's kernels in a
     profiler trace without and with remat; ``ckpt.restore`` into the
     captured state mid-accumulation, then a replay equal to the eager next
     step (the fresh-interpreter timing of eager and compiled steps was
     cut, for phase 14's time; phase 13a times the compiled step);
  9. the training loop at full width (``loop_phase``): a MegaPose-GSO tree
     written with the script's PNG encoder and the package's JPEG encoder
     (48 640 x 480 q95 4:2:0 frames from data/jpeg.py::encode_jpeg, two
     objects x 162 RGBA + depth template views), the
     port's JPEG decoder on its frames (PSNR, ms per frame), the loader
     alone (pool start-up, batches/s), ``run_training`` in this
     process through the compiled step (its first step captures, the
     others replay) with a profile of ten steps (96 LN, 48 attention, 3
     corr-window, 3 warp per step in the trace) and the checkpoint's bytes,
     save and restore, one loop batch's eager step through the kernels
     against the plain path, and ``python -m picopose_tpu_torch.run_train``
     for one epoch of 4 steps (a checkpoint at 4; two loader workers) and
     ``--resume`` for one more epoch, to step 8, each through the compiled
     step (cut from 2 x 10 + 10 steps with ten workers, for phase 13's
     time, then from 2 x 4 + 4, for phase 15's);
     the loader's crops take
     the C++ fast path (the host library's calls of 8 samples in this
     process printed: the workers count in their own);
 10. the compiled inference programs at full width (``graph_phase``, run
     right after phase 5 on its estimator, bank and frame): CUDA graphs
     (utils/graphs.py) of run_batch, the bank build's chunks and
     preprocess_frame.  ``run_batch_graphed`` against the eager
     ``run_batch`` from equal generator states, the capturing call and a
     replay, for the default path and each serving mode: template ids,
     ranking order, PnP success, ratios and scores bitwise, R and t within
     GRAPH_POSE_TOL; the wrappers' launches (the capturing call's eager
     warm-up; nothing on a replay) and the kernels in a profiler trace of
     one replay, by kernel name (48 LN, 24 attention, one K3 or K3 int8,
     3 K4, 3 K5); two queued calls that do not alias; a
     second bank of the same shape built by ``build_bank_graphed`` (bitwise
     the eager bank) swapped in and out (its fresh-interpreter timing of
     eager against graphed programs, ``graph_timing``, was cut for phase
     14's time; phases 5 and 11 time the graphed ``estimate`` and
     run_batch);
 11. the configurable flow decoder at full width (``decoder_phase``, run
     at the end of phase 7 on its tree): ``run_test.main`` with ``--set
     model.radius=8`` (lookup radius 4) and a seeded radius-8 checkpoint,
     its CSV, launches and profiler trace (3 K4 per run_batch execution);
     the graphed run_batch bitwise the eager one at radius 8; graphed
     run_batch ms at config radius 4 and 8 in turns; K4 against its plain
     version at lookup radii 1 to 4 on the decoder's captured inputs
     and on wild centres, with its tile counts, device ms and bound; one
     radius-8 training step's launches and losses;
 12. CAD to AR at full width (``cad_to_ar_phase``): a textured cube PLY,
     its level-1 bank through ``python -m
     picopose_tpu_torch.render_templates`` (render and PNG-write ms per
     view, the centre depth against the analytic one, the pose table), a
     one-object BOP tree with an RGB PNG frame and a grey TIFF frame,
     ``picopose_tpu_torch.run_test`` on it as ``python -m`` runs it (seeded
     ViT-L, the bank from disk, C++ crops, K1-K5: its launches and host
     library calls), and ``python -m picopose_tpu_torch.score_csv --vsd
     --bootstrap 100`` on its CSV (every AR finite, in [0, 1]) and on the
     ground truth's (AR 1.0);
 13. ranks and devices on the one card (``ranks_phase``, last, and
     ``devices_phase``, run after phase 11 on phase 7's tree): ViT-L's
     width at RANKS_DEPTH of its 24 blocks (13a, 13b; cut for phase 15's
     time: the checks are of collectives and layouts), bf16, base.yaml's
     AdamW at a constant lr 1e-4, a global batch of 8 sphere pairs.  (a) A one-rank NCCL group: the sharded step in ddp and fsdp
     (``make_train_step(state, shardings, mesh)``) captured and replayed,
     bitwise the eager sharded step and the one-device step, the
     collectives the capturing call issued, one replay's trace (NCCL and
     copy entries, K1/K2/K4/K5), ms and bytes held.  (b) Two gloo ranks
     sharing cuda:0 (fp32 ddp, fsdp and tp, bf16 ddp), two steps: losses,
     the first step's gradient, the change of the parameters per group and
     each parameter against the one-process step at the global batch
     within RANKS_LIMITS, replicated tensors bitwise across the ranks,
     fsdp's bytes per rank at most 0.6 of ddp's, ms per step per rank.
     (c) ``PoseEstimator(devices=[cuda:0, cuda:0])`` with both objects
     registered, bitwise the one-device estimator, and
     ``evaluate_dataset(use_mesh=True, devices=[cuda:0, cuda:0])`` at batch
     16 against the one-device run with the same PnP draws;
 14. the closed accuracy loop: ``picopose_tpu_torch.train_to_ar`` in a
     process of its own (``start_ar_loop``, started after phase 6, beside
     phases 7, 11, 13c and 15; ``ar_loop_phase``, last, reads it, then
     holds K1, K2, K3 (fp32 and its int8 branch), K4 and K5 at the loop's
     ViT-S fp32 shapes against their plain versions with device ms,
     library ms, bound and the kernel's share of it on the idle card) on a
     3-object, 2-scene
     world of 64
     training and 8 test views (10 training steps; five evaluation arms,
     each scored with ``score_csv --vsd --bootstrap 2000``), every training
     and evaluation run printing its launches: the loss falls, each arm
     writes one CSV row per detection, every AR is finite and in [0, 1],
     K3's int8 branch runs in the int8 arm only; the training run's time
     in each step and between steps (loader-bound or step-bound);
 15. the rest of the port's surface (``demos_phase``, before phase 14's
     reading): ``python -m picopose_tpu_torch.synthetic_demo`` (ViT-L
     bf16, 42 views) and ``python -m picopose_tpu_torch.serve_demo --vit
     dinov2_vitl14`` (ViT-L fp32) as users call them, in processes of their
     own under RUN_COUNTED, each exiting 0 with finite poses and K1-K5
     among its launches; meanwhile per-item (B, N, h, w, C) banks at full
     width (PER_ITEM) in ``match_templates`` against K3 fp32 on the shared
     bank they repeat (every score within 1e-5, ids equal except at near
     ties, counted), and ``python -m picopose_tpu_torch.export_torch`` on a
     ViT-S train state with no card visible, bitwise ``export_state_dict``;
 16. the image formats PIL reads (``formats_phase``, run after phase 13c
     on phase 7's tree): phase 7's two frames rewritten, with the writers
     of tests/torch_image_files.py, as an Adam7-interlaced PNG, LZW and
     Deflate TIFFs with the horizontal predictor, a tiled TIFF and a
     planar one (two trees, two variants each), beside a third scene whose
     frame is tests/data/frame_progressive.jpg in one tree and its
     baseline twin tests/data/frame_baseline.jpg in the other (PIL, q75
     4:2:0, the same pixels); host decode ms of each variant beside its
     plain twin on the host's CPU; ``run_test.main`` on each tree through
     K1-K5 (phase 7's decoded template views): every frame decoded
     bitwise as written, the wrappers' launches ``EVAL_LAUNCHES``, every
     CSV row of phase 7's frames (all but ``time``) bitwise phase 7's, and
     the progressive frame's rows bitwise its twin's.
 17. the JAX package's orbax checkpoints (``orbax_phase``, run after
     phase 16 on phase 7's tree), read without JAX from the committed
     fixture tests/data/orbax_small/ (tests/make_orbax_fixture.py: the
     small model's variables and an AdamW ``TrainState`` under
     grad_accum 2 in the middle of an accumulation, and the leaves as an
     .npz): every leaf of both step directories bitwise the .npz's; the
     host library's zstd decoder in MB/s on the fixture's largest frame
     (one thread; the host's CPU named: a host figure);
     ``PoseEstimator(checkpoint=<variables dir>)`` and ``run_test.main``
     on phase 7's tree from the orbax directory against the same
     variables from the .npz, poses and CSV rows bitwise, the run through
     K1-K5; the ``TrainState`` restored from the orbax directory, from
     the .npz and from tests/data/orbax_sharded/ (the same state saved by
     two JAX processes over a 2 x 2 fsdp_tp mesh: a chunk per shard, in
     two process stores), bitwise, and one compiled step from each, the
     losses and the whole state after it bitwise.
Launch counts are the wrappers' (``kernels.LAUNCHES``), which count a
kernel where they launch it: an eager call and a program's warm-up, not
a capture or a replay.  What a replay ran is counted by kernel name in a
profiler trace of it (``traced_launches``).
Then the kernels as one JSON line (K3's int8 row with the wrappers'
launches in the int8-matching ``estimate`` that captures its program;
each row's executions per replayed run_batch, from the trace, as
``replay_launches``, per replay of the compiled training step as
``train_launches`` and per loop step as ``loop_launches``, both from
traces, and the launches of phase 14's runs summed as ``ar_launches``;
the fp32 branches under ``fp32``: K3 at the main path's shape, K2-K5
at the accuracy loop's; each time's source under ``timed_by``:
"trace", or "events" where three traces in a row lost device events and
the calls were timed back to back with CUDA events, launch gaps
included; a kernel is called below its library call only when both
times are traced), the card line, and the result line.
The script leaves PyTorch's TF32 flags at their defaults (cuDNN may take
TF32 for fp32 convolutions): the package pins its fp32 work itself
(``device.full_fp32``), and phase 5 checks that.  Inputs and weights
are drawn from SEED; the stage-3 heads' predict convs are scaled
(``calm_stage3_heads_``) so stage 3 refines the stage-2 seed and PnP sees
thousands of correspondences per hypothesis, as a trained model gives it.
"""

from __future__ import annotations

import json
import os
import re
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


def device_ms(fn, inputs, iters: int = 20, floor_ms: float = 0.0,
              kernels_per_call: int | None = None) -> tuple[float, str]:
    """(device ms per call, "trace" or "events"): the kernel time of
    ``iters`` calls, summed over a torch.profiler trace (so host overhead
    between launches is left out), inputs cycled as in ``cuda_ms``.  A
    trace whose time per call is below ``floor_ms`` (the work's bound: no
    call can be faster), or that holds another number of device events
    than ``iters`` x ``kernels_per_call`` where that is given, lost device
    events and is taken again; after three such traces the calls are timed
    with CUDA events instead (``cuda_ms``: back to back on the host's
    clock, launch gaps included), and the second item says "events"
    (traces on this machine lose events now and then: K4's and K5's
    main-path timings have met three in a row)."""
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
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us, count = sum(dev_us(e) for e in events), sum(e.count for e in events)
        whole = kernels_per_call is None or count == iters * kernels_per_call
        if us > 0 and us / iters / 1e3 >= floor_ms and whole:
            return us / iters / 1e3, "trace"
        print(f"[profile] a trace held {us!r} us of device time in {count} events for {iters} calls (bound "
              f"{floor_ms!r} ms per call, {kernels_per_call} kernels per call); profiling again")
    ms = cuda_ms(fn, inputs, iters)
    print(f"[profile] timed with CUDA events instead: {ms!r} ms per call")
    return ms, "events"


def time_row(r: dict, **timings: tuple[float, str]) -> None:
    """Put each ``device_ms`` result in row ``r`` under its key, and what it
    was timed by under ``r["timed_by"]``."""
    for key, (ms, by) in timings.items():
        r[key] = ms
        r.setdefault("timed_by", {})[key] = by


def below(r: dict, key: str = "library_ms") -> str:
    """Whether the row's kernel took less device time than ``r[key]``; a
    comparison is made only between two traced times."""
    by = r["timed_by"]
    if by["ms"] == by[key] == "trace":
        return str(r["ms"] < r[key])
    return f"not compared (kernel timed by {by['ms']}, the other by {by[key]})"


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for products of ``dtype`` (fp32 on the CUDA
    cores, bf16 on the tensor cores)."""
    return H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layernorm_row(g: torch.Generator, rows: int, tag: str = "kernel", width: int = 1024,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """K1 on the residual stream at (rows, 257, width) (the ViT-L's bf16
    1024 by default) against its plain version, device ms of the kernel,
    the plain version and F.layer_norm, per call back to back, and the
    bound."""
    import torch.nn.functional as F

    from picopose_tpu_torch.ops import layernorm as L

    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    scale, bias = rn(width) * 0.2 + 1, rn(width) * 0.5
    wl, bl = scale.to(dtype), bias.to(dtype)
    size = dtype.itemsize
    n_sets = max(8, -(-120 * 2**20 // (rows * 257 * width * size)))  # rotated past the 50 MB L2
    xs = [(rn(rows, 257, width) * 3 + 1.5).to(dtype) for _ in range(n_sets)]
    args = [(x, scale, bias) for x in xs]
    got, ref = L.layernorm_cuda(*args[0]), L.layernorm_plain(*args[0])
    torch.cuda.synchronize()
    # bf16: one rounding step apart at most (rtol 2^-7); fp32: summation order
    tol = dict(atol=1e-3, rtol=2**-7) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=0)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    bd = bound(2 * xs[0].numel() * size + 2 * width * 4, 8 * xs[0].numel(), H100_FP32_FLOPS)
    library = lambda x, s, b: F.layer_norm(x, (width,), wl, bl, 1e-6)
    r = dict(
        err=(got.float() - ref.float()).abs().max().item(), tol=f"atol {tol['atol']!r} + rtol {tol['rtol']!r}",
        ms_call=cuda_ms(L.layernorm_cuda, args), bound=bd,
    )
    time_row(r, plain_ms=device_ms(L.layernorm_plain, args, floor_ms=bd[0]),
             ms=device_ms(L.layernorm_cuda, args, floor_ms=bd[0]),
             library_ms=device_ms(library, args, floor_ms=bd[0]))
    r["library_call"] = cuda_ms(library, args)
    print(f"[{tag}] layernorm ({rows}, 257, {width}) {str(dtype)[6:]}: max_abs_err {r['err']!r}; device ms kernel "
          f"{r['ms']!r}, plain {r['plain_ms']!r}, F.layer_norm {r['library_ms']!r}; per call back to back kernel "
          f"{r['ms_call']!r}, F.layer_norm {r['library_call']!r}; bound {r['bound'][0]!r} ms "
          f"({r['bound'][0] / r['ms']!r} of it); timed by {r['timed_by']}")
    return r


def attention_row(g: torch.Generator, layout: str, B: int, tag: str = "kernel", heads: int = 16,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """K2 on attention (B, heads, 257, 64) (the ViT-L's bf16 16 heads by
    default), contiguous or on views of a (B, 257, 3, heads, 64) qkv
    projection, against its plain version, device ms beside SDPA on the
    same tensors, and the bound.  The wrapper copies no q, k or v (both
    kernels read views on the 16-byte grid)."""
    import torch.nn.functional as F

    from picopose_tpu_torch.ops import attention as A

    N, H, D = 257, heads, 64
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    size = dtype.itemsize
    sets = []
    for _ in range(max(3, -(-120 * 2**20 // (3 * B * H * N * D * size)))):  # rotated past L2
        if layout == "contiguous":
            sets.append(tuple(rn(B, H, N, D).to(dtype) for _ in range(3)))
        else:
            qkv = rn(B, N, 3, H, D).to(dtype)
            sets.append(tuple(qkv[:, :, i].transpose(1, 2) for i in range(3)))
    A.INPUT_COPIES.clear()
    got, ref = A.attention_cuda(*sets[0]), A.attention_plain(*sets[0])
    torch.cuda.synchronize()
    tol = dict(atol=1e-2, rtol=2**-7) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=0)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    check(not A.INPUT_COPIES, f"attention reads {layout} in place: {dict(A.INPUT_COPIES)}")
    BH = B * H
    peak = peak_flops(dtype)
    bd = bound(4 * BH * N * D * size, 4 * BH * N * N * D, peak)
    r = dict(
        err=(got.float() - ref.float()).abs().max().item(), tol=f"atol {tol['atol']!r} + rtol {tol['rtol']!r}",
        ms_call=cuda_ms(A.attention_cuda, sets), bound=bd,
    )
    time_row(r, plain_ms=device_ms(A.attention_plain, sets[:1], 5, bd[0]),
             ms=device_ms(A.attention_cuda, sets, floor_ms=bd[0], kernels_per_call=1),
             library_ms=device_ms(F.scaled_dot_product_attention, sets, floor_ms=bd[0]))
    r["library_call"] = cuda_ms(F.scaled_dot_product_attention, sets)
    print(f"[{tag}] attention ({B}, {H}, {N}, {D}) {str(dtype)[6:]} {layout}: max_abs_err {r['err']!r}; device "
          f"ms kernel {r['ms']!r}, plain {r['plain_ms']!r}, SDPA {r['library_ms']!r}; per call back to back "
          f"kernel {r['ms_call']!r}, SDPA {r['library_call']!r}; bound {r['bound'][0]!r} ms "
          f"({r['bound'][0] / r['ms']!r} of it); timed by {r['timed_by']}; kernel below SDPA: {below(r)}")
    return r


def kernel_checks(g: torch.Generator) -> dict:
    """Phase 2: every kernel at main-path shapes against its plain version."""
    # K1 at the query batch (its row goes in the JSON line) and a bank chunk;
    # K2 contiguous, then on the main path's qkv views at the query batch
    # (the JSON line's) and a bank chunk
    out = {"layernorm": layernorm_row(g, 16)}
    layernorm_row(g, 32)
    attention_row(g, "contiguous", 16)
    out["attention"] = attention_row(g, "qkv views", 16)
    attention_row(g, "qkv views", 32)

    # K3: 16 queries against a 162-view bf16 bank (S = 256, C = 1024), the
    # same operands in fp32 (PICOPOSE_MATCH_FP32=1) and quantised to int8
    out["match_scores"], q32, qm, t32 = match_row(g, 16, 162, 256, 1024, torch.bfloat16)
    out["match_scores_fp32"] = match_row(g, 16, 162, 256, 1024, torch.float32, operands=(q32, qm, t32))[0]
    out["match_scores_int8"] = match_int8_checks(q32, qm, t32)
    out.update(stage3_kernel_checks(g))
    for name, r in out.items():
        print(f"[kernel] {name}: max_abs_err {r['err']!r} ({r['tol']}), kernel {r['ms']!r} ms, "
              f"plain {r['plain_ms']!r} ms, library {r['library_ms']!r} ms, "
              f"bound {r['bound'][0]!r} ms ({r['bound'][1]}); timed by {r['timed_by']}")
    return out


def match_row(g: torch.Generator, B: int, Nv: int, S: int, C: int, dtype: torch.dtype, tag: str = "kernel",
              operands: tuple | None = None):
    """K3 for B queries against an Nv-view bank at (S, C) in ``dtype``
    against its plain version (atol 1e-5: the scores sum in another
    order), device ms beside cuBLAS's GEMM of the whole table alone and
    with the reductions, the bound and the kernel's share of it.  Each
    query is a noisy copy of one view, so the table has structure and the
    planted views must win.  Returns the row and the fp32 operands (q,
    mask, t) for the int8 branch; ``operands`` gives them instead of new
    draws."""
    from picopose_tpu_torch.ops import matching as M

    dev = torch.device("cuda")
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    planted = torch.arange(B, device=dev) * (Nv // B)
    if operands is None:
        t32 = M.l2_normalize(rn(Nv, S, C))
        q32 = M.l2_normalize(t32[planted] + 0.5 * C**-0.5 * rn(B, S, C))
        qm = (torch.rand(B, S, generator=g, device=dev) > 0.3).float()
    else:
        q32, qm, t32 = operands
    q, t = q32.to(dtype), t32.to(dtype)
    margs = [(q, qm, t)]
    got, ref = M.match_scores_cuda(*margs[0]), M.match_scores_plain(*margs[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    check(bool((got.argmax(1) == planted).all()), "planted views win")

    def gemm(q, qm, t):
        return torch.matmul(q.reshape(B * S, C), t.reshape(Nv * S, C).T)

    def library(q, qm, t):  # cuBLAS GEMM of the whole table + reductions
        sim = gemm(q, qm, t).view(B, S, Nv, S)
        sim = sim * qm[:, :, None, None].to(sim.dtype)
        rowmax, colmax = sim.amax(3), sim.amax(1)
        ok = (qm[:, :, None] > 0) & (sim[..., 0] < rowmax) & (sim[:, 0].transpose(1, 2) < colmax.transpose(1, 2))
        return (rowmax.float() * ok).sum(1) / S

    peak = peak_flops(dtype)
    size = dtype.itemsize
    bd = bound((q.numel() + t.numel()) * size + qm.numel() * 4 + B * Nv * 4, 2 * B * Nv * S * S * C, peak)
    # fp32 launches the tile kernel and the fold: a trace that lost one reads short and is taken again
    per_call = 2 if dtype == torch.float32 else 1
    r = dict(err=(got - ref).abs().max().item(), tol="atol 1e-5", bound=bd)
    time_row(r, ms=device_ms(M.match_scores_cuda, margs, iters=10, floor_ms=bd[0], kernels_per_call=per_call),
             plain_ms=device_ms(M.match_scores_plain, margs, iters=5, floor_ms=bd[0]),
             library_ms=device_ms(library, margs, iters=5, floor_ms=bd[0]),
             gemm_ms=device_ms(gemm, margs, iters=5, floor_ms=bd[0]))
    kind = str(dtype)[6:]
    print(f"[{tag}] match_scores ({B}, {Nv}, {S}, {C}) {kind}: max_abs_err {r['err']!r}; device ms kernel "
          f"{r['ms']!r}, plain {r['plain_ms']!r}, cuBLAS {kind} GEMM of the table alone {r['gemm_ms']!r}, GEMM + "
          f"reductions {r['library_ms']!r}; "
          f"bound {r['bound'][0]!r} ms ({r['bound'][1]}; {r['bound'][0] / r['ms']!r} of it); timed by "
          f"{r['timed_by']}; kernel below GEMM + reductions: {below(r)}")
    return r, q32, qm, t32


def match_int8_checks(q32: torch.Tensor, qm: torch.Tensor, t32: torch.Tensor, tag: str = "kernel") -> dict:
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
    bd = bound(q.numel() + qm.numel() * 4 + t.numel() + B * Nv * 4, 2 * B * Nv * S * S * C, H100_INT8_OPS)
    r = dict(err=(got - ref).abs().max().item(), tol="atol 1e-5 (sims exact; the score sums in another order)",
             bound=bd)
    time_row(r, ms=device_ms(M.match_scores_cuda, args, iters=10, floor_ms=bd[0], kernels_per_call=1),
             plain_ms=device_ms(M.match_scores_plain, args, iters=3, floor_ms=bd[0]),
             library_ms=device_ms(library, args, iters=5, floor_ms=bd[0]),
             gemm_ms=device_ms(gemm, args, iters=5, floor_ms=bd[0]))
    print(f"[{tag}] match_scores int8 ({B}, {Nv}, {S}, {C}): max_abs_err {r['err']!r} against the plain version "
          f"({(got - ref32).abs().max().item()!r} against fp32 operands); device ms kernel {r['ms']!r}, plain "
          f"{r['plain_ms']!r}, "
          f"torch._int_mm of the table alone {r['gemm_ms']!r}, _int_mm + reductions {r['library_ms']!r}; bound "
          f"{r['bound'][0]!r} ms = {r['bound'][0] / r['ms']!r} of the int8 peak; timed by {r['timed_by']}")
    return r


B2_MAIN, GROUP_MAIN = 16, 5  # run_batch's query maps and hypotheses per map
SETS = {16: 6, 32: 3, 64: 1}  # input sets rotated per call at each grid: > 50 MB of L2
# K4 and K5 against their plain versions, by the dtype of their operands:
# bf16, one bf16 step where fp32 sums straddle a rounding boundary; fp32,
# sums and lerps in another order (readings under 1e-6 at |plain| ~4)
K4_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=2**-7), torch.float32: dict(atol=1e-5, rtol=1e-6)}
K5_TOL = K4_TOL


def wild_centres(g: torch.Generator, B: int, G: int, level: int = 0) -> torch.Tensor:
    """(B, G*G, 2) centres of scattered windows, a fifth of the rows pushed
    about a map width past the edges."""
    from picopose_tpu_torch.geom.grids import pixel_coords_grid

    dev = torch.device("cuda")
    flow = torch.randn(B, G, G, 2, generator=g, device=dev) * 3
    flow[:, ::5] += torch.sign(torch.randn(B, 1, G, 2, generator=g, device=dev)) * G * 0.9
    return ((pixel_coords_grid(G, G, device=dev) + flow) / 2.0**level).reshape(B, G * G, 2)


def random_rows(g: torch.Generator, n: int, P: int, C: int = 256, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return torch.randn(n, P, C, generator=g, device="cuda").to(dtype)


def wild_corr_args(g: torch.Generator, radius: int, sets: dict = SETS, B2: int = B2_MAIN, group: int = GROUP_MAIN,
                   dtype: torch.dtype = torch.bfloat16) -> list:
    """K4's argument sets at the flow decoder's shapes, by default for 16
    queries x 5 hypotheses (80 streams over 16 query maps, C = 256, bf16),
    one list per decoder level (16^2 with one pyramid level, 32^2 with two,
    64^2 with three), on wild centres; ``sets`` argument sets per grid."""
    C = 256
    B = B2 * group
    rows = lambda n, P: random_rows(g, n, P, C, dtype)
    pyramid = lambda G, L: [(rows(B2, (G >> i) ** 2).view(B2, G >> i, G >> i, C), i) for i in range(L)]
    return [[(rows(B, G * G).view(B, G, G, C), pyramid(G, L), wild_centres(g, B, G).view(B, G, G, 2),
              radius, group) for _ in range(sets[G])] for G, L in ((16, 1), (32, 2), (64, 3))]


def stage3_kernel_checks(g: torch.Generator) -> dict:
    """K4 and K5 at the flow decoder's shapes for 16 queries x 5 hypotheses
    (80 streams over 16 query maps, C = 256, bf16).  Times are summed over
    the launches of one batch (K4: one per decoder level, on wild centres;
    K5: three grids) and reported per launch, so launches x ms is the
    batch's device time."""
    B2, group = B2_MAIN, GROUP_MAIN
    B = B2 * group
    res = {"corr_window": corr_timing("wild centres", wild_corr_args(g, 2))}

    res["warp"] = warp_timing("wild centres", [
        [(random_rows(g, B2, G * G), wild_centres(g, B, G), G, G, group) for _ in range(SETS[G])] for G in (16, 32, 64)])
    return res


def warp_timing(what: str, calls: list) -> dict:
    """K5 per grid, each a list of (feat, cen, H, W, group) argument sets
    rotated per call: the kernel against the plain version (K5_TOL by the
    features' dtype), device ms of the kernel, the plain version and F.grid_sample
    (one call on the expanded NCHW maps and a normalised grid), the bound.
    Returns the row for one batch, per launch (a launch is one grid)."""
    import torch.nn.functional as F

    from picopose_tpu_torch.ops import sample as SA

    tot = dict(ms=0.0, plain_ms=0.0, lib=0.0, b=0.0, err=0.0)
    by = {"ms": "trace", "plain_ms": "trace", "library_ms": "trace"}  # "events" where any grid fell back
    for sets in calls:
        feat, cen, H, W, group = sets[0]
        B2, P, C = feat.shape
        B = cen.shape[0]
        tol = K5_TOL[feat.dtype]
        got, ref = SA.warp_cuda(*sets[0]), SA.warp_plain(*sets[0])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        err = (got.float() - ref.float()).abs().max().item()

        def library_args(feat, cen, H, W, group):
            # expanded NCHW input and normalised grid; grid_sample takes one
            # dtype, so the grid is in the features' dtype too
            x = feat.reshape(B2, H, W, C).permute(0, 3, 1, 2).repeat_interleave(group, 0).contiguous()
            norm = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=cen.device)
            return x, (cen * norm - 1.0).reshape(B, H, W, 2).to(x.dtype)

        nbytes = (feat.numel() + got.numel()) * feat.element_size() + cen.numel() * 4
        bd = bound(nbytes, B * P * 4 * C * 2, peak_flops(feat.dtype))
        lib_args = [library_args(*a) for a in sets]
        timings = {
            "library_ms": device_ms(lambda x, grid: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                                                  align_corners=True), lib_args, floor_ms=bd[0]),
            "ms": device_ms(SA.warp_cuda, sets, floor_ms=bd[0]),
            "plain_ms": device_ms(SA.warp_plain, sets[:1], iters=3, floor_ms=bd[0]),
        }
        by.update({k: "events" for k, (_, b) in timings.items() if b == "events"})
        (lib, _), (ms, _), (plain, _) = timings.values()
        print(f"[kernel] warp {what} G={H}: max_abs_err {err!r} (atol {tol['atol']!r} + rtol {tol['rtol']!r}), kernel {ms!r} ms, plain {plain!r} ms, "
              f"grid_sample {lib!r} ms, bound {bd[0]!r} ms ({bd[1]}) = {bd[0] / ms!r} of the kernel's time")
        tot.update(ms=tot["ms"] + ms, plain_ms=tot["plain_ms"] + plain, lib=tot["lib"] + lib,
                   err=max(tot["err"], err), b=tot["b"] + bd[0])
        del lib_args, got, ref
    n = len(calls)
    print(f"[kernel] warp {what} per batch ({n} launches): kernel {tot['ms']!r} ms, plain {tot['plain_ms']!r} ms, "
          f"grid_sample {tot['lib']!r} ms, bound {tot['b']!r} ms = {tot['b'] / tot['ms']!r} of the kernel's time; "
          f"timed by {by}")
    return dict(
        err=tot["err"], tol=f"atol {tol['atol']!r} + rtol {tol['rtol']!r}", ms=tot["ms"] / n,
        plain_ms=tot["plain_ms"] / n, library_ms=tot["lib"] / n, bound=(tot["b"] / n, "bytes"), timed_by=by,
    )


def corr_timing(what: str, calls: list, timed: bool = True) -> dict:
    """K4 per decoder level, each a list of (f1, maps, grid, radius, group)
    argument sets rotated per call: the kernel against the plain version
    (K4_TOL by the operands' dtype),
    device ms, the tile counts of the first set, the bound.  Returns the
    row for one batch, per launch (a launch is one decoder level).  With
    ``timed`` False only the first set is checked (no times)."""
    from picopose_tpu_torch.ops import corr as CO

    tot = dict(ms=0.0, plain_ms=0.0, b=0.0, f=0.0, err=0.0)
    by = {"ms": "trace", "plain_ms": "trace"}  # "events" where any level fell back
    for sets in calls:
        f1, maps, grid, radius, group = sets[0]
        B, G, W, C = f1.shape
        L = len(maps)
        tol = K4_TOL[f1.dtype]
        stats = torch.zeros(3, dtype=torch.int32, device=f1.device)
        got = CO.corr_windows_cuda(*sets[0], stats=stats)
        ref = CO.corr_windows_plain(*sets[0])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        use = (diff / (tol["atol"] + tol["rtol"] * ref.float().abs())).max().item()
        nbytes = (f1.numel() + sum(m.numel() for m, _ in maps)) * f1.element_size() + grid.numel() * 4 \
            + got.numel() * got.element_size()
        flops = B * G * W * L * (2 * radius + 2) ** 2 * C * 2  # the (2r+2)^2 cells of each window
        bd = bound(nbytes, flops, peak_flops(f1.dtype))
        # a trace below the bound lost events and is taken again
        launches = -(-L // CO.LEVELS_PER_LAUNCH)
        ms, plain = float("nan"), float("nan")
        if timed:
            (ms, by_ms), (plain, by_plain) = (
                device_ms(CO.corr_windows_cuda, sets, floor_ms=bd[0], kernels_per_call=launches),
                device_ms(CO.corr_windows_plain, sets[:1], iters=3, floor_ms=bd[0]))
            by.update({k: "events" for k, b in (("ms", by_ms), ("plain_ms", by_plain)) if b == "events"})
        tiles, mixed, pixels = stats.tolist()
        print(f"[kernel] corr_window {what} radius={radius} G={G} levels={L}: max_abs_err {err!r} (largest |plain| "
              f"{ref.float().abs().max().item()!r}; at most {use!r} of atol {tol['atol']!r} + rtol "
              f"{tol['rtol']!r}), kernel {ms!r} ms, "
              f"plain {plain!r} ms, bound {bd[0]!r} ms ({bd[1]}); tile-levels {tiles}, with per-pixel "
              f"pixels {mixed}, per-pixel pixel-levels {pixels} of {B * G * W * L}")
        tot.update(ms=tot["ms"] + ms, plain_ms=tot["plain_ms"] + plain, err=max(tot["err"], err),
                   b=tot["b"] + nbytes / H100_BYTES_PER_S * 1e3, f=tot["f"] + flops / peak_flops(f1.dtype) * 1e3)
    n = len(calls)
    print(f"[kernel] corr_window {what} radius={radius} per batch ({n} launches): kernel {tot['ms']!r} ms, "
          f"plain {tot['plain_ms']!r} ms, bound {max(tot['b'], tot['f'])!r} ms; timed by {by if timed else {}}")
    return dict(
        err=tot["err"], tol=f"atol {tol['atol']!r} + rtol {tol['rtol']!r}", ms=tot["ms"] / n,
        plain_ms=tot["plain_ms"] / n, library_ms=None, bound=(max(tot["b"], tot["f"]) / n, "bytes" if tot["b"] >= tot["f"] else "operations"),
        timed_by=by if timed else {},
    )


@torch.inference_mode()
def corr_on_main_path(seen: list, what: str = "main-path centres", timed: bool = True) -> dict:
    """K4 on the flow decoder's inputs captured from one run_batch (its three
    corr_lookup calls): the JSON line's K4 times; or from a training step.
    ``timed`` False: checked against the plain version, not timed."""
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
        nbytes = (feat1.numel() + sum(m.numel() for m, _ in maps)) * feat1.element_size()
        n = max({16: 6, 32: 3}.get(G, 1), -(-60 * 2**20 // nbytes))  # copies rotated per call: > 50 MB of L2
        calls.append([(feat1, maps, grid, radius, group)] + [
            (feat1.clone(), [(m.clone(), i) for m, i in maps], grid.clone(), radius, group)
            for _ in range(n - 1 if timed else 0)])
    return corr_timing(what, calls, timed)


@torch.inference_mode()
def warp_on_main_path(seen: list, what: str = "main-path centres") -> dict:
    """K5 on the flow decoder's inputs captured from one run_batch (its three
    warp_by_flow calls): the JSON line's K5 times; or from a training step."""
    from picopose_tpu_torch.geom.grids import pixel_coords_grid

    calls = []
    for feat, flow, group in seen:
        B2, G, W, C = feat.shape
        cen = (pixel_coords_grid(G, W, device=flow.device) + flow.float()).reshape(flow.shape[0], G * W, 2)
        f = feat.reshape(B2, G * W, C)
        n = max({16: 6, 32: 3}.get(G, 1), -(-60 * 2**20 // (f.numel() * f.element_size())))  # > 50 MB of L2
        calls.append([(f, cen, G, W, group)] + [(f.clone(), cen.clone(), G, W, group) for _ in range(n - 1)])
    return warp_timing(what, calls)


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


def run_batch_launches(calls: int, k3: str = "match_scores") -> dict:
    """K1-K5 launches of ``calls`` executions of run_batch at ViT-L width
    (24 blocks of two LNs and one attention each; one K3, three K4 and
    three K5 launches)."""
    if calls == 0:
        return {}
    return {"layernorm": 48 * calls, "attention": 24 * calls, k3: calls, "corr_window": 3 * calls,
            "warp": 3 * calls}


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
    # kernels only: a GPU user annotation (e.g. Optimizer.step) spans kernels counted on their own
    events = [e for e in averages if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
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


# the CUDA kernels each wrapper's entry point launches, as a profiler trace names them
KERNEL_SYMBOLS = {
    "layernorm": r"\blayernorm_(row|loop)_kernel<",
    "attention": r"\battention_(hopper|tc|ffma)_kernel<",
    "match_scores": r"\bmatch_scores_(hopper_kernel<__nv_bfloat16>|ffma_kernel\b)",
    "match_scores_int8": r"\bmatch_scores_hopper_kernel<signed char>",
    "corr_window": r"\bcorr_(tile|f32|any)_kernel\b",
    "warp": r"\bwarp_kernel<",
}


def traced_launches(averages) -> dict:
    """Executions of each wrapper's kernels in a profiler trace
    (``key_averages()``), by kernel name: what ran on the card, a CUDA
    graph's replay included, where the wrappers count only what they
    launched."""
    import re

    from torch.autograd import DeviceType

    seen = {}
    for e in averages:
        if e.device_type != DeviceType.CUDA:
            continue
        for name, pattern in KERNEL_SYMBOLS.items():
            if re.search(pattern, e.key):
                seen[name] = seen.get(name, 0) + e.count
    return seen


def trace_launches(fn):
    """``fn()`` under torch.profiler, then synchronised: (its result, the
    executions of each wrapper's kernels in the trace).  A small kernel
    runs to its end inside the trace before ``fn`` and another after it,
    so that a kernel of ``fn`` is neither the trace's first nor its last
    (traces on this machine lose events now and then: ``device_ms``'s
    "19 events for 20 calls")."""
    from torch.profiler import ProfilerActivity, profile

    def fence():
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fence()
        out = fn()
        fence()
    return out, traced_launches(prof.key_averages())


def lost_events(traced: dict, want: dict) -> bool:
    """Whether a trace that is not ``want`` holds only fewer executions of
    ``want``'s kernels: events the trace lost, where a kernel too many or
    one of another name is a fault."""
    return traced != want and set(traced) <= set(want) and all(traced[k] <= want[k] for k in traced)


def serve_phase(seed: int) -> dict:
    """Phase 5: ``PoseEstimator`` at full ViT-L width on one 960 x 1280
    frame with 18 detections (two chunks of 16, the second padded): host
    and on-device preprocessing, the serving modes with their launch
    counts, precast, the bank file round trip.  Returns the wrappers'
    launch counts of the int8-matching ``estimate`` that captures its
    program (its eager warm-up; the replays run no wrapper), and the
    estimator, its bank and the frame for phase 10."""
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

    def run(tag: str, warmups: int, k3: str = "match_scores") -> dict:
        """One estimate (two chunks) with every kernel's count set to 0 just
        before and read just after, under the profiler: the wrappers count
        ``warmups`` run_batch executions (1 where the call captures the
        program: its eager warm-up), the trace holds ``warmups`` + 2 (the
        two replays); the ranked poses and top-1 views of the graphed
        calls recorded."""
        seen = []

        def record(graphs, model, batch, bank, **kw):
            out, ids, _ = P._ranked_graphed(graphs, model, batch, bank, kw["hyp"], kw["pnp_iters"],
                                            kw["stage3_topk"], kw["generator"])
            seen.append((out, ids[:, 0]))
            return out

        with patched((SV, "run_batch_graphed", record)), \
                Recorder(M, "match_scores_cuda", lambda out, a: a[0].dtype) as ms:
            kernels.reset_launches()
            res, traced = trace_launches(lambda: est.estimate(frame, K, dets))
            launches = dict(kernels.LAUNCHES)
        check(launches == run_batch_launches(warmups, k3),
              f"{tag}: the wrappers launched {warmups} run_batch executions")
        check(traced == run_batch_launches(warmups + 2, k3),
              f"{tag}: the trace holds {warmups + 2} run_batch executions' kernels")
        check(len(res) == n and all(r.obj_id == 1 for r in res), f"{tag}: {n} results in order")
        for i, (out, _) in enumerate(seen):
            check_eval_output(f"{tag} chunk {i}", out, est.max_batch, est.hyp)
        top1 = torch.cat([ids for _, ids in seen])[:n].tolist()
        hits = sum(a == b for a, b in zip(top1, expected))
        for r in res:
            check(np.isfinite(r.R).all() and np.isfinite(r.t).all(), f"{tag}: finite poses")
            check(np.abs(r.R.T @ r.R - np.eye(3)).max() < 1e-4, f"{tag}: orthonormal R")
        print(f"[serve] {tag}: launches by the wrappers {launches}, in the trace {traced}; K3 operands "
              f"{sorted(set(map(str, ms.seen)))}; top-1 is the pasted view for {hits}/{n} detections; "
              f"PnP success {sum(r.success for r in res)}/{n}")
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

    # the first estimate captures run_batch's program: its warm-up and two replays
    host_run = run("estimate, host preprocessing (capture)", 1)
    check(host_run["hits"] == n, "top-1 is the pasted view for every detection")
    run("estimate, host preprocessing (replays)", 0)
    est.device_preprocess = True
    dev_run = run("estimate, on-device preprocessing", 0)
    check(dev_run["hits"] == n, "top-1 is the pasted view for every detection (on-device crops)")
    est.device_preprocess = False

    # times: ms per frame, host decode, on-device preprocessing
    per_frame = {}
    for flag in (False, True):
        est.device_preprocess = flag
        per_frame[flag] = host_ms(lambda: est.estimate(frame, K, dets), 6)[1:]
    est.device_preprocess = False
    decode = host_ms(lambda: [est._host_batch(frame, K, dets[s : s + 16], max(0, s + 16 - n)) for s in (0, 16)], 6)[1:]
    ft = torch.as_tensor(frame, device=est.device)
    mk = torch.as_tensor(np.stack([d["mask"] for d in dets[:16]]), device=est.device)
    pre_ms, pre_by = device_ms(lambda f, m: preprocess_frame(f, m), [(ft, mk)], iters=10)
    print(f"[serve] estimate ms per frame (18 detections, 2 chunks; 10 runs after one warm-up): host "
          f"preprocessing median {float(np.median(per_frame[False]))!r} (min {min(per_frame[False])!r}, max "
          f"{max(per_frame[False])!r}); on-device preprocessing median {float(np.median(per_frame[True]))!r} "
          f"(min {min(per_frame[True])!r}, max {max(per_frame[True])!r})")
    print(f"[serve] host decode of the 18 crops (both chunks) ms, median of 5: {float(np.median(decode))!r}; "
          f"preprocess_frame device ms (16 detections, 960 x 1280 frame): {pre_ms!r} (timed by {pre_by})")
    host_crop_paths(est, frame, K, dets)
    host_entry_point_ms(frame, dets[0]["mask"])

    # serving modes, each with its launch counts during one estimate
    os.environ["PICOPOSE_MATCH_INT8"] = "1"
    try:
        int8_run = run("estimate, PICOPOSE_MATCH_INT8=1 (capture)", 1, "match_scores_int8")
        run("estimate, PICOPOSE_MATCH_INT8=1 (replays)", 0, "match_scores_int8")
    finally:
        del os.environ["PICOPOSE_MATCH_INT8"]
    agree = sum(a == b for a, b in zip(int8_run["top1"][:16], host_run["top1"][:16]))
    print(f"[serve] int8 matching: top-1 agrees with bf16 matching on {agree}/16 pasted crops")
    check(agree == 16, "int8 top-1 agrees with bf16 on the pasted crops")
    os.environ["PICOPOSE_MATCH_FP32"] = "1"
    try:
        fp32_run = run("estimate, PICOPOSE_MATCH_FP32=1 (capture)", 1)
    finally:
        del os.environ["PICOPOSE_MATCH_FP32"]
    check(fp32_run["operands"] == {torch.float32}, "fp32-operand matching launches K3's fp32 path")

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
        q_run = run("estimate, quantize_stage3 (capture)", 1)
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
        other.device, other.devices, other._banks, other._bank_device = est.device, None, {}, {}
        check(other.load_banks(d) == [1], "bank file found")
        a, b = est._banks[1], other._banks[1]
        for x, y in zip(a.feats + a.dpt + a[1:6], b.feats + b.dpt + b[1:6]):
            check(x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), "bank round trip bitwise")
        print(f"[serve] bank file {sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))} bytes, "
              "loads back bitwise equal")
    return int8_run["launches"], dict(est=est, bank=bank, bank_np=bank_np, frame=frame, K=K, dets=dets)


HOST_CROP_PARTS = {  # part of _host_batch -> the names serve.py calls for it
    "RLE decode": ("rle_to_mask",),
    "mask bbox": ("mask_square_bbox", "square_bbox"),
    "rgb crop": ("crop_and_normalize_rgb",),
    "mask crop": ("crop_mask",),
    "crop matrix and pts2d": ("crop_matrix", "grid_pts2d"),
}
HOST_CROP_TOL = 5e-4  # the C++ crop against the numpy one (the JAX package's bound for its C++ crop)


def host_crop_paths(est, frame, K, dets, rounds: int = 5) -> dict:
    """Phase 5's host crops through the C++ fast path and the numpy path
    (``PICOPOSE_NO_FASTPATH=1``), in turns (C++, numpy, C++, numpy) in
    this process: graphed ``estimate`` ms per frame with host crops
    (median of 10 after a warm-up) and ``_host_batch``'s host ms per
    detection by part (``HOST_CROP_PARTS``; "stack and upload" is the rest
    of the call), with the host library's calls per ``estimate``.  Checks
    that the C++ path called the library and the numpy path did not, and
    that the two paths' batches agree (rgb within ``HOST_CROP_TOL``, the
    rest equal).  Returns {path: (ms per frame, {part: ms per detection})}."""
    from picopose_tpu_torch import native
    from picopose_tpu_torch import serve as SV
    from picopose_tpu_torch.utils.profiling import StageTimer

    n = len(dets)
    chunks = [(dets[s : s + est.max_batch], max(0, s + est.max_batch - n)) for s in range(0, n, est.max_batch)]

    def host_batches(timer):
        def timed_call(part, fn):
            def call(*a, **kw):
                with timer.section(part, sync=False):
                    return fn(*a, **kw)
            return call

        wraps = [(SV, name, timed_call(part, getattr(SV, name)))
                 for part, names in HOST_CROP_PARTS.items() for name in names]
        with patched(*wraps), timer.section("host batch"):
            return [est._host_batch(frame, K, c, pad) for c, pad in chunks]

    frame_ms, by_part, calls, batches = {}, {}, {}, {}
    for path in ("cpp", "numpy", "cpp", "numpy"):
        if path == "numpy":
            os.environ["PICOPOSE_NO_FASTPATH"] = "1"
        try:
            est.estimate(frame, K, dets)
            native.reset_calls()
            est.estimate(frame, K, dets)
            calls[path] = dict(native.CALLS)
            frame_ms.setdefault(path, []).extend(host_ms(lambda: est.estimate(frame, K, dets), 6)[1:])
            timer = by_part.setdefault(path, StageTimer())
            for _ in range(rounds):
                batches[path] = host_batches(timer)
        finally:
            os.environ.pop("PICOPOSE_NO_FASTPATH", None)
    check(calls["cpp"].get("crop_resize_normalize", 0) >= n and calls["cpp"].get("rle_counts_to_mask", 0) > 0,
          "the C++ path called the host library for every rgb crop and the RLE decode")
    check(calls["numpy"] == {}, "the numpy path made no host library call")
    for (a, b) in zip(batches["cpp"], batches["numpy"]):
        err = (a["real_rgb"].float() - b["real_rgb"].float()).abs().max().item()
        check(err <= HOST_CROP_TOL, f"C++ and numpy rgb crops within {HOST_CROP_TOL} (max abs {err!r})")
        for k in ("real_mask", "real_M", "real_K", "real_pts2d"):
            check(torch.equal(a[k], b[k]), f"C++ and numpy {k} equal")
    out = {}
    for path, timer in by_part.items():
        per_det = {part: 1e3 * timer.totals[part] / (2 * rounds * n) for part in HOST_CROP_PARTS}
        per_det["stack, upload, rest"] = 1e3 * timer.totals["host batch"] / (2 * rounds * n) - sum(per_det.values())
        per_det["total"] = 1e3 * timer.totals["host batch"] / (2 * rounds * n)
        ms = frame_ms[path]
        out[path] = (float(np.median(ms)), per_det)
        print(f"[serve] host crops, {path} path: estimate ms per frame (graphed, 18 detections, median of "
              f"{len(ms)} over two turns) {float(np.median(ms))!r} (min {min(ms)!r}, max {max(ms)!r}); "
              f"_host_batch host ms per detection by part {per_det!r}; host library calls per estimate "
              f"{calls[path]!r}")
    print(f"[serve] host crops: C++ against numpy, estimate ms per frame {out['cpp'][0]!r} vs {out['numpy'][0]!r}; "
          f"_host_batch ms per detection {out['cpp'][1]['total']!r} vs {out['numpy'][1]['total']!r}")
    return out


def host_entry_point_ms(frame: np.ndarray, mask: np.ndarray, reps: int = 20) -> dict:
    """Host ms per call (median of ``reps``) of each C entry point of the
    fast path through its wrapper, beside the numpy path's counterpart,
    at phase 5's shapes: one 224^2 square mask in the 960 x 1280 frame,
    its compressed RLE (``rle_decode_counts`` called directly, the others
    through their wrappers), a 224^2 box cropped to 224^2.  The counterparts:
    the numpy RLE decode (counts, then mask), ``np.nonzero``'s box, the
    numpy rgb crop, the nearest mask crop.  Returns {entry point: (C++
    ms, numpy ms)}."""
    from picopose_tpu_torch import native
    from picopose_tpu_torch.data import crops, rle
    from picopose_tpu_torch.native import fastpath

    def ms(fn):
        out = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out[1:]))

    code = rle_string(mask)
    raw = rle_counts(mask)
    bbox = crops.mask_square_bbox(mask)

    def numpy_box():
        ys, xs = np.nonzero(mask)
        return ys.min(), ys.max() + 1, xs.min(), xs.max() + 1

    text = code["counts"].encode("ascii")
    buf = np.zeros(len(text) + 1, np.int64)
    out = {
        "rle_decode_counts": (ms(lambda: native.call("rle_decode_counts", text, len(text), native.ptr(buf), len(buf))),
                              ms(lambda: rle.decode_compressed_counts(text))),
        "rle_counts_to_mask": (ms(lambda: fastpath.rle_to_mask(raw)), ms(lambda: rle.rle_to_mask_py(raw))),
        "mask_bbox": (ms(lambda: fastpath.mask_bbox(mask)), ms(numpy_box)),
        "crop_resize_normalize": (ms(lambda: fastpath.crop_resize_normalize(frame, bbox, 224, mask=mask)),
                                  ms(lambda: crops.crop_and_normalize_rgb_py(frame, bbox, 224, mask))),
        "crop_mask_nearest": (ms(lambda: fastpath.crop_mask_nearest(mask, bbox, 224)),
                              ms(lambda: crops.crop_mask(mask, bbox, 224))),
    }
    print(f"[serve] host library entry points, host ms per call (C++ wrapper, numpy counterpart; median of "
          f"{reps}; rle_decode_counts called directly): {out!r}")
    return out


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
    ``estimate`` (its programs captured under the flags it is called with)
    and stage 2 of one run_batch (``stage2_poses``) with both
    flags on are bitwise the calls with both off (the same PnP draws), and
    the flags are as the caller set them after each call.  The affine
    head's convs called directly, outside the package's entry points, show
    what the flags would move."""
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.ops.matching import feature_similarity_volume
    from picopose_tpu_torch.utils.graphs import GraphCache

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    default = flags()
    print(f"[tf32] PyTorch's flags in this process (matmul, cudnn): {default}")
    feats_real, _, ids = P.select_templates(est.model, batch, bank, hyp=est.hyp)
    with torch.inference_mode():
        sim = feature_similarity_volume(bank.feats[-1][ids[:, 0]].float(), feats_real[-1].float(),
                                        bank.mask[ids[:, 0]])
    outs, graphs = {}, est.graphs
    try:
        for f in ((False, False), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = f
            est.generator.manual_seed(seed)
            est.graphs = GraphCache(est.device)  # the programs captured under these flags
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
        est.graphs = graphs
    on, off = outs[True, True], outs[False, False]
    moved = max((a.double() - b.double()).abs().max().item() for a, b in zip(on[2], off[2]))
    print(f"[tf32] estimate with the caller's flags on vs off bitwise equal: {np.array_equal(on[0], off[0])}; "
          f"stage2_poses: {all(torch.equal(a, b) for a, b in zip(on[1], off[1]))}; the affine head called "
          f"outside the entry points moves by up to {moved!r} with the flags on")
    check(np.array_equal(on[0], off[0]), "estimate bitwise equal with the caller's TF32 flags on and off")
    check(all(torch.equal(a, b) for a, b in zip(on[1], off[1])), "stage 2 bitwise equal with the flags on and off")


CAD_SIZE = 100.0  # mm, the cube's side
CAD_DATASET = "cadcube"
CAD_FRAMES = ((0, "rgb"), (1, "gray"))  # image id, frame kind: an RGB PNG and an 8-bit grey TIFF
CAD_K = np.array([[572.4114, 0.0, 320.0], [0.0, 573.57043, 240.0], [0.0, 0.0, 1.0]])
# runs a module as ``python -m`` does (runpy), then prints the run's kernel
# launches and host library calls
RUN_COUNTED = (
    "import json, runpy, sys\n"
    "from picopose_tpu_torch import kernels, native\n"
    "sys.argv = [sys.argv[1], *sys.argv[2:]]\n"
    "try:\n"
    "    runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    print('[counts] ' + json.dumps({'launches': dict(kernels.LAUNCHES), 'host_calls': dict(native.CALLS)}))\n"
)


# RUN_COUNTED with the training loop's steps timed: run_training's compiled
# step wrapped to synchronise after each step and record the time in it and
# the time since the previous step (logging, waiting for the loader's next
# batch, and at an epoch's start the loader's new worker pool)
RUN_TIMED = (
    "import time, torch\n"
    "from picopose_tpu_torch.train import loop\n"
    "real_make, rec, clock = loop.make_train_step, {'wait_ms': [], 'step_ms': []}, [None]\n"
    "def make(state):\n"
    "    step = real_make(state)\n"
    "    def timed(state, batch, noise):\n"
    "        entry = time.perf_counter()\n"
    "        out = step(state, batch, noise)\n"
    "        torch.cuda.synchronize()\n"
    "        now = time.perf_counter()\n"
    "        rec['wait_ms'].append((entry - clock[0]) * 1e3 if clock[0] else None)\n"
    "        rec['step_ms'].append((now - entry) * 1e3)\n"
    "        clock[0] = now\n"
    "        return out\n"
    "    timed.graphs = step.graphs\n"
    "    return timed\n"
    "loop.make_train_step = make\n"
    "import atexit, json\n"
    "atexit.register(lambda: print('[steps] ' + json.dumps(rec)))\n"
) + RUN_COUNTED


def textured_cube_ply(path: str, texture: str) -> None:
    """A cube of side ``CAD_SIZE`` mm centred at the origin, four vertices
    per face with the whole texture on each face (``texture_u/v``, v up),
    and a ``comment TextureFile`` naming the texture image."""
    s = CAD_SIZE / 2
    faces_uv = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    verts, tris = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_ax, v_ax = [a for a in range(3) if a != axis]
            base = len(verts)
            for (u, v) in faces_uv:
                p = [0.0, 0.0, 0.0]
                p[axis], p[u_ax], p[v_ax] = sign * s, (2 * u - 1) * s, (2 * v - 1) * s
                verts.append((*p, u, v))
            tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"comment TextureFile {texture}\n")
        f.write(f"element vertex {len(verts)}\n")
        for prop in ("x", "y", "z", "texture_u", "texture_v"):
            f.write(f"property float {prop}\n")
        f.write(f"element face {len(tris)}\nproperty list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(" ".join(repr(float(x)) for x in v) + "\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def ray_box_depth(R: np.ndarray, t: np.ndarray, K: np.ndarray, px: tuple[float, float], half: float) -> float:
    """Camera z of the first point where the ray through pixel ``px``
    meets the cube [-half, half]^3 under camera-from-model pose (R, t)."""
    d_cam = np.linalg.inv(K) @ np.array([px[0], px[1], 1.0])
    o, d = -R.T @ t, R.T @ d_cam  # the ray in the model frame, z_cam = s * d_cam[2] = s
    lo, hi = (-half - o) / d, (half - o) / d
    s_near = np.max(np.minimum(lo, hi))
    check(s_near <= np.min(np.maximum(lo, hi)), "the centre ray meets the cube")
    return float(s_near * d_cam[2])


def cad_world(root: str, seed: int, mesh_path: str) -> dict:
    """A one-object BOP tree under ``root`` for the cube at ``mesh_path``:
    two 640 x 480 frames, image 0 ``rgb/000000.png`` and image 1 an
    uncompressed 8-bit ``gray/000001.tif``, each the cube rendered at a
    seeded pose over noise; 16-bit depth PNGs (mm), ``scene_gt.json``,
    ``scene_gt_info.json``, ``scene_camera.json``, ``models/`` with
    ``models_info.json``, the bop19 targets and CNOS-style detections with
    RLE masks from the rendered silhouettes."""
    import json
    import os
    import shutil

    from picopose_tpu_torch.data.png import write_png
    from picopose_tpu_torch.data.tiff import encode_tiff
    from picopose_tpu_torch.native import renderer

    rng = np.random.default_rng(seed + 12)
    base = os.path.join(root, "bop", CAD_DATASET)
    sdir = os.path.join(base, "test", "000001")
    for sub in ("models", "test/000001/rgb", "test/000001/gray", "test/000001/depth"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    mdir = os.path.dirname(mesh_path)
    for name in os.listdir(mdir):
        shutil.copy(os.path.join(mdir, name), os.path.join(base, "models", name))
    mesh = renderer.load_mesh(mesh_path)
    v = mesh.verts.astype(np.float64)
    diameter = float(np.linalg.norm(v[:, None] - v[None], axis=-1).max())
    with open(os.path.join(base, "models", "models_info.json"), "w") as f:
        json.dump({"1": {"diameter": diameter}}, f)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(CAD_FRAMES), 1, 1))
    for i in range(len(CAD_FRAMES)):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses[i, :3, :3] = q * np.sign(np.linalg.det(q))
        poses[i, :3, 3] = [rng.uniform(-40, 40), rng.uniform(-30, 30), rng.uniform(550, 700)]
    rgba, depth = renderer.render_mesh_views(mesh, poses, CAD_K.astype(np.float32), (480, 640))
    scene_gt, gt_info, cams, dets, targets = {}, {}, {}, [], []
    for (im, kind), pose, view, dep in zip(CAD_FRAMES, poses, rgba, depth):
        frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        mask = view[..., 3] > 0
        check(mask.sum() > 2000, f"frame {im}: the cube covers {int(mask.sum())} pixels")
        frame[mask] = view[..., :3][mask]
        if kind == "rgb":
            write_png(os.path.join(sdir, "rgb", f"{im:06d}.png"), frame)
        else:
            grey = np.round(frame @ np.array([0.299, 0.587, 0.114])).clip(0, 255).astype(np.uint8)
            with open(os.path.join(sdir, "gray", f"{im:06d}.tif"), "wb") as f:
                f.write(encode_tiff(grey, rows_per_strip=64))
        write_png(os.path.join(sdir, "depth", f"{im:06d}.png"), dep)
        R, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
        scene_gt[str(im)] = [{"obj_id": 1, "cam_R_m2c": R.reshape(-1).tolist(), "cam_t_m2c": t.tolist()}]
        gt_info[str(im)] = [{"visib_fract": 1.0}]
        cams[str(im)] = {"cam_K": CAD_K.reshape(-1).tolist(), "depth_scale": 1.0}
        ys, xs = np.nonzero(mask)
        dets.append({"scene_id": 1, "image_id": im, "category_id": 1, "score": 0.9, "time": 0.05,
                     "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)],
                     "segmentation": rle_string(mask.astype(np.uint8))})
        targets.append({"scene_id": 1, "im_id": im, "obj_id": 1, "inst_count": 1})
    for name, data in (("scene_gt", scene_gt), ("scene_gt_info", gt_info), ("scene_camera", cams)):
        with open(os.path.join(sdir, f"{name}.json"), "w") as f:
            json.dump(data, f)
    with open(os.path.join(base, "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)
    os.makedirs(os.path.join(root, "dets"), exist_ok=True)
    with open(os.path.join(root, "dets", f"{CAD_DATASET}.json"), "w") as f:
        json.dump(dets, f)
    return dict(data_dir=os.path.join(root, "bop"), det_dir=os.path.join(root, "dets"), poses=poses,
                diameter=diameter)


def cad_to_ar_phase(seed: int, flags: tuple = (), overrides: tuple = ()) -> dict:
    """Phase 12, CAD to AR at full ViT-L width, every step a command line
    of the port: a textured cube PLY; its level-1 bank (162 views, 640 x
    480) through ``python -m picopose_tpu_torch.render_templates`` (ms per
    view; a view's centre depth against the cube's analytic depth within 1
    mm, a non-empty silhouette, the pose table ``template_object_poses(1)``
    scaled to the diameter); a one-object BOP tree (``cad_world``: an RGB
    PNG frame and a grey TIFF frame); ``picopose_tpu_torch.run_test`` run
    as ``python -m`` runs it (seeded weights, the bank from disk, C++ crops,
    K1-K5: the child prints its launches and host library calls, all
    above zero); ``python -m picopose_tpu_torch.score_csv --vsd --bootstrap
    100`` on its CSV (every AR finite, in [0, 1]) and on a CSV of the
    ground-truth poses (AR_MSSD, AR_MSPD and AR_VSD 1.0).  Times its parts
    with the port's ``utils/profiling.StageTimer``.  ``flags`` and
    ``overrides`` (``--set``) are added to run_test's command line (a CPU
    rehearsal: ``--device cpu`` and a small model)."""
    import glob
    import json
    import os
    import tempfile

    from picopose_tpu_torch.data.png import read_png, write_png
    from picopose_tpu_torch.eval.bop_csv import format_row
    from picopose_tpu_torch.geom.templates import template_object_poses
    from picopose_tpu_torch.native import renderer
    from picopose_tpu_torch.utils.profiling import StageTimer

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, (here, os.environ.get("PYTHONPATH"))))}
    timer = StageTimer()

    def command(tag, args, cwd):
        with timer.section(tag, sync=False):
            p = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"{tag}: exit 0")
        return p.stdout

    with tempfile.TemporaryDirectory(dir=here) as root:
        models = os.path.join(root, "cad")
        os.makedirs(models)
        with timer.section("write cube", sync=False):
            tex = np.random.default_rng(seed + 13).integers(0, 256, (64, 64, 3), dtype=np.uint8)
            write_png(os.path.join(models, "texture.png"), tex)
            textured_cube_ply(os.path.join(models, "obj_000001.ply"), "texture.png")
        tem_dir = os.path.join(root, "templates", CAD_DATASET)
        out = command("render_templates", ["-m", "picopose_tpu_torch.render_templates", "--models_dir", models,
                                           "--out_dir", tem_dir, "--level", "1"], here)
        print(f"[cad] render_templates: {out.strip()}")
        per_view = re.search(r"ms per view: render ([0-9.e+-]+), PNG write ([0-9.e+-]+)", out)
        check(per_view is not None and "162 views" in out, "the bank has 162 views")

        # the bank: pose table, silhouette, a view's centre depth against the cube's analytic depth
        mesh = renderer.load_mesh(os.path.join(models, "obj_000001.ply"))
        check(mesh.texture is not None and mesh.uv is not None, "the cube's texture was read")
        table = template_object_poses(1).copy()
        table[:, :3, 3] *= mesh.diameter / 1000.0
        written = np.load(os.path.join(tem_dir, "object_poses", "000001.npy"))
        check(written.shape == (162, 4, 4) and np.array_equal(written, table),
              "the pose table is template_object_poses(1) scaled to the diameter")
        errs = []
        for v in (0, 81, 161):
            rgba = read_png(os.path.join(tem_dir, "000001", f"{v:06d}.png"))
            depth = read_png(os.path.join(tem_dir, "000001", f"{v:06d}_depth.png"))
            check(rgba.shape == (480, 640, 4) and depth.dtype == np.uint16, "a 640 x 480 RGBA view and 16-bit depth")
            check((rgba[..., 3] > 0).sum() > 1000 and (depth > 0).sum() > 1000, f"view {v}: a non-empty silhouette")
            z = ray_box_depth(table[v, :3, :3].astype(np.float64), table[v, :3, 3].astype(np.float64), CAD_K,
                              (320.5, 240.5), CAD_SIZE / 2)
            errs.append(int(depth[240, 320]) - z)
        print(f"[cad] bank: centre depth minus the cube's analytic depth (views 0, 81, 161) {errs!r} mm")
        check(all(abs(e) <= 1.0 for e in errs), "the centre depth within 1 mm of the analytic depth")

        with timer.section("write BOP tree", sync=False):
            world = cad_world(root, seed, os.path.join(models, "obj_000001.ply"))
        argv = ["--dataset", CAD_DATASET, "--config", os.path.join(here, "configs", "base.yaml"),
                "--checkpoint_path", "none", *flags, "--set",
                f"test_dataset.data_dir={world['data_dir']}",
                f"test_dataset.template_dir={os.path.join(root, 'templates')}",
                f"test_dataset.detection_dir={world['det_dir']}", *overrides]
        out = command("run_test", ["-c", RUN_COUNTED, "picopose_tpu_torch.run_test", *argv], root)
        counts = json.loads(out.strip().splitlines()[-1].removeprefix("[counts] "))
        print(f"[cad] run_test: launches {counts['launches']!r}; host library calls {counts['host_calls']!r}")
        if not flags:
            check(all(counts["launches"].get(k, 0) > 0 for k in DEFAULT_PATH_KERNELS),
                  f"run_test launched each of {DEFAULT_PATH_KERNELS}")
        check(counts["host_calls"].get("crop_resize_normalize", 0) >= 162 + len(CAD_FRAMES)
              and counts["host_calls"].get("rle_counts_to_mask", 0) >= len(CAD_FRAMES),
              "run_test cropped the templates and both frames and decoded both RLEs in C++")
        (csv_path,) = glob.glob(os.path.join(root, "log", "picopose", "version_0", f"{CAD_DATASET}_eval", "*.csv"))
        with open(csv_path) as f:
            rows = [r.split(",") for r in f.read().splitlines() if r and not r.startswith("scene_id")]
        check([(r[0], r[1], r[2]) for r in rows] == [("1", str(im), "1") for im, _ in CAD_FRAMES],
              "one CSV row per frame, the TIFF frame's included")

        score = ["-m", "picopose_tpu_torch.score_csv", "--data_dir", world["data_dir"], "--dataset", CAD_DATASET,
                 "--vsd", "--bootstrap", "100"]
        est = json.loads(command("score_csv (run_test's CSV)", [*score, "--csv", csv_path], here))
        gt_csv = os.path.join(root, "gt.csv")
        with open(gt_csv, "w") as f:
            f.write("scene_id,im_id,obj_id,score,R,t,time\n")
            for (im, _), pose in zip(CAD_FRAMES, world["poses"]):
                f.write(format_row(1, im, 1, 1.0, pose[:3, :3].astype(np.float64),
                                   pose[:3, 3].astype(np.float64) / 1000.0, 0.1))
        gt = json.loads(command("score_csv (ground truth)", [*score, "--csv", gt_csv], here))
    keys = ("AR_MSSD", "AR_MSPD", "AR_VSD", "AR_bop19", "AR_mssd_mspd")
    print(f"[cad] score_csv --vsd --bootstrap 100 of run_test's CSV (seeded weights): "
          f"{ {k: est[k] for k in keys}!r}, ci95 {est['ci95']!r}, n_gt {est['n_gt']}")
    print(f"[cad] score_csv of the ground-truth poses: { {k: gt[k] for k in keys}!r}")
    check(all(np.isfinite(est[k]) and 0.0 <= est[k] <= 1.0 for k in keys), "every AR finite and in [0, 1]")
    check(est["n_gt"] == len(CAD_FRAMES) and gt["n_gt"] == len(CAD_FRAMES), "both frames scored")
    check(gt["AR_MSSD"] == gt["AR_MSPD"] == gt["AR_VSD"] == 1.0, "the ground-truth poses score AR 1.0")
    print(f"[cad] render ms per view {float(per_view.group(1))!r}, PNG write ms per view "
          f"{float(per_view.group(2))!r}; parts: {timer.report()}")
    return dict(render_ms=float(per_view.group(1)), write_ms=float(per_view.group(2)), est=est, gt=gt)


def png_bytes(arr: np.ndarray) -> bytes:
    """PNG file bytes of an (H, W) uint8 or uint16 grey, (H, W, 3) RGB or
    (H, W, 4) RGBA uint8 image.  Row y is filtered with type y % 5 (None,
    Sub, Up, Average, Paeth), so a decoder of these files meets all five."""
    import struct
    import zlib

    H, W = arr.shape[:2]
    depth = 16 if arr.dtype == np.uint16 else 8
    colour = 0 if arr.ndim == 2 else {3: 2, 4: 6}[arr.shape[2]]
    x = (arr.astype(">u2").view(np.uint8) if depth == 16 else arr).reshape(H, W, -1).astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)  # left, above, above-left
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    ftype = np.arange(H) % 5
    filt = np.empty_like(x)
    for k in range(5):
        r = ftype == k
        ar, br, cr = a[r], b[r], c[r]
        pa, pb, pc = np.abs(br - cr), np.abs(ar - cr), np.abs(ar + br - 2 * cr)
        pred = [0, ar, br, (ar + br) >> 1, np.where((pa <= pb) & (pa <= pc), ar, np.where(pb <= pc, br, cr))][k]
        filt[r] = (x[r] - pred) & 255
    raw = np.concatenate([ftype[:, None], filt.reshape(H, -1)], axis=1).astype(np.uint8).tobytes()
    chunk = lambda kind, data: struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def rle_string(mask: np.ndarray) -> dict:
    """A COCO RLE with compressed counts (the CNOS detections' form)."""
    counts, out = rle_counts(mask)["counts"], []
    for i, x in enumerate(counts):
        x -= counts[i - 2] if i > 2 else 0
        more = True
        while more:
            c, x = x & 0x1F, x >> 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return {"size": list(mask.shape), "counts": "".join(out)}


def image_digest(arr: np.ndarray) -> str:
    import hashlib

    return hashlib.sha1(arr.tobytes() + str((arr.dtype, arr.shape)).encode()).hexdigest()


EVAL_OBJECTS, EVAL_VIEWS, EVAL_FRAME_HW = (1, 2), 162, (960, 1280)
# (scene, image) of each test frame: 20 224^2 slots on a 4 x 5 grid, ten views of each object
EVAL_FRAMES = ((1, 3), (2, 7))


def bop_world(root: str, seed: int) -> dict:
    """A BOP tree under ``root`` in the reference layout: per object 162
    RGBA template views at 640 x 480 (a 224^2 square of random texture,
    opaque, at a random place), 16-bit depth in mm and poses in mm; two
    960 x 1280 test frames, each holding ten views of each object; CNOS
    detections with RLE masks (one per slot, ten per object and frame,
    one of them carrying only 6 mask pixels, so its box is used, plus a
    low-scored one past ``inst_count``), scene cameras and the bop19
    targets.  Returns the paths, a digest of every image written, the
    view pasted under each detection's box, the frames, K, detections and
    targets."""
    import concurrent.futures as cf
    import json
    import os

    rng = np.random.default_rng(seed)
    data_dir, tem_dir, det_dir = (os.path.join(root, d) for d in ("bop", "templates", "dets"))
    digests, views, writes = {}, {}, []
    pool = cf.ThreadPoolExecutor(8)  # zlib and numpy's whole-image operations release the GIL

    def encode(path, arr):
        with open(path, "wb") as f:
            f.write(png_bytes(arr))

    def write(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        writes.append(pool.submit(encode, path, arr))
        digests[path] = image_digest(arr)

    for obj in EVAL_OBJECTS:
        odir = os.path.join(tem_dir, "smoke", f"{obj:06d}")
        views[obj] = rng.integers(0, 256, (EVAL_VIEWS, 224, 224, 3), dtype=np.uint8)
        poses = np.tile(np.eye(4), (EVAL_VIEWS, 1, 1))
        for v in range(EVAL_VIEWS):
            y0, x0 = rng.integers(0, 480 - 224), rng.integers(0, 640 - 224)
            rgba = np.zeros((480, 640, 4), np.uint8)
            rgba[y0 : y0 + 224, x0 : x0 + 224, :3] = views[obj][v]
            rgba[y0 : y0 + 224, x0 : x0 + 224, 3] = 255
            depth = np.zeros((480, 640), np.uint16)
            depth[y0 : y0 + 224, x0 : x0 + 224] = rng.integers(500, 800) + rng.integers(0, 30, (224, 224))
            write(os.path.join(odir, f"{v:06d}.png"), rgba)
            write(os.path.join(odir, f"{v:06d}_depth.png"), depth)
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            poses[v, :3, :3] = q * np.sign(np.linalg.det(q))
            poses[v, :3, 3] = [rng.normal(0, 20), rng.normal(0, 20), rng.uniform(500, 800)]
        os.makedirs(os.path.join(tem_dir, "smoke", "object_poses"), exist_ok=True)
        np.save(os.path.join(tem_dir, "smoke", "object_poses", f"{obj:06d}.npy"), poses)

    dets, targets, pasted, cams, frames = [], [], {}, {}, {}
    K = [1000.0, 0.0, 640.0, 0.0, 1000.0, 480.0, 0.0, 0.0, 1.0]
    for fi, (scene, im) in enumerate(EVAL_FRAMES):
        frame = rng.integers(0, 256, (*EVAL_FRAME_HW, 3), dtype=np.uint8)
        for slot in range(20):
            obj, y0, x0 = EVAL_OBJECTS[slot % 2], 240 * (slot // 5) + 8, 256 * (slot % 5) + 16
            v = int(rng.integers(EVAL_VIEWS))
            frame[y0 : y0 + 224, x0 : x0 + 224] = views[obj][v]
            mask = np.zeros(EVAL_FRAME_HW, np.uint8)
            if fi == 1 and slot == 19:  # 6 pixels at the 16^2 grid's samples: the box is used
                mask[y0 + 14 * np.array([4, 4, 8, 11, 11, 7]), x0 + 14 * np.array([4, 11, 8, 4, 11, 2])] = 1
            else:
                mask[y0 : y0 + 224, x0 : x0 + 224] = 1
            bbox = [x0, y0, 224, 224]
            dets.append({"scene_id": scene, "image_id": im, "category_id": obj, "bbox": bbox,
                         "score": round(0.99 - 0.01 * slot, 2), "time": 0.05, "segmentation": rle_string(mask)})
            pasted[scene, im, tuple(bbox)] = v
        # a detection scored below the ten kept for object 1
        dets.append(dict(dets[-20], score=0.01))
        targets += [{"scene_id": scene, "im_id": im, "obj_id": obj, "inst_count": 10} for obj in EVAL_OBJECTS]
        write(os.path.join(data_dir, "smoke", "test", f"{scene:06d}", "rgb", f"{im:06d}.png"), frame)
        frames[scene, im] = frame
        cams.setdefault(scene, {})[str(im)] = {"cam_K": K}
    for scene, cam in cams.items():
        with open(os.path.join(data_dir, "smoke", "test", f"{scene:06d}", "scene_camera.json"), "w") as f:
            json.dump(cam, f)
    with open(os.path.join(data_dir, "smoke", "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)
    os.makedirs(det_dir)
    with open(os.path.join(det_dir, "smoke.json"), "w") as f:
        json.dump(dets, f)
    with pool:
        for w in writes:
            w.result()
    return dict(data_dir=data_dir, template_root=tem_dir, det_dir=det_dir, digests=digests, pasted=pasted,
                n_instances=20 * len(EVAL_FRAMES), frames=frames, K=K, dets=dets, targets=targets)


# K1-K5 in one eval CLI run: two 162-view banks (6 chunks each: 5 of 32
# views, 1 of 2; 24 blocks of two LNs and one attention per chunk) and four
# batches (each object: 16 instances, then 4 padded to 16), through the
# run's compiled programs.  The wrappers launch only the eager warm-ups of
# the first call of each program (the chunk programs of 32 and of 2 views,
# run_batch's): 2 chunk and 1 run_batch executions.  The card runs those
# and every replay: 12 + 2 chunk and 4 + 1 run_batch executions, which a
# profiler trace of the run counts by kernel name.
EVAL_LAUNCHES = {"layernorm": 2 * 48 + 48, "attention": 2 * 24 + 24, "match_scores": 1, "corr_window": 3,
                 "warp": 3}
EVAL_TRACED = {"layernorm": (12 + 2) * 48 + (4 + 1) * 48, "attention": (12 + 2) * 24 + (4 + 1) * 24,
               "match_scores": 4 + 1, "corr_window": (4 + 1) * 3, "warp": (4 + 1) * 3}


def expected_rows(world: dict) -> list[tuple[str, str, str, str]]:
    """(scene, image, object, score) of each CSV row, from the written
    targets and detections: the images in key order, each target's
    inst_count best-scored detections of its object."""
    import json
    import os

    with open(os.path.join(world["data_dir"], "smoke", "test_targets_bop19.json")) as f:
        targets = json.load(f)
    with open(os.path.join(world["det_dir"], "smoke.json")) as f:
        dets = json.load(f)
    rows = []
    for tgt in sorted(targets, key=lambda t: (t["scene_id"], t["im_id"])):
        cand = [d for d in dets if (d["scene_id"], d["image_id"], d["category_id"])
                == (tgt["scene_id"], tgt["im_id"], tgt["obj_id"])]
        cand.sort(key=lambda d: -d["score"])
        rows += [(str(tgt["scene_id"]), str(tgt["im_id"]), str(tgt["obj_id"]), str(d["score"]), tuple(d["bbox"]))
                 for d in cand[: tgt["inst_count"]]]
    return rows


def eval_cli_phase(seed: int, then=None) -> None:
    """Phase 7: the BOP evaluation entry point at full width.  A BOP tree
    (``bop_world``) and a seeded ViT-L checkpoint (random weights, calmed
    stage-3 heads) exported as a Lightning ``.ckpt``; then
    ``picopose_tpu_torch.run_test.main`` in this process (bf16, 162 views,
    hyp 5, batch 16, 150 PnP iterations), twice.  Checks: the loaded
    weights are bitwise the exported ones; every PNG the run decodes
    (frames, template views and depth maps) is bitwise the image written; every detection's top template is the view pasted
    under it; the CSV has one row per instance in the dataset's order with
    the targets' scene, image, object and score, orthonormal R, finite t
    and time > 0; the second run's first six columns equal the first's;
    the wrappers launched K1-K5 as the warm-ups of the run's compiled
    programs imply (``EVAL_LAUNCHES``), and the profiled run's trace holds
    the kernels of two banks and four batches (``EVAL_TRACED``).
    Prints PNG decode ms, template loading and bank ms per object, wall
    time, instances/s, the eval loop's device idle share (device busy in a
    profiled second run over the first run's wall) and run_batch's host
    ms in the runner against the same call alone.  ``then(root, world,
    argv)``, where given, runs last on the same tree."""
    import csv
    import os
    import tempfile
    import warnings

    import picopose_tpu_torch.data.bop as bop_module
    from picopose_tpu_torch import kernels, native, run_test
    from picopose_tpu_torch.data.png import read_png
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.eval import runner
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.utils.torch_export import save_torch_checkpoint
    from picopose_tpu_torch.utils.weights import init_random_

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as root:
        t0 = time.perf_counter()
        world = bop_world(root, seed)
        print(f"[eval] BOP tree written: {len(world['digests'])} PNGs, {world['n_instances']} instances, "
              f"{time.perf_counter() - t0!r} s")

        # PNG decoding on the host, alone: each decoded array bitwise the written one
        by_kind = {"RGBA view": [p for p in world["digests"] if "templates" in p and not p.endswith("_depth.png")],
                   "depth map": [p for p in world["digests"] if p.endswith("_depth.png")],
                   "frame": [p for p in world["digests"] if "/test/" in p]}
        decode_ms = {}
        for kind, paths in by_kind.items():
            times = []
            for path in sorted(paths)[:12]:
                t = time.perf_counter()
                arr = read_png(path)
                times.append((time.perf_counter() - t) * 1e3)
                check(image_digest(arr) == world["digests"][path], f"{path} decodes bitwise as written")
            decode_ms[kind] = float(np.median(times))
        print(f"[eval] PNG decode ms on the host, median of up to 12 files: {decode_ms!r} (RGBA 640 x 480, "
              f"16-bit depth 640 x 480, RGB frame 960 x 1280; every row filter type in turn)")

        model = PicoPose("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16, device="cuda")
        init_random_(model, seed)
        calm_stage3_heads_(model)
        ckpt = os.path.join(root, "picopose.ckpt")
        t0 = time.perf_counter()
        save_torch_checkpoint(model, ckpt)
        exported = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        print(f"[eval] checkpoint {os.path.getsize(ckpt)} bytes written in {time.perf_counter() - t0!r} s")
        argv = ["--dataset", "smoke", "--config", os.path.join(here, "configs", "base.yaml"),
                "--checkpoint_path", ckpt, "--set", f"test_dataset.data_dir={world['data_dir']}",
                f"test_dataset.template_dir={world['template_root']}",
                f"test_dataset.detection_dir={world['det_dir']}"]

        def run(profiled: bool) -> dict:
            """One run_test.main with every count set to 0 just before and
            read just after, its calls recorded."""
            rec = {k: [] for k in ("loaded", "decoded", "ids", "rb_ms", "rb_args", "tem_ms", "bank_ev",
                                   "bank_host_ms", "wait_ms", "eval_s", "busy_ms")}
            fns = {name: getattr(mod, name) for mod, name in (
                (run_test, "load_flax_variables"), (bop_module, "read_png"), (bop_module, "read_image"),
                (runner, "run_batch_graphed"),
                (runner, "load_template_views"), (runner, "build_bank_graphed"), (run_test, "evaluate_dataset"),
                (runner, "_stream_batches"))}

            def load(model, variables):
                fns["load_flax_variables"](model, variables)
                rec["loaded"].append({k: v.detach().clone() for k, v in model.state_dict().items()})
                world["variables"] = variables  # phase 16 loads them again, unread

            def decoder(name):  # template views go through read_png, frames through read_image
                def decode(path):
                    arr = fns[name](path)
                    rec["decoded"].append((path, image_digest(arr)))
                    return arr
                return decode

            def one_batch(graphs, model, batch, bank, **kw):
                t = time.perf_counter()
                out, ids, _ = P._ranked_graphed(graphs, model, batch, bank, kw["hyp"], kw["pnp_iters"],
                                                kw["stage3_topk"], kw["generator"])
                rec["rb_ms"].append((time.perf_counter() - t) * 1e3)
                rec["ids"].append(ids[:, 0])
                if not rec["rb_args"]:
                    rec["rb_args"].append(((graphs, model, batch, bank), kw))
                return out

            def templates(*a, **kw):
                t = time.perf_counter()
                out = fns["load_template_views"](*a, **kw)
                rec["tem_ms"].append((time.perf_counter() - t) * 1e3)
                world.setdefault("templates", {})[a] = out  # for phase 11, which decodes none again
                return out

            def bank(*a, **kw):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                t = time.perf_counter()
                ev[0].record()
                out = fns["build_bank_graphed"](*a, **kw)
                ev[1].record()
                rec["bank_host_ms"].append((time.perf_counter() - t) * 1e3)
                rec["bank_ev"].append(ev)
                return out

            def stream(*a, **kw):  # the time the loop waits for each decoded batch
                it = fns["_stream_batches"](*a, **kw)
                while True:
                    t = time.perf_counter()
                    item = next(it, None)
                    rec["wait_ms"].append((time.perf_counter() - t) * 1e3)
                    if item is None:
                        return
                    yield item

            def evaluate(*a, **kw):
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                t = time.perf_counter()
                if not profiled:
                    out = fns["evaluate_dataset"](*a, **kw)
                else:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        out = fns["evaluate_dataset"](*a, **kw)
                        torch.cuda.synchronize()
                    rec["busy_ms"].append(sum(dev_us(e) for e in prof.key_averages()
                                              if e.device_type == DeviceType.CUDA) / 1e3)
                    rec["traced"] = traced_launches(prof.key_averages())
                rec["eval_s"].append(time.perf_counter() - t)
                return out

            cwd = os.getcwd()
            os.chdir(root)  # the CSV goes under ./log
            try:
                with patched((run_test, "load_flax_variables", load), (bop_module, "read_png", decoder("read_png")),
                             (bop_module, "read_image", decoder("read_image")),
                             (runner, "run_batch_graphed", one_batch), (runner, "load_template_views", templates),
                             (runner, "build_bank_graphed", bank), (run_test, "evaluate_dataset", evaluate),
                             (runner, "_stream_batches", stream)):
                    kernels.reset_launches()
                    native.reset_calls()
                    t = time.perf_counter()
                    (path,) = run_test.main(argv)
                    torch.cuda.synchronize()
                    rec["wall_s"] = time.perf_counter() - t
                    rec["launches"] = dict(kernels.LAUNCHES)
                    rec["host_calls"] = dict(native.CALLS)
            finally:
                os.chdir(cwd)
            with open(os.path.join(root, path)) as f:
                rec["rows"] = list(csv.reader(f))
            rec["bank_ms"] = [a.elapsed_time(b) for a, b in rec["bank_ev"]]
            return rec

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = run(profiled=False)
            second = run(profiled=True)

        # the weights, the images, the launches
        (loaded,) = first["loaded"]
        check(loaded.keys() == exported.keys() and all(
            loaded[k].dtype == exported[k].dtype and torch.equal(loaded[k], exported[k]) for k in exported),
            "the checkpoint loads bitwise as exported")
        decoded = dict(first["decoded"])
        check(decoded.keys() == world["digests"].keys(), "every PNG of the tree was decoded")
        check(all(decoded[p] == world["digests"][p] for p in decoded), "every decoded PNG is bitwise as written")
        print(f"[eval] launches during one run: by the wrappers {first['launches']}; in the profiled "
              f"run's trace {second['traced']}")
        check(first["launches"] == EVAL_LAUNCHES and second["launches"] == EVAL_LAUNCHES,
              f"the wrappers launched K1-K5 as the warm-ups of the run's programs imply: {EVAL_LAUNCHES}")
        check(second["traced"] == EVAL_TRACED,
              f"the trace holds K1-K5 as two banks and four batches through the run's programs imply: {EVAL_TRACED}")
        print(f"[eval] host library calls during one run (C++ fast path): {first['host_calls']!r}; "
              f"second run {second['host_calls']!r}")
        for rec in (first, second):
            calls = rec["host_calls"]
            check(calls.get("rle_counts_to_mask", 0) >= world["n_instances"]
                  and calls.get("crop_resize_normalize", 0) >= world["n_instances"] + 2 * 162,
                  "the run decoded every RLE and cut every detection's and template's rgb crop in C++")

        # the CSV: rows in the dataset's order, each detection's top view
        want = expected_rows(world)
        rows = first["rows"]
        check(len(rows) == world["n_instances"] == len(want), "one CSV row per instance")
        check([tuple(r[:4]) for r in rows] == [w[:4] for w in want], "rows in the dataset's order, as targeted")
        for r in rows:
            R, t = np.array(r[4].split(), float).reshape(3, 3), np.array(r[5].split(), float)
            check(len(r) == 7 and np.isfinite(R).all() and np.isfinite(t).all(), "finite R and t")
            check(np.abs(R.T @ R - np.eye(3)).max() < 1e-4, "orthonormal R")
            check(float(r[6]) > 0, "time > 0")
        # the runner's batches: each object's rows in CSV order, 16 then 4 (padded)
        top1 = []
        for ids, n in zip(first["ids"], (16, 4, 16, 4)):
            top1 += ids[:n].tolist()
        order = [w for obj in map(str, EVAL_OBJECTS) for w in want if w[2] == obj]
        pasted = [world["pasted"][int(w[0]), int(w[1]), w[4]] for w in order]
        hits = sum(a == b for a, b in zip(top1, pasted))
        print(f"[eval] top-1 template is the pasted view for {hits}/{len(pasted)} detections")
        check(len(top1) == len(pasted) and hits == len(pasted), "every detection selects its pasted view")
        same = [r[:6] for r in first["rows"]] == [r[:6] for r in second["rows"]]
        print(f"[eval] second run: first six columns equal {same}")
        check(same, "a second run gives the same scene, image, object, score, R and t")

        # times
        n = world["n_instances"]
        per_image = {}
        for r in rows:
            per_image[r[0], r[1]] = float(r[6])
        eval_s = first["eval_s"][0]
        print(f"[eval] load_template_views host ms per object {first['tem_ms']!r} (second run "
              f"{second['tem_ms']!r}); build_bank device ms per object (CUDA events) {first['bank_ms']!r}")
        print(f"[eval] run_test.main wall {first['wall_s']!r} s (checkpoint load included), evaluate_dataset "
              f"{eval_s!r} s for {n} instances = {n / eval_s!r} instances/s; mean per-image time (CSV) "
              f"{float(np.mean(list(per_image.values())))!r} s over {len(per_image)} images; second run "
              f"(profiled) wall {second['wall_s']!r} s")
        rest = eval_s * 1e3 - sum(first["tem_ms"]) - sum(first["bank_host_ms"]) - sum(first["wait_ms"]) \
            - sum(first["rb_ms"])
        print(f"[eval] evaluate_dataset host ms by part (first run): load_template_views {sum(first['tem_ms'])!r}, "
              f"build_bank calls {sum(first['bank_host_ms'])!r}, waits for decoded batches {sum(first['wait_ms'])!r} "
              f"({first['wait_ms']!r}), run_batch calls {sum(first['rb_ms'])!r}, the rest (uploads, reading "
              f"results back, CSV) {rest!r}")
        busy = second["busy_ms"][0]
        print(f"[eval] eval loop device busy {busy!r} ms (profiled run) of {eval_s * 1e3!r} ms (first run): "
              f"idle share {1 - busy / (eval_s * 1e3)!r}")
        (a, kw), = first["rb_args"]
        alone = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runner.run_batch_graphed(*a, **kw)
            alone.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        print(f"[eval] run_batch_graphed host ms (the call's return, device work queued; the first call "
              f"captures): in the runner "
              f"{first['rb_ms']!r} (second run {second['rb_ms']!r}); alone, 5 calls after one warm-up "
              f"median {float(np.median(alone[1:]))!r} ({alone[1:]!r})")
        world["rows"] = first["rows"]  # for phase 16
        del a, kw, first, second
        if then is not None:
            then(root, world, argv)

FORMAT_SCENE = 3  # the JPEG twins' scene: one detection of each object, after phase 7's scenes
FORMAT_TREES = {  # tree -> (scene, image) -> (variant, file under the scene)
    "a": {(1, 3): ("interlaced PNG", "rgb/000003.png"), (2, 7): ("LZW TIFF, predictor 2", "gray/000007.tif"),
          (FORMAT_SCENE, 1): ("progressive JPEG", "rgb/000001.jpg")},
    "b": {(1, 3): ("Deflate TIFF, predictor 2, 256 x 256 tiles", "gray/000003.tif"),
          (2, 7): ("Deflate TIFF, planar", "gray/000007.tif"), (FORMAT_SCENE, 1): ("baseline JPEG", "rgb/000001.jpg")},
}
FORMAT_JPEGS = {"progressive JPEG": "frame_progressive.jpg", "baseline JPEG": "frame_baseline.jpg"}


def format_bytes(variant: str, frame: np.ndarray, data_dir: str) -> bytes:
    """The file of ``variant`` holding ``frame`` (the JPEGs: the committed
    files, whatever ``frame`` is)."""
    from torch_image_files import png_bytes, tiff_bytes

    if variant in FORMAT_JPEGS:
        with open(os.path.join(data_dir, FORMAT_JPEGS[variant]), "rb") as f:
            return f.read()
    if variant == "interlaced PNG":
        return png_bytes(frame, 2, 8, interlace=True)
    if variant == "LZW TIFF, predictor 2":
        return tiff_bytes(frame, 2, 5, 2, rows_per_strip=64)
    if variant == "Deflate TIFF, planar":
        return tiff_bytes(frame, 2, 8, planar=True, rows_per_strip=64)
    return tiff_bytes(frame, 2, 8, 2, tile=(256, 256))  # Deflate, predictor 2, tiles


def host_cpu() -> str:
    """The host CPU's model name (or, where a VM hides it, vendor, family
    and model) and its CPU count, from ``lscpu``."""
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    except OSError:
        lscpu = ""
    field = dict(line.split(":", 1) for line in lscpu.splitlines() if ":" in line)
    field = {k.strip(): v.strip() for k, v in field.items()}
    cpu = field.get("Model name", "unknown")
    if cpu == "unknown":
        cpu = f"{field.get('Vendor ID', '?')} CPU family {field.get('CPU family', '?')} model {field.get('Model', '?')}"
    return cpu + f", {field.get('CPU(s)', '?')} CPUs"


def formats_phase(seed: int, root: str, world: dict, argv: list) -> None:
    """Phase 16: the image formats PIL reads, end to end (module
    docstring).  Two BOP trees beside phase 7's (``FORMAT_TREES``), its
    frames rewritten in the new variants and a third scene holding the
    committed progressive JPEG or its baseline twin, with one detection
    of each object; ``run_test.main`` on each, in this process, with phase
    7's checkpoint as phase 7's run read and ported it, and its decoded
    template views.  Per object the batches stay phase 7's (16, then 4 of
    phase 7's instances and the third scene's, padded), and the PnP draws
    are drawn per batch row, so phase 7's rows must come back bitwise and
    the twins' rows equal each other."""
    import concurrent.futures as cf
    import csv
    import json
    import warnings

    import picopose_tpu_torch.data.bop as bop_module
    from picopose_tpu_torch import kernels, run_test
    from picopose_tpu_torch.data.jpeg import decode_image
    from picopose_tpu_torch.data.tiff import encode_tiff
    from picopose_tpu_torch.eval import runner

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    data = os.path.join(here, "tests", "data")
    t_phase = time.perf_counter()
    frames = dict(world["frames"])
    frames[FORMAT_SCENE, 1] = decode_image(format_bytes("baseline JPEG", None, data))
    H, W = frames[FORMAT_SCENE, 1].shape[:2]
    dets, targets = list(world["dets"]), list(world["targets"])
    for obj, (y0, x0) in zip(EVAL_OBJECTS, ((200, 240), (420, 760))):
        mask = np.zeros((H, W), np.uint8)
        mask[y0 : y0 + 224, x0 : x0 + 224] = 1
        dets.append({"scene_id": FORMAT_SCENE, "image_id": 1, "category_id": obj, "bbox": [x0, y0, 224, 224],
                     "score": 0.9, "time": 0.05, "segmentation": rle_string(mask)})
        targets.append({"scene_id": FORMAT_SCENE, "im_id": 1, "obj_id": obj, "inst_count": 1})

    # the trees, their files encoded in threads (zlib and numpy release the GIL; LZW is Python)
    t0 = time.perf_counter()
    written, trees = {}, {}
    with cf.ThreadPoolExecutor(4) as pool:
        jobs = {(tree, key): pool.submit(format_bytes, variant, frames[key], data)
                for tree, files in FORMAT_TREES.items() for key, (variant, _) in files.items()}
        for tree, files in FORMAT_TREES.items():
            base = os.path.join(root, f"formats_{tree}")
            trees[tree] = base
            cams = {}
            for (scene, im), (variant, rel) in files.items():
                path = os.path.join(base, "bop", "smoke", "test", f"{scene:06d}", rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                blob = jobs[tree, (scene, im)].result()
                with open(path, "wb") as f:
                    f.write(blob)
                written[path] = (variant, (scene, im), blob)
                cams.setdefault(scene, {})[str(im)] = {"cam_K": world["K"]}
            for scene, cam in cams.items():
                with open(os.path.join(base, "bop", "smoke", "test", f"{scene:06d}", "scene_camera.json"), "w") as f:
                    json.dump(cam, f)
            with open(os.path.join(base, "bop", "smoke", "test_targets_bop19.json"), "w") as f:
                json.dump(targets, f)
            os.makedirs(os.path.join(base, "dets"))
            with open(os.path.join(base, "dets", "smoke.json"), "w") as f:
                json.dump(dets, f)
    print(f"[formats] two trees written in {time.perf_counter() - t0!r} s: "
          f"{sorted({v for v, _, _ in written.values()})}; file bytes "
          f"{ {v: len(b) for v, _, b in written.values()}!r}")

    # host decode ms of each variant beside its plain twin (the same pixels), one decode each
    cpu = host_cpu()
    twins = {"plain PNG (filters 0-4)": (png_bytes(frames[1, 3]), (1, 3)),
             "uncompressed TIFF": (encode_tiff(frames[2, 7]), (2, 7)),
             "baseline JPEG": (format_bytes("baseline JPEG", None, data), (FORMAT_SCENE, 1))}
    files = [*twins.items()] + [(v, (b, key)) for v, key, b in written.values() if v != "baseline JPEG"]
    decode_ms = {}
    for name, (blob, key) in files:
        t = time.perf_counter()
        arr = decode_image(blob, name)
        decode_ms[name] = (time.perf_counter() - t) * 1e3
        check(np.array_equal(arr, frames[key]), f"{name} decodes bitwise as written")
    print(f"[formats] host decode ms at {H} x {W} RGB, one decode each, on the host's {cpu}: {decode_ms!r}")

    # run_test on each tree
    rows, wall = {}, {}
    for tree, base in trees.items():
        decoded = {}
        real = bop_module.read_image

        def read(path):
            arr = real(path)
            decoded[path] = arr
            return arr

        parts = {}

        def timed(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
                return out
            return call

        cli = ["--version_id", str(16 + len(rows)), *argv]
        cli = [a.replace(world["data_dir"], os.path.join(base, "bop")).replace(world["det_dir"], os.path.join(base, "dets"))
               for a in cli]
        cwd = os.getcwd()
        os.chdir(root)
        try:
            with warnings.catch_warnings(), patched((bop_module, "read_image", read),
                                                    (runner, "load_template_views", lambda *a: world["templates"][a]),
                                                    (run_test, "load_any", lambda *a, **kw: world["variables"]),
                                                    (run_test, "load_flax_variables",
                                                     timed("weights", run_test.load_flax_variables)),
                                                    (run_test, "evaluate_dataset",
                                                     timed("evaluate_dataset", run_test.evaluate_dataset)),
                                                    (runner, "build_bank_graphed",
                                                     timed("build_bank", runner.build_bank_graphed)),
                                                    (runner, "run_batch_graphed",
                                                     timed("run_batch", runner.run_batch_graphed))):
                warnings.simplefilter("ignore")
                kernels.reset_launches()
                t0 = time.perf_counter()
                (path,) = run_test.main(cli)
                torch.cuda.synchronize()
                wall[tree] = {"run_test.main": time.perf_counter() - t0, **parts}
                launches = dict(kernels.LAUNCHES)
        finally:
            os.chdir(cwd)
        check(launches == EVAL_LAUNCHES, f"tree {tree}: the wrappers launched K1-K5 as phase 7's run: {EVAL_LAUNCHES}")
        check(decoded.keys() == {p for p in written if p.startswith(base)}, f"tree {tree}: every frame was decoded")
        for p, arr in decoded.items():
            check(np.array_equal(arr, frames[written[p][1]]), f"tree {tree}: {written[p][0]} decoded bitwise")
        with open(os.path.join(root, path)) as f:
            rows[tree] = [r[:6] for r in csv.reader(f)]

    phase7 = [r[:6] for r in world["rows"]]
    for tree in trees:
        old = [r for r in rows[tree] if int(r[0]) != FORMAT_SCENE]
        new = [r for r in rows[tree] if int(r[0]) == FORMAT_SCENE]
        check(old == phase7, f"tree {tree}: phase 7's frames give phase 7's CSV rows bitwise (all but time)")
        check(len(new) == len(EVAL_OBJECTS), f"tree {tree}: one row per detection of scene {FORMAT_SCENE}")
    del world["variables"]
    twin = [[r for r in rows[t] if int(r[0]) == FORMAT_SCENE] for t in ("a", "b")]
    check(twin[0] == twin[1], "the progressive JPEG's rows are bitwise its baseline twin's")
    print(f"[formats] s per tree (run_test.main and parts: the weights loaded, evaluate_dataset, its "
          f"build_bank and run_batch calls) {wall!r}; rows: {len(phase7)} of phase 7's bitwise in each tree, "
          f"the twins' {len(twin[0])} rows equal; phase {time.perf_counter() - t_phase!r} s")


ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_small")  # tests/make_orbax_fixture.py writes it
ORBAX_SHARDED = os.path.join("tests", "data", "orbax_sharded")  # and, with --processes 2, this
ORBAX_MODEL = dict(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3))  # the fixture's config, fp32


def fixture_tree(npz) -> dict:
    """The fixture's companion .npz -> the TrainState's tree as
    utils/orbax_read.py reads it: each leaf its tile repeated to its shape
    (``np.resize``), keys split at "/", a node keyed 0..n-1 a list (an
    index with no leaf, an empty optax state, None)."""
    tree: dict = {}
    for key in npz.files:
        if key.startswith("tile/"):
            path = key[5:].split("/")
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.resize(npz[key], tuple(npz["shape/" + key[5:]]))

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in out):
            return [out.get(str(i)) for i in range(max(int(k) for k in out) + 1)]
        return out
    return lists(tree)


def leaves_of(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in leaves_of(sub, f"{prefix}{name}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves_of(sub, f"{prefix}{i}/").items()}
    return {} if tree is None or isinstance(tree, tuple) else {prefix[:-1]: tree}


def orbax_phase(seed: int, root: str, world: dict, argv: list) -> None:
    """Phase 17: the JAX package's orbax checkpoints, read without JAX on
    the card's machine (module docstring), from the committed fixture
    (``ORBAX_FIXTURE``: the small model's variables at step 3 and an AdamW
    ``TrainState`` under grad_accum 2 at step 5, mid-accumulation, and
    their leaves as an .npz)."""
    import csv
    import warnings

    import picopose_tpu_torch.serve as serve_module
    from picopose_tpu_torch import kernels, run_test
    from picopose_tpu_torch.eval import runner
    from picopose_tpu_torch.native import codec
    from picopose_tpu_torch.serve import PoseEstimator
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.utils import checkpoint as ckpt
    from picopose_tpu_torch.utils.ocdbt import OcdbtStore
    from picopose_tpu_torch.utils.orbax_read import read_step_dir

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, ORBAX_FIXTURE)
    var_dir = os.path.join(fixture, "variables", "checkpoints", "3")
    train_log = os.path.join(fixture, "train")
    with np.load(os.path.join(fixture, "leaves.npz")) as z:
        ref = fixture_tree(z)
    want = leaves_of(ref)

    # every leaf bitwise the .npz's
    t0 = time.perf_counter()
    tree = read_step_dir(os.path.join(train_log, "checkpoints", "5"))
    read_s = time.perf_counter() - t0
    got = leaves_of(tree)
    check(got.keys() == want.keys(), f"the TrainState reads {len(got)} leaves, the .npz holds {len(want)}")
    for k, v in want.items():
        check(got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k], v),
              f"leaf {k} reads bitwise as the .npz holds it")
    variables = ckpt.load_any(var_dir)
    var_leaves = leaves_of(variables)
    check(var_leaves.keys() == {k for k in want if k.split("/")[0] in ("params", "batch_stats")}
          and all(np.array_equal(v, want[k]) for k, v in var_leaves.items()),
          "the variables step directory reads bitwise the .npz's params and batch_stats")
    nbytes = sum(v.nbytes for v in got.values())

    # the decoder on the fixture's largest frame, on the host's CPU
    item = os.path.join(train_log, "checkpoints", "5", "default")
    store = OcdbtStore(item)
    size, key = max((len(store.read(k)), k) for k in store.list() if not k.endswith(".zarray"))
    meta = json.loads(store.read(key.rsplit("/", 1)[0] + "/.zarray"))
    out_bytes = int(np.prod(meta["chunks"])) * np.dtype("<u2" if meta["dtype"] == "bfloat16" else meta["dtype"]).itemsize
    frame = store.read(key)
    out = np.empty(out_bytes, np.uint8)
    times = []
    for _ in range(5):
        t = time.perf_counter()
        codec.zstd_decompress(frame, out_bytes, out=out)
        times.append(time.perf_counter() - t)
    mbs = out_bytes / min(times) / 1e6
    print(f"[orbax] fixture TrainState: {len(got)} leaves, {nbytes} bytes decoded, read in {read_s!r} s "
          f"({nbytes / read_s / 1e9!r} GB/s, {os.cpu_count()} threads); its largest frame {key} ({size} -> "
          f"{out_bytes} bytes: a tile repeated, so matches, not literals) decodes at {mbs!r} MB/s, best of 5, "
          f"one thread, on the host's {host_cpu()}")

    # PoseEstimator from the orbax directory and from the .npz's variables, on phase 7's first frame
    t0 = time.perf_counter()
    frame_key = sorted(world["frames"])[0]
    img = world["frames"][frame_key]
    dets = [{"category_id": d["category_id"], "segmentation": d["segmentation"]} for d in world["dets"]
            if (d["scene_id"], d["image_id"]) == frame_key][:4]
    K = np.asarray(world["K"], np.float64).reshape(3, 3)
    poses = []
    for kw in ({"checkpoint": var_dir}, {"variables": {"params": ref["params"], "batch_stats": ref["batch_stats"]}}):
        est = PoseEstimator(**kw, **ORBAX_MODEL, compute_dtype="float32", seed=seed, n_template_view=EVAL_VIEWS)
        with patched((serve_module, "load_template_views", lambda *a: world["templates"][a])):  # phase 7's views
            for obj in sorted({d["category_id"] for d in dets}):
                est.register_object(obj, os.path.join(world["template_root"], "smoke"))
        res = est.estimate(img, K, dets)
        poses.append([(r.R, r.t, r.score) for r in res])
        del est
    check(len(poses[0]) == len(dets) and all(np.isfinite(R).all() and np.isfinite(t).all() for R, t, _ in poses[0]),
          "PoseEstimator(checkpoint=<orbax dir>): a finite pose per detection")
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
              for a, b in zip(*poses)), "PoseEstimator: the orbax directory's poses bitwise the .npz variables'")
    est_s = time.perf_counter() - t0

    # run_test.main on phase 7's tree, from the orbax directory and from the .npz's variables
    t0 = time.perf_counter()
    overrides = [f"model.vit_type={ORBAX_MODEL['vit_type']}", "model.blocks_to_take=[0,1,2,3]",
                 "model.compute_dtype=float32"]
    cli = list(argv)
    cli[cli.index("--checkpoint_path") + 1] = var_dir
    cli[cli.index("--set") + 1:cli.index("--set") + 1] = overrides
    rows, launches = [], []
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for i, variables_of in enumerate((None, lambda *a, **kw: {"params": ref["params"],
                                                                  "batch_stats": ref["batch_stats"]})):
            swaps = [(runner, "load_template_views", lambda *a: world["templates"][a])]
            if variables_of is not None:
                swaps.append((run_test, "load_any", variables_of))
            with warnings.catch_warnings(), patched(*swaps):
                warnings.simplefilter("ignore")
                kernels.reset_launches()
                (path,) = run_test.main(["--version_id", str(170 + i), *cli])
                torch.cuda.synchronize()
                launches.append(dict(kernels.LAUNCHES))
            with open(path) as f:
                rows.append([r[:6] for r in csv.reader(f)])
    finally:
        os.chdir(cwd)
    check(len(rows[0]) == len(world["rows"]), "run_test from the orbax directory: a row per instance")
    check(rows[0] == rows[1], "run_test: the orbax directory's CSV rows bitwise the .npz variables' (all but time)")
    check(all(launches[0].get(k, 0) > 0 for k in kernels.KERNELS if k != "match_scores_int8"),
          f"run_test from the orbax directory went through K1-K5: {launches[0]}")
    cli_s = time.perf_counter() - t0

    # resume: the TrainState restored from the orbax directory, from the .npz and from the two
    # processes' sharded save, one compiled step each
    t0 = time.perf_counter()
    tx = ts.make_optimizer(grad_accum=2)
    model_kw = dict(**ORBAX_MODEL, compute_dtype=torch.float32)
    a = ts.init_state(tx, seed, device="cuda", **model_kw)
    b = ts.init_state(tx, seed + 1, device="cuda", **model_kw)
    ckpt.restore(train_log, None, a)
    ckpt.load_payload(b, ckpt.train_payload_from_tree(ref, b, "leaves.npz"), "leaves.npz")
    diff = train_state_diff(a, b)
    check(not diff and a.step == 5 and a.optimizer.mini_step == 1 and a.optimizer.updates == 2,
          f"the restored states are bitwise equal, at step 5, mini_step 1, 2 updates: {diff[:4]}")
    t_sharded = time.perf_counter()
    c = ts.init_state(tx, seed + 2, device="cuda", **model_kw)
    ckpt.restore(os.path.join(here, ORBAX_SHARDED, "train"), None, c)
    diff = train_state_diff(a, c)
    check(not diff, f"the two processes' fsdp_tp save restores bitwise the one process's: {diff[:4]}")
    restore_sharded_s = time.perf_counter() - t_sharded
    batch = train_batch(2, seed)
    kernels.reset_launches()
    la = ts.make_train_step(a)(a, batch, torch.Generator(device="cuda").manual_seed(seed))
    lb = ts.make_train_step(b)(b, batch, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    diff = train_state_diff(a, b)
    check(all(torch.equal(la[k], lb[k]) for k in la) and not diff and a.optimizer.updates == 3,
          f"one compiled step from each: losses and the whole state bitwise, the update applied: {diff[:4]}")
    check(all(torch.isfinite(v).all() for v in la.values()), "the resumed step's losses are finite")
    t_sharded = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    lc = ts.make_train_step(c)(c, batch, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    step_sharded_s = time.perf_counter() - t_sharded
    diff = train_state_diff(a, c)
    check(all(torch.equal(la[k], lc[k]) for k in la) and not diff,
          f"the step from the sharded save: losses and the whole state bitwise the one process's: {diff[:4]}")
    ran = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    check(all(ran.get(k, 0) > 0 for k in ("layernorm", "attention", "corr_window", "warp")),
          f"the step from the sharded save went through K1, K2, K4 and K5: {ran}")
    del a, b, c
    torch.cuda.empty_cache()
    print(f"[orbax] PoseEstimator {est_s!r} s, run_test x2 {cli_s!r} s ({len(rows[0])} rows each, launches "
          f"{launches[0]}), resumed compiled step x3 {time.perf_counter() - t0!r} s (losses "
          f"{ {k: float(v) for k, v in la.items()}!r}); the sharded save's restore {restore_sharded_s!r} s and "
          f"step {step_sharded_s!r} s; phase {time.perf_counter() - t_phase!r} s")


DECODER_RADII = (1, 2, 3, 4)  # lookup radii: config radius 2, 4 (the default), 6 and 8 (RAFT's published 4)


def decoder_phase(seed: int, root: str, world: dict, argv: list) -> None:
    """Phase 11: the flow decoder as ``cfg.model`` sets it, at full width,
    on phase 7's BOP tree (``root``, ``world``, its ``run_test`` argv).

    1. ``run_test.main`` with ``--set model.radius=8`` (lookup radius 4)
       and a seeded radius-8 ViT-L checkpoint (calmed stage-3 heads) under
       a profiler, its template views as phase 7 decoded them: the model as built (radius, motion-encoder inputs), the
       CSV rows (the targets' order, orthonormal R, finite t, time > 0),
       the wrappers' launches (the programs' warm-ups, ``EVAL_LAUNCHES``)
       and the trace's (``EVAL_TRACED``: 3 K4 launches per run_batch
       execution, each a radius-4 kernel).
    2. The graphed ``run_batch`` of that model on the run's first batch and
       bank against the eager one from equal generator states (the
       capturing call and a replay), then graphed ``run_batch`` ms and
       crops/s of the radius-8 model and of a radius-4 model with the
       same seeded trunk and heads on the same batch and bank, in turns.
    3. K4 against its plain version at lookup radii 1, 2, 3 and 4 (K4_TOL):
       on the decoder's inputs captured from an eager ``run_batch`` of that
       model with a decoder of each radius (its three lookups; device ms
       per launch, plain ms, bound), and on wild centres at the same
       shapes (both of the tile kernel's paths; the tile counts printed).
    4. One ``train_step`` at radius 8, batch 8 (phase 8's ``init_state``
       and batch): the launches (96 LN, 48 attention, 3 K4, 3 K5) and
       finite losses."""
    import csv
    import warnings

    from picopose_tpu_torch import kernels, run_test
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.eval import runner
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.models.flow import FlowDecoder
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.train.augment import draw_affine_noise
    from picopose_tpu_torch.utils.graphs import GraphCache
    from picopose_tpu_torch.utils.torch_export import save_torch_checkpoint
    from picopose_tpu_torch.utils.weights import init_random_
    import picopose_tpu_torch.models.flow as flow_module

    vit = ("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16)
    model = PicoPose(*vit, device="cuda", radius=8)
    init_random_(model, seed)
    calm_stage3_heads_(model)
    ckpt = os.path.join(root, "picopose_radius8.ckpt")
    save_torch_checkpoint(model, ckpt)
    del model

    # 1. the CLI at config radius 8
    built, first = [], []
    real_batch = runner.run_batch_graphed

    def one_batch(graphs, model, batch, bank, **kw):
        if not first:
            first.append(((graphs, model, {k: v.clone() for k, v in batch.items()}, bank), kw))
        return real_batch(graphs, model, batch, bank, **kw)

    real_eval = run_test.evaluate_dataset

    def evaluate(model, *a, **kw):
        built.append(model)
        return real_eval(model, *a, **kw)

    i = argv.index("--checkpoint_path")  # phase 7's argv, its --set last
    cli = ["--version_id", "8", *argv[: i + 1], ckpt, *argv[i + 2 :], "model.radius=8"]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with warnings.catch_warnings(), patched((runner, "run_batch_graphed", one_batch),
                                                (run_test, "evaluate_dataset", evaluate),
                                                (runner, "load_template_views", lambda *a: world["templates"][a])):
            warnings.simplefilter("ignore")
            kernels.reset_launches()
            t0 = time.perf_counter()
            (path,), traced = trace_launches(lambda: run_test.main(cli))
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
    finally:
        os.chdir(cwd)
    (model,) = built
    fd = model.flow_decoder
    channels = [e.corr_net_0.in_channels for e in fd.encoder]
    print(f"[decoder] run_test --set model.radius=8: flow decoder num_levels {fd.num_levels}, radius {fd.radius} "
          f"(lookup radius {fd.radius // 2}), motion-encoder inputs {channels}; wall {wall!r} s (profiled); "
          f"launches by the wrappers {launches}, in the trace {traced}")
    check(fd.radius == 8 and fd.num_levels == 3 and channels == [81, 162, 243], "run_test built the radius-8 decoder")
    check(launches == EVAL_LAUNCHES, f"radius 8: the wrappers launched the programs' warm-ups {EVAL_LAUNCHES}")
    check(traced == EVAL_TRACED, f"radius 8: the trace holds 3 K4 launches per run_batch execution: {EVAL_TRACED}")
    with open(os.path.join(root, path)) as f:
        rows = list(csv.reader(f))
    want = expected_rows(world)
    check([tuple(r[:4]) for r in rows] == [w[:4] for w in want], "radius 8: one CSV row per instance, in order")
    for r in rows:
        R, t = np.array(r[4].split(), float).reshape(3, 3), np.array(r[5].split(), float)
        check(len(r) == 7 and np.isfinite(R).all() and np.isfinite(t).all(), "radius 8: finite R and t")
        check(np.abs(R.T @ R - np.eye(3)).max() < 1e-4 and float(r[6]) > 0, "radius 8: orthonormal R, time > 0")
    print(f"[decoder] radius 8: {len(rows)} CSV rows well formed")

    # 2. graphed against eager, and the radius's cost
    ((_, _, batch, bank), kw), = first
    hyp, iters = kw["hyp"], kw["pnp_iters"]
    graphs = GraphCache("cuda")
    gens = [torch.Generator(device="cuda").manual_seed(seed) for _ in range(2)]
    for tag in ("capturing call", "replay"):
        got = P._ranked_graphed(graphs, model, batch, bank, hyp, iters, None, gens[0])
        ref = P._ranked(model, batch, bank, hyp, iters, None, gens[1], None)
        torch.cuda.synchronize()
        res = graph_outputs_equal(f"radius 8, {tag}", got, ref)
        check(res["bitwise"], f"radius 8, {tag}: the graphed run_batch is bitwise the eager one")
    model4 = PicoPose(*vit, device="cuda")
    init_random_(model4, seed)
    calm_stage3_heads_(model4)
    B = batch["real_rgb"].shape[0]
    timed_ms = {4: [], 8: []}
    caches = {4: GraphCache("cuda"), 8: GraphCache("cuda")}
    models = {4: model4, 8: model}
    for r in (4, 8):  # captures
        P.run_batch_graphed(caches[r], models[r], batch, bank, hyp=hyp, pnp_iters=iters, generator=gens[0])
    for r in (4, 8, 8, 4) * 3:
        timed_ms[r] += host_ms(lambda: P.run_batch_graphed(caches[r], models[r], batch, bank, hyp=hyp,
                                                           pnp_iters=iters, generator=gens[0]), 2)
    for r in (4, 8):
        med = float(np.median(timed_ms[r]))
        print(f"[decoder] graphed run_batch ({B} queries x {hyp} hypotheses, {iters} PnP iterations) at config "
              f"radius {r}: median {med!r} ms of {len(timed_ms[r])} = {B / med * 1e3!r} crops/s ({timed_ms[r]!r})")
    del caches, graphs, model4

    # 3. K4 at lookup radii 1 to 4
    saved = model.flow_decoder
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    lookup = flow_module.corr_lookup
    try:
        for r in DECODER_RADII:
            dec = FlowDecoder(3, 2 * r).to("cuda")
            init_random_(dec, seed)
            model.flow_decoder = dec.eval()
            calm_stage3_heads_(model)
            seen = []

            def recording_lookup(*a, **kw):
                seen.append((*a, kw.get("group", 1)))
                return lookup(*a, **kw)

            flow_module.corr_lookup = recording_lookup
            kernels.reset_launches()
            P.run_batch(model, batch, bank, hyp=hyp, pnp_iters=iters, generator=gens[1])
            flow_module.corr_lookup = lookup
            torch.cuda.synchronize()
            check(kernels.LAUNCHES["corr_window"] == 3 and [s_[3] for s_ in seen] == [r] * 3,
                  f"lookup radius {r}: three K4 launches per run_batch")
            # timed at the lookup radii of config radius 4 and 8 (PR 11 timed all four)
            corr_on_main_path(seen, f"decoder inputs, lookup radius {r}", timed=r in (2, 4))
            del seen
            wild = wild_corr_args(g, r, {16: 1, 32: 1, 64: 1})
            corr_timing(f"wild centres, lookup radius {r}", wild, timed=False)
            del wild
    finally:
        flow_module.corr_lookup = lookup
        model.flow_decoder = saved
    del model, batch, bank, first, built
    torch.cuda.empty_cache()

    # 4. one training step at radius 8
    dev = torch.device("cuda")
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(8, seed).items()}
    state = ts.init_state(ts.make_optimizer(), seed, vit_type=vit[0], blocks_to_take=vit[1], compute_dtype=vit[2],
                          radius=8)
    noise = draw_affine_noise(8, torch.Generator(device=dev).manual_seed(seed + 8))
    kernels.reset_launches()
    losses = ts.train_step(state, tbatch, noise)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[decoder] train_step at config radius 8, batch 8: launches {launches}; loss terms "
          + ", ".join(f"{k} {float(v)!r}" for k, v in losses.items()))
    check(launches == {"layernorm": 96, "attention": 48, "corr_window": 3, "warp": 3},
          "radius 8: a train_step launches 96 LN, 48 attention, 3 K4 and 3 K5")
    check(all(bool(torch.isfinite(v)) for v in losses.values()), "radius 8: every loss finite")
    del state, tbatch


TRAIN_GROUPS = ("feature_extractor", "affine_regressor", "dpt_head", "flow_decoder")


def calm_inplane_head_(model) -> None:
    """Scale the stage-2 in-plane head's last layer by 0.01 and set its bias
    to (1, 1), so every in-plane prediction starts near one direction and
    depends on the features 100 times less.  The in-plane loss is arccos
    of the prediction's dot with the GT direction, whose gradient
    1 / sqrt(1 - dot^2) grows without bound as |dot| -> 1: a seeded random
    head predicts nearly one direction for every sample (ViT-L: within
    0.3 rad over a loop batch), and a sample whose GT lies next to it
    (dot 0.9996) turns the bf16 paths' ~1e-3 differences in dot into
    gradients that differ by more than themselves."""
    with torch.no_grad():
        last = model.affine_regressor.inplane_predictor[4]
        last.weight.mul_(0.01)
        last.bias.fill_(1.0)


def calm_scale_head_(model) -> None:
    """Scale the stage-2 scale head's last layer by 0.01 and set its bias to
    1, so every scale prediction starts near 1, as a trained model's do.
    The seeded random head puts all eight predictions of the batch under
    the loss's 5e-3 clamp, where the scale term (28 of the first step's 41)
    has no gradient and the other terms' fall hides under it."""
    with torch.no_grad():
        last = model.affine_regressor.scale_predictor[4]
        last.weight.mul_(0.01)
        last.bias.fill_(1.0)
TRAIN_LOSS_REL = 0.02  # each loss term, kernel path vs plain path (bf16 rounds at other points)
TRAIN_REMAT_REL_RMS = 0.05  # gradients with remat vs without, per group


def train_batch(B: int, seed: int) -> dict:
    """B synthetic sphere pairs at 224^2 from the port's data/synthetic.py:
    a template and a query view of one sphere from nearby viewpoints."""
    from picopose_tpu_torch.data.synthetic import make_pose, make_view

    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        az, el = rng.uniform(-np.pi, np.pi), rng.uniform(-0.8, 0.8)
        pairs.append(((az, el, rng.uniform(0.45, 0.6)),
                      (az + rng.uniform(-0.3, 0.3), el + rng.uniform(-0.2, 0.2), rng.uniform(0.5, 0.7))))
    batch = {}
    for side, idx in (("tem", 0), ("real", 1)):
        views = [make_view(make_pose(*p[idx]), 0.05) for p in pairs]
        for key in ("rgb", "mask", "M", "K", "pose", "full_depth"):
            batch[f"{side}_{key}"] = np.stack([getattr(v, key) for v in views])
    return batch


def rel_rms_by_group(got: dict, ref: dict) -> dict:
    out = {}
    for grp in TRAIN_GROUPS:
        keys = [k for k in ref if k.startswith(grp)]
        num = sum(float(((got[k].double() - ref[k].double()) ** 2).sum()) for k in keys)
        den = sum(float((ref[k].double() ** 2).sum()) for k in keys)
        out[grp] = (num / den) ** 0.5
    return out


def step_kernel_vs_plain(state, plain_state, batch, noise, launches: dict, tag: str) -> dict:
    """One train_step of ``state`` through the kernels (its launches must be
    ``launches``) and of ``plain_state`` (the same weights) through the plain
    dispatchers, on the same batch and noise: loss terms within
    TRAIN_LOSS_REL and gradients by parameter group within GRAD_REL_RMS
    relative RMS, every gradient finite and every group's non-zero.  Both
    states' stage-2 scale and in-plane heads are calmed first
    (``calm_scale_head_``, ``calm_inplane_head_``): near the log-scale
    term's 5e-3 clamp and the in-plane arccos's |dot| = 1, a seeded random
    head's gradients amplify the bf16 paths' differences without bound
    (phase 9's loop batch on an H100, uncalmed: 0.25 relative RMS in the
    stage-2 head, 0.19 in the ViT, 2.5 in the in-plane head's last layer).
    Returns the kernel path's gradients."""
    import picopose_tpu_torch.models.dinov2 as vit_module
    import picopose_tpu_torch.models.flow as flow_module
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.ops import attention as A
    from picopose_tpu_torch.ops import corr as CO
    from picopose_tpu_torch.ops import layernorm as L
    from picopose_tpu_torch.ops import sample as SA
    from picopose_tpu_torch.train import step as ts

    lrs = []
    for model in (state.model, plain_state.model):
        calm_scale_head_(model)
        calm_inplane_head_(model)

    def step_with_grads(st):
        grads = {}
        opt = st.optimizer
        apply = opt.apply

        def keep():
            grads.update({n: p.grad.detach().clone() for n, p in st.model.named_parameters()})
            lrs.append(float(opt.lr))
            apply()

        with patched((opt, "apply", keep)):
            losses = ts.train_step(st, batch, noise)
        torch.cuda.synchronize()
        return losses, grads

    kernels.reset_launches()
    lk, gk = step_with_grads(state)
    check(dict(kernels.LAUNCHES) == launches, f"{tag} a train_step launches {launches}")
    plain_lookup = lambda f1, f2, fl, r, levels, group=1: CO._corr_lookup(f1, f2, fl, r, levels, group)
    plain_warp = lambda feat, fl, group=1: SA._warp_by_flow(feat, fl, group)
    with patched((vit_module, "layernorm", L.layernorm_plain), (vit_module, "attention", A.attention_plain),
                 (CO, "corr_windows", CO.corr_windows_plain), (flow_module, "corr_lookup", plain_lookup),
                 (SA, "warp", SA.warp_plain), (flow_module, "warp_by_flow", plain_warp)):
        kernels.reset_launches()
        lp, gp = step_with_grads(plain_state)
    check(not kernels.LAUNCHES, f"{tag} the plain step launched no kernel")
    loss_rel = {k: abs(float(lk[k] - lp[k])) / max(abs(float(lp[k])), 1e-6) for k in lk}
    grad_rel = rel_rms_by_group(gk, gp)
    worst = sorted(((float((gk[n].float() - gp[n].float()).norm() / gp[n].float().norm().clamp_min(1e-30)), n)
                    for n in gk), reverse=True)[:3]
    model = state.model
    dparam = max(float((a.detach() - b.detach()).abs().max())
                 for a, b in zip(model.parameters(), plain_state.model.parameters()))
    dstat = max(float((a - b).abs().max()) for (n, a), (_, b) in zip(model.named_buffers(),
                                                                       plain_state.model.named_buffers()))
    print(f"{tag} kernel path loss terms: " + ", ".join(f"{k} {float(v)!r}" for k, v in lk.items()))
    print(f"{tag} plain path loss terms: " + ", ".join(f"{k} {float(v)!r}" for k, v in lp.items()))
    print(f"{tag} kernel vs plain: loss terms relative difference max {max(loss_rel.values())!r} (bound "
          f"{TRAIN_LOSS_REL!r}); gradient relative RMS by group {grad_rel!r} (bound {GRAD_REL_RMS!r}); after the "
          f"step (lr {lrs[0]!r}) largest parameter difference {dparam!r}, "
          f"BatchNorm statistics {dstat!r}; the largest relative differences by parameter {worst!r}")
    check(max(loss_rel.values()) <= TRAIN_LOSS_REL, f"{tag} kernel-path losses agree with the plain path")
    check(max(grad_rel.values()) <= GRAD_REL_RMS, f"{tag} kernel-path gradients agree with the plain path")
    check(all(bool(torch.isfinite(v).all()) for v in gk.values()), f"{tag} every gradient finite")
    check(all(any(float(v.abs().max()) > 0 for k, v in gk.items() if k.startswith(grp)) for grp in TRAIN_GROUPS),
          f"{tag} every parameter group has a non-zero gradient")
    return gk


def index_add_forms() -> tuple:
    """``patched`` triples that put back the gathers' former backward:
    ``index_select`` (``index_add_``, atomic on the card) in the warp's
    and the resize's recomputed forms and the infoNCE feature rows."""
    from picopose_tpu_torch.ops import resize as RS
    from picopose_tpu_torch.ops import sample as SA
    from picopose_tpu_torch.train import losses as LS

    old = lambda x, dim, index: x.index_select(dim, index)
    return tuple((module, "index_select", old) for module in (SA, RS, LS))


TRAIN_FORWARD = {"layernorm": 96, "attention": 48, "corr_window": 3, "warp": 3}  # one full-width step's kernels
TRAIN_REMAT = {"layernorm": 192, "attention": 96, "corr_window": 3, "warp": 3}  # with the blocks recomputed


def train_state_diff(a, b) -> list[str]:
    """What differs between two train states, bitwise: parameters and
    BatchNorm statistics by name, gradients, moments and ``count`` by
    index, and the host counters."""
    def tensors(st):
        opt = st.optimizer
        out = dict(st.model.state_dict())
        out.update({f"grad {i}": g for i, g in enumerate(opt.grads)})
        out.update({f"{k} {i}": t for k, m in opt.moments.items() for i, t in enumerate(m)})
        out["count"] = opt.count
        return out

    ta, tb = tensors(a), tensors(b)
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    counters = lambda st: (st.step, st.optimizer.updates, st.optimizer.mini_step)
    return bad + ([f"counters {counters(a)} vs {counters(b)}"] if counters(a) != counters(b) else [])


def compiled_step_phase(seed: int, batch: dict, noise_seed: int, model_kw: dict) -> dict:
    """Phase 8's compiled step (train/step.py::make_train_step) at full
    width, against the eager ``train_step`` from equal states and noise
    generators: AdamW and SGD at grad_accum 1 and 2, three calls each,
    losses, parameters, statistics, gradients, moments, ``count`` and the
    generator bitwise; the wrappers' launches (the capturing call's
    warm-up, none on a replay); SGD at grad_accum 1 with the caller's TF32
    flags on around the compiled calls.  After AdamW at grad_accum 2 (in
    the middle of an accumulation) the eager state is saved, the compiled
    state takes a fourth step, is restored from the file in place and its
    replay equals the eager next step.  Then one replay's kernels in a
    profiler trace, without and with ViT remat (a second program), remat's
    compiled step against the eager one (after AdamW at grad_accum 1).
    Returns the trace's launches per replay without remat."""
    import shutil
    import tempfile

    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device("cuda")
    eager_model = ts.init_state(ts.make_optimizer(), seed, **model_kw).model
    graphed_model = ts.init_state(ts.make_optimizer(), seed, **model_kw).model
    calm_scale_head_(eager_model)
    calm_scale_head_(graphed_model)
    start = {k: v.clone() for k, v in eager_model.state_dict().items()}
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="train_phase_", dir=here)
    try:
        for opt_type, accum in (("AdamW", 1), ("AdamW", 2), ("SGD", 1), ("SGD", 2)):
            tag = f"[train] compiled {opt_type} grad_accum {accum}"
            tx = ts.make_optimizer(opt_type=opt_type, grad_accum=accum)  # base.yaml's lr and schedule
            states = []
            for model in (eager_model, graphed_model):
                model.load_state_dict(start)
                model.zero_grad(set_to_none=True)
                states.append(ts.TrainState(0, model, tx.init(model.parameters())))
            eager, graphed = states
            g_eager, g_graph = (torch.Generator(device=dev).manual_seed(noise_seed) for _ in range(2))
            step = ts.make_train_step(graphed)
            tf32 = opt_type == "SGD" and accum == 1
            flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            results = []
            for call in range(3):
                le = ts.train_step(eager, batch, g_eager)
                kernels.reset_launches()
                t0 = time.perf_counter()
                if tf32:
                    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
                try:
                    lg = step(graphed, batch, g_graph)
                    torch.cuda.synchronize()
                    kept = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
                finally:
                    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
                call_s = time.perf_counter() - t0
                diff = train_state_diff(graphed, eager)
                same_loss = all(torch.equal(lg[k], le[k]) for k in le)
                same_gen = torch.equal(g_graph.get_state(), g_eager.get_state())
                results.append((same_loss, diff, same_gen))
                print(f"{tag} call {call + 1}: {call_s!r} s, the wrappers' launches {dict(kernels.LAUNCHES)}; "
                      f"losses bitwise {same_loss} (loss {float(lg['loss'])!r} vs {float(le['loss'])!r}); "
                      f"state tensors that differ {len(diff)} {diff[:6]}; generator state equal {same_gen}"
                      + (f"; TF32 flags on around the call, after it {kept}" if tf32 else ""))
                if call < (1 if accum == 1 else 2):  # grad_accum 2: the second call captures the update
                    check(dict(kernels.LAUNCHES) == TRAIN_FORWARD, f"{tag}: the capturing call's warm-up launched "
                          "one step's kernels")
                else:
                    check(not kernels.LAUNCHES, f"{tag}: a replay's wrappers count nothing")
                if tf32:
                    check(kept == (True, True), f"{tag}: the caller's TF32 flags stay as set")
            check(all(a and not d and c for a, d, c in results),
                  f"{tag}: three compiled calls bitwise three eager steps (losses, state, generator)")
            captures = sum(step.graphs.captures.values())
            check(captures == (1 if accum == 1 else 2) and step.graphs.replays["train_step"] == 3,
                  f"{tag}: {captures} programs captured, 3 replays")
            moved = sum(not torch.equal(start[k], v) for k, v in graphed.model.state_dict().items())
            print(f"{tag}: captures {dict(step.graphs.captures)} in {dict(step.graphs.capture_s)} s; "
                  f"{moved} of {len(start)} state-dict tensors moved")
            if opt_type == "AdamW" and accum == 2:
                # restore after capture, in the middle of an accumulation
                log_dir = os.path.join(tmp, "log")
                mini_step = eager.optimizer.mini_step
                t0 = time.perf_counter()
                ckpt.save(log_dir, eager.step, eager, 0)
                save_s = time.perf_counter() - t0
                step(graphed, batch, g_graph)  # a fourth step: the compiled state moves on
                address = lambda st: [t.data_ptr() for t in (*st.model.parameters(), *st.model.buffers(),
                                                             *st.optimizer.tensors())]
                before = address(graphed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.restore(log_dir, None, graphed)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                g_graph.set_state(g_eager.get_state())
                same_address, diff = address(graphed) == before, train_state_diff(graphed, eager)
                le, lg = ts.train_step(eager, batch, g_eager), step(graphed, batch, g_graph)
                torch.cuda.synchronize()
                after = train_state_diff(graphed, eager)
                same = all(torch.equal(lg[k], le[k]) for k in le)
                print(f"{tag}: saved mid-accumulation (mini_step {mini_step}) in {save_s!r} s, "
                      f"restored after capture in {restore_s!r} s, every tensor at its address {same_address}, "
                      f"differing tensors after the restore {len(diff)}; the next replay against the next eager "
                      f"step: losses bitwise {same}, differing tensors {len(after)} {after[:6]}")
                check(mini_step == 1 and same_address and not diff,
                      f"{tag}: restore after capture copies the state saved mid-accumulation in place")
                check(same and not after, f"{tag}: the replay after the restore equals the eager next step")
                shutil.rmtree(log_dir)
            if opt_type == "AdamW" and accum == 1:
                # one replay's kernels in a trace, then the remat program
                for attempt in range(3):  # a trace that lost events is taken again, on the next step
                    kernels.reset_launches()
                    _, traced = trace_launches(lambda: step(graphed, batch, g_graph))
                    counted = dict(kernels.LAUNCHES)
                    print(f"[train] one compiled step's replay in a profiler trace: {traced}; the wrappers counted "
                          f"{counted}")
                    ts.train_step(eager, batch, g_eager)
                    if counted or not lost_events(traced, TRAIN_FORWARD):
                        break
                    print("[train] the trace lost events; tracing the next step's replay")
                check(traced == TRAIN_FORWARD and not counted,
                      "a replay ran K1 (96), K2 (48), K4 (3) and K5 (3), and no wrapper counted it")
                train_launches = traced
                for model in (eager_model, graphed_model):
                    model.feature_extractor.dinov2.remat = True
                le, lg = ts.train_step(eager, batch, g_eager), step(graphed, batch, g_graph)
                torch.cuda.synchronize()
                diff = train_state_diff(graphed, eager)
                for attempt in range(3):  # a trace that lost events is taken again, on the next step
                    kernels.reset_launches()
                    _, traced_r = trace_launches(lambda: step(graphed, batch, g_graph))
                    print(f"[train] remat: the compiled step (a new program, captures {dict(step.graphs.captures)}) "
                          f"against the eager: losses bitwise {all(torch.equal(lg[k], le[k]) for k in le)}, "
                          f"differing tensors {len(diff)}; a replay in a trace {traced_r}, the wrappers "
                          f"{dict(kernels.LAUNCHES)}")
                    if kernels.LAUNCHES or not lost_events(traced_r, TRAIN_REMAT):
                        break
                    print("[train] remat: the trace lost events; tracing the next step's replay")
                check(all(torch.equal(lg[k], le[k]) for k in le) and not diff,
                      "remat: the compiled step equals the eager step")
                check(traced_r == TRAIN_REMAT and not kernels.LAUNCHES,
                      "remat: a replay ran K1 (96 + 96) and K2 (48 + 48), K4 (3) and K5 (3)")
                check(step.graphs.captures["train_step"] == 2, "remat: a program of its own")
                for model in (eager_model, graphed_model):
                    model.feature_extractor.dinov2.remat = False
            del step, states, eager, graphed
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return train_launches


def train_phase(seed: int) -> dict:
    """Phase 8: the training step at full ViT-L width (dinov2_vitl14, taps
    5/11/17/23, bf16 compute, fp32 weights from ``seed``), batch 8 of
    synthetic sphere pairs at 224^2, AdamW with configs/base.yaml's settings
    and WarmupCosineLR.  Returns the kernels' launches per training step and
    the median ms per step."""
    import picopose_tpu_torch.models.dinov2 as vit_module
    import picopose_tpu_torch.models.flow as flow_module
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.device import deterministic_cudnn
    from picopose_tpu_torch.ops import attention as A
    from picopose_tpu_torch.ops import corr as CO
    from picopose_tpu_torch.ops import layernorm as L
    from picopose_tpu_torch.ops import resize as RS
    from picopose_tpu_torch.ops import sample as SA
    from picopose_tpu_torch.train import losses as losses_module
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.train.augment import draw_affine_noise
    from picopose_tpu_torch.utils.weights import init_random_

    dev = torch.device("cuda")
    B = 8
    t0 = time.perf_counter()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(B, seed).items()}
    print(f"[train] {B} sphere pairs rendered at 224^2 in {time.perf_counter() - t0!r} s on the host")
    model_kw = dict(vit_type="dinov2_vitl14", blocks_to_take=(5, 11, 17, 23), compute_dtype=torch.bfloat16)
    tx = ts.make_optimizer()  # configs/base.yaml: AdamW lr 1e-5, betas (0.5, 0.999), eps 1e-6, wd 5e-4
    noise_seed = seed + 8
    noise = draw_affine_noise(B, torch.Generator(device=dev).manual_seed(noise_seed))
    state = ts.init_state(tx, seed, **model_kw)
    model = state.model
    vit = model.feature_extractor.dinov2
    check(model.device.type == "cuda" and model.training, "init_state: the model on the card, in train mode")

    seen, warps = [], []
    detach = lambda a: tuple(x.detach() if isinstance(x, torch.Tensor) else x for x in a)

    def forward_backward(remat: bool, record: bool = False):
        """One forward_train + backward from the model's weights (no update),
        with cuDNN's deterministic algorithms as ``train_step`` takes them:
        (losses, gradients by name, launches of the forward, of the backward,
        peak GiB)."""
        vit.remat = remat
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lookup, warp = flow_module.corr_lookup, flow_module.warp_by_flow
        if record:
            def recording_lookup(*a, **kw):
                seen.append((*detach(a), kw.get("group", 1)))
                return lookup(*a, **kw)

            def recording_warp(feat, flow, group=1):
                warps.append((feat.detach(), flow.detach(), group))
                return warp(feat, flow, group=group)

            flow_module.corr_lookup, flow_module.warp_by_flow = recording_lookup, recording_warp
        kernels.reset_launches()
        try:
            losses = ts.forward_train(model, batch, noise)
        finally:
            flow_module.corr_lookup, flow_module.warp_by_flow = lookup, warp
        torch.cuda.synchronize()
        fwd = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        with deterministic_cudnn():
            losses["loss"].backward()
        torch.cuda.synchronize()
        bwd = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        vit.remat = False
        return {k: v.detach() for k, v in losses.items()}, grads, fwd, bwd, peak

    # 1. launches of one step; 5. remat; 6. repeatability
    t0 = time.perf_counter()
    l0, g0, fwd, bwd, peak = forward_backward(False, record=True)
    first_s = time.perf_counter() - t0
    print(f"[train] launches of one step without remat: forward {fwd}, backward {bwd} "
          f"(first forward + backward {first_s!r} s)")
    check(fwd == {"layernorm": 96, "attention": 48, "corr_window": 3, "warp": 3},
          "the forward went through K1 (96), K2 (48), K4 (3) and K5 (3)")
    check(not bwd, "the backward launched no kernel without remat")
    check(all(bool(torch.isfinite(v)) for v in l0.values()), "every loss finite")
    check(len(seen) == 3 and [s[4] for s in seen] == [1, 2, 3] and all(s[5] == 1 for s in seen),
          "the decoder's three lookups were captured, group 1")
    check([w[0].shape[1] for w in warps] == [16, 32, 64] and all(w[2] == 1 for w in warps),
          "the decoder's three warps were captured, group 1")
    print("[train] loss terms: " + ", ".join(f"{k} {float(v)!r}" for k, v in l0.items()))
    l1, g1, *_ = forward_backward(False)
    rep = rel_rms_by_group(g1, g0)
    rep_abs = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
    same_loss, same_grad = all(torch.equal(l0[k], l1[k]) for k in l0), all(torch.equal(g0[k], g1[k]) for k in g0)
    print(f"[train] two identical steps: losses bitwise equal {same_loss}, "
          f"largest loss difference {max(abs(float(l0[k] - l1[k])) for k in l0)!r}; gradients bitwise equal "
          f"{same_grad}, largest difference {rep_abs!r}, relative RMS by group {rep!r}")
    check(same_loss and same_grad, "two identical training steps give bitwise equal losses and gradients")
    del g1
    lr_, gr, fwd_r, bwd_r, peak_r = forward_backward(True)
    rem = rel_rms_by_group(gr, g0)
    print(f"[train] launches with remat: forward {fwd_r}, backward {bwd_r}; peak device memory GiB without "
          f"remat {peak!r}, with {peak_r!r}")
    print(f"[train] remat vs not: losses bitwise equal {all(torch.equal(l0[k], lr_[k]) for k in l0)}; gradient "
          f"relative RMS by group {rem!r} (bound {TRAIN_REMAT_REL_RMS!r}; two identical steps {max(rep.values())!r})")
    check(fwd_r == fwd and bwd_r == {"layernorm": 96, "attention": 48},
          "remat: the backward recomputes the blocks through K1 (96) and K2 (48)")
    check(all(torch.equal(l0[k], lr_[k]) for k in l0), "remat leaves the loss unchanged")
    check(max(rem.values()) <= TRAIN_REMAT_REL_RMS, "remat gradients agree")
    del gr

    # the gathers' backward: each op's spread over two passes on the same
    # inputs, in the package's fixed-order form and in the index_add_ form
    # it replaced (atomic on the card), then the step's device time in both
    gen = torch.Generator(device=dev).manual_seed(seed + 10)

    def backward_spread(fn, *inputs):
        """The largest difference between two backward passes of ``fn`` on the
        same inputs and cotangent, over the largest gradient."""
        outs = []
        for _ in range(2):
            xs = [x.detach().clone().requires_grad_() for x in inputs]
            y = fn(*xs)
            cot = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev).to(y.dtype)
            outs.append(torch.autograd.grad(y, xs, cot))
        return max(float((a.float() - b.float()).abs().max() / b.float().abs().max()) for a, b in zip(*outs))

    f1, f2, fl = seen[2][:3]
    ft, fw = warps[2][:2]
    x = torch.randn(B, 640, 64, 64, generator=gen, device=dev).bfloat16().contiguous(memory_format=torch.channels_last)
    w = (torch.randn(1024, 640, 3, 3, generator=gen, device=dev) * 0.02).bfloat16()
    feat = torch.randn(B * 256, 1024, generator=gen, device=dev)
    idx = torch.randint(0, B * 256, (B * 256,), generator=gen, device=dev)
    for form, patches in (("fixed-order", ()), ("index_add_", index_add_forms())):
        with patched(*patches):
            spreads = {
                "corr_lookup 64^2, 3 levels": backward_spread(lambda a, b, c: CO.corr_lookup(a, b, c, 2, 3, 1), f1, f2, fl),
                "warp_by_flow 64^2": backward_spread(lambda a, b: SA.warp_by_flow(a, b, 1), ft, fw),
                "resize_bilinear 32^2 -> 64^2": backward_spread(lambda a: RS.resize_bilinear(a, (64, 64)),
                                                                ft[:, :32, :32].contiguous()),
                "infoNCE feature rows": backward_spread(lambda a: losses_module.index_select(a, 0, idx), feat),
            }
        print(f"[train] {form} gathers: one backward run twice on the same inputs, largest difference over the "
              f"largest gradient: {spreads!r}")
        if form == "fixed-order":
            check(not any(spreads.values()), "every fixed-order gather's backward is repeatable")
    conv_spread = backward_spread(lambda a, b: torch.nn.functional.conv2d(a, b, padding=1), x, w)
    print(f"[train] conv 640 -> 1024 3x3 at 64^2 bf16 (cuDNN dgrad + wgrad), run twice: {conv_spread!r}")
    del x, w, feat

    def step_device_ms(form: str) -> float:
        patches = index_add_forms() if form == "index_add_" else ()
        with patched(*patches):
            busy, _, _ = profile_batch(lambda: forward_backward(False), top=0)
        return busy

    step_device_ms("fixed-order")  # a warm-up of the profiler
    costs = {form: [step_device_ms(form)] for form in ("fixed-order", "index_add_")}
    for form in ("index_add_", "fixed-order"):
        costs[form].append(step_device_ms(form))
    print(f"[train] forward + backward device busy ms (fixed-order, index_add_, index_add_, fixed-order): "
          f"{costs!r}; mean fixed-order {float(np.mean(costs['fixed-order']))!r}, index_add_ "
          f"{float(np.mean(costs['index_add_']))!r}")

    # 2. kernel path vs plain path: one step from the same state
    init_random_(model, seed)
    gk = step_kernel_vs_plain(state, ts.init_state(tx, seed, **model_kw), batch, noise, fwd, "[train]")
    del gk, g0

    # 3. K1, K2, K4 and K5 at the training step's shapes
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    rows = {"layernorm": layernorm_row(g, B, "train"), "attention": attention_row(g, "qkv views", B, "train"),
            "corr_window": corr_on_main_path(seen, "training step, group 1"),
            "warp": warp_on_main_path(warps, "training step, group 1")}
    del seen[:], warps[:]
    for name, r in rows.items():
        print(f"[train] {name} at the training shapes: max_abs_err {r['err']!r} ({r['tol']}), kernel {r['ms']!r} ms "
              f"per launch, plain {r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound {r['bound'][0]!r} ms "
              f"({r['bound'][1]}); timed by {r['timed_by']}")

    # 4. overfitting a fixed batch: 30 steps at lr 3e-4, the same noise every step
    init_random_(model, seed)
    calm_scale_head_(model)
    fit = ts.TrainState(0, model, ts.make_optimizer(base_lr=3e-4, max_iters=10_000, warmup_iters=1).init(
        model.parameters()))
    w0 = vit.blocks[0].attn.qkv.weight.detach().clone()
    s0 = model.flow_decoder.proj_bn[2].running_var.clone()
    history = []
    t0 = time.perf_counter()
    for _ in range(30):
        losses = ts.train_step(fit, batch, torch.Generator(device=dev).manual_seed(noise_seed))
        history.append(float(losses["loss"]))
    fit_s = time.perf_counter() - t0
    print(f"[train] 30 steps at lr 3e-4 on one batch ({fit_s!r} s): loss {history!r}")
    check(all(np.isfinite(history)), "every loss finite")
    check(history[-1] < 0.9 * history[0], "the loss falls below 0.9 x its first value within 30 steps")
    check(fit.step == 30 and fit.optimizer.updates == int(fit.optimizer.count) == 30, "step counts 30 updates")
    check(not torch.equal(w0, vit.blocks[0].attn.qkv.weight) and not torch.equal(s0, model.flow_decoder.proj_bn[2]
          .running_var), "parameters and BatchNorm statistics changed")

    # 7. times: ms per step, split into forward, backward and update, and by layer
    steps = host_ms(lambda: ts.train_step(fit, batch, noise), 11)[1:]
    med = float(np.median(steps))
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = ts.forward_train(model, batch, noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses["loss"].backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fit.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, a, b in (("forward", t0, t1), ("backward", t1, t2), ("optimizer", t2, t3)):
            parts[k].append((b - a) * 1e3)
    layers = {}

    def timed_call(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            layers.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    with patched((ts, "sample_keypoints", timed_call("GT keypoints", ts.sample_keypoints)),
                 (model, "features", timed_call("ViT features (2 calls)", model.features)),
                 (model, "stage2", timed_call("stage 2", model.stage2)),
                 (model, "stage3", timed_call("stage 3 (DPT x 2 + flow decoder)", model.stage3))):
        for _ in range(3):
            layers.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts.forward_train(model, batch, noise)["loss"].backward()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            model.zero_grad(set_to_none=True)
    vit.remat = True
    remat_ms = float(np.median(host_ms(lambda: ts.train_step(fit, batch, noise), 6)[1:]))
    vit.remat = False
    print(f"[train] ms per step (median of 10 after a warm-up) {med!r} = {B / med * 1e3!r} samples/s; all "
          f"{steps!r}; with remat (median of 5) {remat_ms!r}")
    print("[train] forward / backward / optimizer ms, median of 5: "
          + ", ".join(f"{k} {float(np.median(v))!r}" for k, v in parts.items()))
    print(f"[train] forward by layer ms (synchronised around each, last of 3; forward + backward {total!r}): "
          + ", ".join(f"{k} {sum(v)!r}" for k, v in layers.items()))
    print("[profile] one training step:")
    busy, conv, events = profile_batch(lambda: ts.train_step(fit, batch, noise), top=16)
    print(f"[train] device busy {busy!r} ms of the {med!r} ms median step: idle share {1 - busy / med!r}; "
          f"convolutions {conv!r} ms")
    for name, match in (("K1", lambda k: "layernorm" in k), ("K2", lambda k: "attention_hopper" in k),
                        ("K4", lambda k: re.search(KERNEL_SYMBOLS["corr_window"], k)),
                        ("K5", lambda k: "warp_kernel" in k)):
        ms, n = count_kernels(events, match)
        print(f"[train] {name} in the profiled step: {ms!r} ms over {n} launches")
    del fit, state, model
    torch.cuda.empty_cache()

    # 8. the compiled step against the eager one
    t0 = time.perf_counter()
    launches = compiled_step_phase(seed, batch, noise_seed, model_kw)
    print(f"[train] compiled-step checks {time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()
    return {"match_scores": 0, "match_scores_int8": 0, **launches}, med


MP_FRAMES, MP_HW, MP_OBJECTS = 48, (480, 640), (1, 2)
MP_K = np.array([[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]])
SPHERE_RADIUS = 0.1  # meters
LOOP_STEPS = 12  # the in-process loop: 1 warm-up step, 10 profiled, 1 more
LOOP_PROFILED = range(1, 11)


def megapose_world(root: str, seed: int) -> dict:
    """A MegaPose-GSO tree under ``root`` in the layout
    picopose_tpu/data/megapose.py reads, written with this script's PNG
    encoder and data/jpeg.py::encode_jpeg: MP_FRAMES 640 x 480 JPEG frames
    (q95, 4:2:0, libjpeg's encoder at PIL's defaults) of one or two
    textured spheres (objects 1 and 2; object 2 with its colour channels
    reversed) in front of a procedural background, each with 16-bit depth
    (mm), mask_visib RLEs, gt, gt_info and camera JSON; and per object a
    level-1 bank of 162 RGBA views and depth PNGs at 640 x 480 with
    TEMPLATES_K and object_poses from the port's geom/templates.py, at the
    GSO x10 scale (picopose_tpu/data/megapose.py:245-247).  Returns the
    root and, for a few frames, the pixels that were encoded."""
    from picopose_tpu_torch.data.bop import TEMPLATES_K
    from picopose_tpu_torch.data.jpeg import encode_jpeg
    from picopose_tpu_torch.data.synthetic import _texture, render_sphere
    from picopose_tpu_torch.geom.templates import template_object_poses

    rng = np.random.default_rng(seed)
    web = os.path.join(root, "MegaPose-GSO", "train_pbr_web")
    shard = os.path.join(web, "shard-000000")
    os.makedirs(shard)
    H, W = MP_HW
    yy, xx = np.mgrid[:H, :W]
    keys, encoded = {}, {}
    for i in range(MP_FRAMES):
        n = 1 + int(rng.random() < 0.5)
        objs = [int(o) for o in rng.choice(MP_OBJECTS, n, replace=False)]
        background = np.stack([70 + 40 * np.sin(xx / (19 + 4 * c) + i) * np.cos(yy / (23 - 3 * c))
                               for c in range(3)], -1) / 255.0
        depth, rgb, renders = np.full((H, W), np.inf), background, []
        for j, obj in enumerate(objs):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            pose = np.eye(4)
            pose[:3, :3] = q * np.sign(np.linalg.det(q))
            pose[:3, 3] = [(-0.12 if j == 0 else 0.12) * (n - 1) + rng.uniform(-0.05, 0.05),
                           rng.uniform(-0.06, 0.06), rng.uniform(0.45, 0.8)]
            col, d, m = render_sphere(MP_K, pose, SPHERE_RADIUS, MP_HW)
            col = col if obj == 1 else col[..., ::-1]
            front = (m > 0) & (d < depth)
            depth, rgb = np.where(front, d, depth), np.where(front[..., None], col, rgb)
            renders.append((obj, pose, d, m))
        depth = np.where(np.isinf(depth), 0.0, depth)
        rgb8 = (rgb * 255).astype(np.uint8)
        key = f"{i:08d}"
        keys[key] = 0
        base = os.path.join(shard, key)
        with open(base + ".rgb.jpg", "wb") as f:
            f.write(encode_jpeg(rgb8, 95))
        if i < 8:
            encoded[base + ".rgb.jpg"] = rgb8
        with open(base + ".depth.png", "wb") as f:
            f.write(png_bytes(np.round(depth * 1000.0).astype(np.uint16)))
        masks, gt, gt_info = {}, [], []
        for j, (obj, pose, d, m) in enumerate(renders):
            vis = ((m > 0) & (d <= depth)).astype(np.uint8)
            masks[str(j)] = rle_string(vis)
            gt.append({"obj_id": obj, "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                       "cam_t_m2c": (pose[:3, 3] * 1000.0).tolist()})
            gt_info.append({"px_count_valid": int(vis.sum()), "visib_fract": float(vis.sum() / max(m.sum(), 1))})
        for name, obj in (("mask_visib", masks), ("gt", gt), ("gt_info", gt_info),
                          ("camera", {"cam_K": MP_K.reshape(-1).tolist(), "depth_scale": 1.0})):
            with open(f"{base}.{name}.json", "w") as f:
                json.dump(obj, f)
    with open(os.path.join(web, "key_to_shard.json"), "w") as f:
        json.dump(keys, f)

    # every template view sees its sphere 1 m ahead at the same place: one
    # hit map, textured per view
    tdir = os.path.join(root, "MegaPose-Templates", "GSO")
    os.makedirs(os.path.join(tdir, "object_poses"))
    table = template_object_poses(1)  # mm
    first = table[0].copy()
    first[:3, 3] /= 1000.0
    K = TEMPLATES_K.astype(np.float64)
    _, tdepth, tmask = render_sphere(K, first, SPHERE_RADIUS, MP_HW)
    ys, xs = np.nonzero(tmask)
    p_cam = (np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1) @ np.linalg.inv(K).T) * tdepth[ys, xs, None]
    depth_png = png_bytes(np.round(tdepth * 10000.0).astype(np.uint16))  # mm x 10
    for obj in MP_OBJECTS:
        odir = os.path.join(tdir, f"{obj:06d}")
        os.makedirs(odir)
        np.save(os.path.join(tdir, "object_poses", f"{obj:06d}.npy"), table * np.array([1, 1, 1, 10.0]))
        for v, pose in enumerate(table):
            tex = _texture((p_cam - pose[:3, 3] / 1000.0) @ pose[:3, :3], SPHERE_RADIUS)
            rgba = np.zeros((H, W, 4), np.uint8)
            rgba[ys, xs, :3] = ((tex if obj == 1 else tex[..., ::-1]) * 255).astype(np.uint8)
            rgba[ys, xs, 3] = 255
            with open(os.path.join(odir, f"{v:06d}.png"), "wb") as f:
                f.write(png_bytes(rgba))
            with open(os.path.join(odir, f"{v:06d}_depth.png"), "wb") as f:
                f.write(depth_png)
    return {"root": root, "encoded": encoded}


def loop_log(log_dir: str) -> tuple[list[str], list[float]]:
    """The training log's line heads ("iter 5", "epoch 0 done at iter 10")
    and every loss value it holds."""
    heads, losses = [], []
    with open(os.path.join(log_dir, "training_logger.log")) as f:
        for line in f:
            body = line.split("] ", 1)[1].rstrip("\n")
            heads.append(body.split(" |")[0])
            losses += [float(t.split(": ")[1]) for t in body.split(" | ")[-1].split(", ")]
    return heads, losses


def in_fresh_interpreter(call: str, tag: str, timeout: int = 900) -> dict:
    """``chip_smoke.<call>`` in a new Python process (one that has never
    run torch.profiler): its JSON result; its ``[profile]`` lines are
    printed after ``tag``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here}
    code = f"import json, chip_smoke; print('FRESH_RESULT', json.dumps(chip_smoke.{call}))"
    r = subprocess.run([sys.executable, "-c", code], cwd=here, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-3000:], r.stderr[-6000:], file=sys.stderr)
    check(r.returncode == 0, f"{call.split('(')[0]} in a fresh interpreter exits 0")
    for line in r.stdout.split("FRESH_RESULT ", 1)[0].splitlines():
        if line.startswith("[profile]"):
            print(f"{tag} fresh interpreter {line}")
    return json.loads(r.stdout.split("FRESH_RESULT ", 1)[1].splitlines()[0])


def loop_phase(seed: int, step_ms_alone: float) -> dict:
    """Phase 9: the training loop at full ViT-L width on a MegaPose tree
    (``megapose_world``) with configs/base.yaml (bf16, batch 8, AdamW,
    WarmupCosineLR, colour augmentation on, worker processes): the JPEG
    decoder on the script's frames; the loader alone; ``run_training`` in
    this process for LOOP_STEPS
    steps with each step's launches and a profile of ten steps, the
    checkpoint's save and restore; one loop batch's step through the
    kernels against the plain path; then
    ``python -m picopose_tpu_torch.run_train`` for one epoch of 4 steps
    and ``--resume`` for one more.  Everything is written to a temporary
    directory in the checkout, removed at the end (at most two train-state
    files, ~4.5 GB each, exist at a time).  Returns the kernels' launches
    per loop step."""
    import shutil
    import tempfile

    from picopose_tpu_torch import kernels, native
    from picopose_tpu_torch.data.jpeg import read_jpeg
    from picopose_tpu_torch.data.megapose import MegaPoseTrainingDataset
    from picopose_tpu_torch.train import loop
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.train.augment import draw_affine_noise
    from picopose_tpu_torch.utils import checkpoint as ckpt
    from picopose_tpu_torch.utils.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, "configs", "base.yaml")
    tmp = tempfile.mkdtemp(prefix="loop_phase_", dir=here)
    try:
        t0 = time.perf_counter()
        world = megapose_world(os.path.join(tmp, "mp"), seed)
        data = world["root"]
        print(f"[loop] MegaPose tree ({MP_FRAMES} JPEG frames, 2 x 162 template views) written in "
              f"{time.perf_counter() - t0!r} s; os.cpu_count() {os.cpu_count()}")

        # the decoder on the frames written by the package's encoder
        ms, psnr = [], []
        for path, pixels in world["encoded"].items():
            t0 = time.perf_counter()
            got = read_jpeg(path)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(got.shape == pixels.shape and got.dtype == np.uint8, "read_jpeg: a 480 x 640 RGB uint8 frame")
            psnr.append(10 * np.log10(255.0**2 / np.mean((got.astype(np.float64) - pixels) ** 2)))
        print(f"[loop] JPEG decode ms per 640 x 480 q95 4:2:0 frame: median {float(np.median(ms))!r}, all {ms!r}; "
              f"PSNR against the encoded pixels dB {psnr!r}")
        check(min(psnr) > 35.0, "read_jpeg of encode_jpeg's frames within 35 dB PSNR of the encoded pixels")

        overrides = [f"train_dataset.data_dir={data}", "train_dataloader.backend=procs"]
        cfg = load_config(config, overrides + ["trainer.training_epoch=1", f"lr_scheduler.max_iters={LOOP_STEPS}",
                                               "trainer.iters_to_print=6"])
        bs, workers = cfg.train_dataloader.bs, cfg.train_dataloader.num_workers
        check(bs == 8 and cfg.model.vit_type == "dinov2_vitl14" and cfg.model.compute_dtype == "bfloat16"
              and cfg.train_dataset.augment_real and cfg.optimizer.type == "AdamW", "base.yaml's training setup")

        # the loader alone: pool start-up, then batches/s
        d = cfg.train_dataset
        ds_kwargs = dict(data_dir=d.data_dir, img_size=d.img_size, min_visib_fract=d.min_visib_fract,
                         min_px_count_visib=d.min_px_count_visib, augment_real=d.augment_real,
                         rgb_mask_flag=d.rgb_mask_flag)
        n_batches = workers + 4  # the first wave and four more (was 2 x workers + 4)
        t0 = time.perf_counter()
        batches = loop.mp_prefetch_batches(ds_kwargs, bs, steps=n_batches, workers=workers, seed=seed)
        first = next(batches)
        startup = time.perf_counter() - t0
        t0 = time.perf_counter()
        rest = sum(1 for _ in batches)
        rate = rest / (time.perf_counter() - t0)
        check(rest == n_batches - 1 and first["real_rgb"].shape == (bs, 224, 224, 3), "the loader's batches")
        print(f"[loop] loader alone ({workers} worker processes, batch {bs}): pool start-up and first batch "
              f"{startup!r} s, then {rate!r} batches/s = {rate * bs!r} samples/s over {rest} batches")
        # the workers count their host library calls in their own processes: count a few samples here
        sample_ds = MegaPoseTrainingDataset(seed=seed, **ds_kwargs)
        native.reset_calls()
        t0 = time.perf_counter()
        got = [sample_ds.get(i) for i in range(8)]
        sample_s = time.perf_counter() - t0
        n_ok = sum(g is not None for g in got)
        calls = dict(native.CALLS)
        print(f"[loop] 8 samples in this process in {sample_s!r} s ({n_ok} valid): host library calls {calls!r}")
        check(n_ok > 0 and calls.get("crop_resize_normalize", 0) >= n_ok,
              "each valid sample's rgb crops went through the C++ fast path (templates cached after their first)")

        print(f"[loop] phase 8's eager step alone in this process, after it has profiled: {step_ms_alone!r} ms = "
              f"{bs / step_ms_alone * 1e3!r} samples/s")

        # run_training in this process, each step instrumented
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        real_make, real_save = loop.make_train_step, ckpt.save
        rec = {"launches": [], "saves": [], "state": None, "batch": None, "graphs": None}
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def make(state):
            real_step = real_make(state)

            def step(state, batch, noise):
                i = len(rec["launches"])
                if i == LOOP_PROFILED.start:
                    prof.start()
                kernels.reset_launches()
                losses = real_step(state, batch, noise)
                rec["launches"].append(dict(kernels.LAUNCHES))
                if i == LOOP_PROFILED.stop - 1:
                    torch.cuda.synchronize()
                    prof.stop()
                if i == 3:
                    rec["batch"] = {k: torch.as_tensor(v).clone() for k, v in batch.items()}
                rec["state"] = state
                return losses

            step.graphs = rec["graphs"] = real_step.graphs
            return step

        def save(log_dir, step_, state, epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = real_save(log_dir, step_, state, epoch)
            rec["saves"].append((time.perf_counter() - t0, os.path.getsize(path), path))
            return path

        log_dir = os.path.join(tmp, "log_in_process")
        t0 = time.perf_counter()
        with patched((loop, "make_train_step", make), (loop.ckpt, "save", save)):
            loop.run_training(cfg, log_dir, max_steps=LOOP_STEPS)
        run_s = time.perf_counter() - t0
        want = TRAIN_FORWARD
        graphs = rec["graphs"]
        traced = traced_launches(prof.key_averages())
        per_step = {k: v / len(LOOP_PROFILED) for k, v in traced.items()}
        print(f"[loop] the compiled step: {dict(graphs.captures)} programs captured in {dict(graphs.capture_s)} s, "
              f"{dict(graphs.replays)} replays; the wrappers' launches of the first step (its warm-up) "
              f"{rec['launches'][0]}, of the others {rec['launches'][1:]}; the profiled steps' trace "
              f"{traced} = {per_step} per step")
        check(len(rec["launches"]) == LOOP_STEPS and rec["launches"][0] == want and not any(rec["launches"][1:]),
              "run_training's first step captured the step (its warm-up counted), the others replayed")
        check(graphs.captures["train_step"] == 1 and graphs.replays["train_step"] == LOOP_STEPS,
              "run_training replayed one compiled program at every step")
        check(per_step == want, "every profiled loop step ran K1 (96), K2 (48), K4 (3) and K5 (3)")
        heads, losses = loop_log(log_dir)
        check(heads == [f"iter {k}" for k in range(6, LOOP_STEPS + 1, 6)] + [f"epoch 0 done at iter {LOOP_STEPS}"]
              and all(np.isfinite(losses)), "the in-process run's log: iteration lines, the epoch line, finite losses")
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                  and not getattr(e, "is_user_annotation", False)]
        busy = sum(dev_us(e) for e in events) / 1e3 / len(LOOP_PROFILED)
        print(f"[loop] device busy {busy!r} ms per step over {len(LOOP_PROFILED)} profiled loop steps; the run "
              f"{run_s!r} s")
        for e in sorted(events, key=dev_us, reverse=True)[:8]:
            print(f"[profile] {dev_us(e) / 1e3 / len(LOOP_PROFILED)!r} ms per step x{e.count} {e.key[:100]}")
        save_s, nbytes, path = rec["saves"][-1]
        check(len(rec["saves"]) == 1 and path.endswith(f"{LOOP_STEPS}.pt"), "the run saved once, at its last step")
        state = rec["state"]
        before = {k: v.clone() for k, v in list(state.model.state_dict().items())[:8]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(log_dir, None, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(state.step == LOOP_STEPS and all(torch.equal(v, state.model.state_dict()[k]) for k, v in before.items()),
              "the restored state is the saved one")
        print(f"[loop] checkpoint {nbytes} bytes, save {save_s!r} s, restore {restore_s!r} s")
        shutil.rmtree(log_dir)
        batch = rec["batch"]
        del rec, state, before

        # one loop batch's step, kernel path against plain path
        tx = ts.make_optimizer()
        model_kw = dict(vit_type="dinov2_vitl14", blocks_to_take=(5, 11, 17, 23), compute_dtype=torch.bfloat16)
        noise = draw_affine_noise(bs, torch.Generator(device="cuda").manual_seed(seed + 9))
        step_kernel_vs_plain(ts.init_state(tx, seed, **model_kw), ts.init_state(tx, seed, **model_kw), batch,
                             noise, want, "[loop]")
        del batch
        torch.cuda.empty_cache()

        # the CLI: one epoch of 4 steps, then --resume for one more (two loader
        # workers: the CLI runs check checkpoints and resume, the loader's
        # rate is timed above)
        env = {**os.environ, "PYTHONPATH": here}
        args = ["--config", config, "--version_id", "9", "--set", *overrides, "trainer.training_epoch=3", "lr_scheduler.max_iters=12",
                "trainer.iters_to_print=2", "trainer.ckpt_every_epochs=1", "train_dataloader.num_workers=2"]
        log_dir = os.path.join(tmp, "log", "picopose", "version_9")
        runs = {}
        for name, extra in (("first", ["--max_steps", "4"]), ("resumed", ["--max_steps", "8", "--resume"])):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "picopose_tpu_torch.run_train", *extra, *args], cwd=tmp, env=env,
                               capture_output=True, text=True, timeout=600)
            runs[name] = time.perf_counter() - t0
            if r.returncode != 0:
                print(r.stdout[-3000:], r.stderr[-6000:], file=sys.stderr)
            check(r.returncode == 0, f"run_train ({name} run) exits 0")
            compiled = [line for line in r.stdout.splitlines() if line.startswith("compiled train step:")]
            print(f"[loop] run_train ({name} run): {compiled}")
            check(len(compiled) == 1 and " of 1 captured programs" in compiled[0],
                  f"run_train ({name} run) went through the compiled step")
            saved = sorted(os.listdir(os.path.join(log_dir, "checkpoints")), key=lambda n: int(n[:-3]))
            if name == "first":
                check(saved == ["4.pt"], f"a checkpoint at step 4, the epoch's end ({saved})")
            else:
                check("resumed from step 4" in r.stdout, "the resumed run starts at step 4")
                check(saved == ["4.pt", "8.pt"], f"the resumed run saved at step 8 ({saved})")
        heads, losses = loop_log(log_dir)
        print(f"[loop] run_train: one epoch of 4 steps in {runs['first']!r} s, --resume to step 8 in "
              f"{runs['resumed']!r} s; log {heads!r}; losses finite {bool(np.isfinite(losses).all())}")
        check(heads == ["iter 2", "iter 4", "epoch 0 done at iter 4", "iter 6", "iter 8", "epoch 0 done at iter 8"],
              "the log's iteration and epoch lines (the resumed run's epoch counter restarts at 0)")
        check(len(losses) > 0 and all(np.isfinite(losses)), "every logged loss finite")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"match_scores": 0, "match_scores_int8": 0, **{k: int(v) for k, v in per_step.items()}}


def graph_outputs_equal(tag: str, got, ref) -> dict:
    """A graphed run_batch against the eager one: template ids, ranking
    order, PnP success, inlier ratios and scores bitwise; R and t within
    GRAPH_POSE_TOL (whether they came out bitwise is printed)."""
    (out, ids, order), (rout, rids, rorder) = got, ref
    check(torch.equal(ids, rids), f"{tag}: template ids bitwise")
    check(torch.equal(order, rorder), f"{tag}: ranking order bitwise")
    check(torch.equal(out.pnp_success, rout.pnp_success), f"{tag}: PnP success bitwise")
    check(torch.equal(out.inlier_ratio, rout.inlier_ratio) and torch.equal(out.template_score, rout.template_score),
          f"{tag}: inlier ratios and template scores bitwise")
    err = max((out.R - rout.R).abs().max().item(), (out.t - rout.t).abs().max().item())
    bitwise = torch.equal(out.R, rout.R) and torch.equal(out.t, rout.t)
    print(f"[graphs] {tag}: ids, order, success, ratios, scores bitwise; R and t max abs diff {err!r} "
          f"(bitwise {bitwise})")
    check(err <= GRAPH_POSE_TOL, f"{tag}: R and t within {GRAPH_POSE_TOL}")
    return {"err": err, "bitwise": bitwise}


# R and t of a replay against the eager call: fp32 PnP on the same
# correspondences and draws; a replay runs the same kernels in the same
# order, so any difference is a fault (it came out bitwise on the card)
GRAPH_POSE_TOL = 1e-5


def graph_phase(seed: int, world: dict) -> dict:
    """Phase 10: the compiled inference programs at full ViT-L width, on
    phase 5's estimator (phase 3's seeded weights, precast), its 162-view
    bank and 16 host crops of its frame.  ``run_batch_graphed`` against
    the eager ``run_batch`` from equal generator states, for the default
    path and each serving mode (PICOPOSE_MATCH_INT8=1, PICOPOSE_MATCH_FP32=1,
    quantize_stage3): the capturing call and a replay, each against an
    eager call; the generators' states equal after; the wrappers' launches
    (set to 0 just before, read just after: the capturing call's warm-up,
    nothing on a replay) and the kernels in a profiler trace of one
    replay (taken again, up to three times, on another replay where the
    trace lost events).  Two calls queued with
    different crops before either is read.  A second bank of the same
    shape (``build_bank_graphed``, bitwise the eager bank) swapped in and
    out of the program's slot.  Returns the kernels' executions per
    replayed run_batch, counted in the trace."""
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.eval import pipeline as P
    from picopose_tpu_torch.utils.graphs import GraphCache

    est, bank, frame, K, dets = (world[k] for k in ("est", "bank", "frame", "K", "dets"))
    model = est.model
    batches = [est._host_batch(frame, K, dets[s : s + 16], 0) for s in (0, 2)]
    graphs = GraphCache("cuda")
    replay_launches, errs, traced_replays = {}, {}, 0

    def graphed(batch, bank, gen):
        return P._ranked_graphed(graphs, model, batch, bank, est.hyp, est.pnp_iters, None, gen)

    def eager(batch, bank, gen):
        return P._ranked(model, batch, bank, est.hyp, est.pnp_iters, None, gen, None)

    def pair(tag: str, batch, bank, gens) -> dict:
        """A graphed call against an eager one; the wrappers' launches
        during the graphed call (counts set to 0 just before)."""
        kernels.reset_launches()
        got = graphed(batch, bank, gens[0])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ref = eager(batch, bank, gens[1])
        torch.cuda.synchronize()
        errs[tag] = graph_outputs_equal(tag, got, ref)
        check(torch.equal(gens[0].get_state(), gens[1].get_state()), f"{tag}: the generators advanced alike")
        return launches

    modes = (("default", None, "match_scores"), ("PICOPOSE_MATCH_INT8=1", "PICOPOSE_MATCH_INT8", "match_scores_int8"),
             ("PICOPOSE_MATCH_FP32=1", "PICOPOSE_MATCH_FP32", "match_scores"),
             ("quantize_stage3", "quantize", "match_scores"))
    for tag, switch, k3 in modes:
        if switch and switch.startswith("PICOPOSE"):
            os.environ[switch] = "1"
        model.flow_decoder.quantize = switch == "quantize"
        try:
            gens = [torch.Generator(device="cuda").manual_seed(seed) for _ in range(2)]
            warm = pair(f"{tag}, capturing call", batches[0], bank, gens)
            check(warm == run_batch_launches(1, k3), f"{tag}: the capturing call's wrappers launch its warm-up")
            want = run_batch_launches(1, k3)
            for attempt in range(3):  # a trace that lost events is taken again, on another replay
                kernels.reset_launches()
                got, traced = trace_launches(lambda: graphed(batches[0], bank, gens[0]))
                launches = dict(kernels.LAUNCHES)
                ref = eager(batches[0], bank, gens[1])
                traced_replays += 1
                errs[f"{tag}, replay"] = graph_outputs_equal(f"{tag}, replay", got, ref)
                print(f"[graphs] {tag}: one replay: launches by the wrappers {launches}, in the trace {traced}")
                check(not launches, f"{tag}: no wrapper runs on a replay")
                if not lost_events(traced, want):
                    break
                print(f"[graphs] {tag}: the trace lost events ({traced} of {want}); tracing another replay")
            check(traced == want, f"{tag}: the trace of one replay holds one run_batch's kernels")
            replay_launches.update(traced)
        finally:
            os.environ.pop("PICOPOSE_MATCH_INT8", None)
            os.environ.pop("PICOPOSE_MATCH_FP32", None)
            model.flow_decoder.quantize = False
    check(graphs.captures["run_batch"] == 4 and graphs.replays["run_batch"] == 4 + traced_replays,
          "one program per serving mode, captured once, replayed at its capture and at each traced call")
    print(f"[graphs] capture s per run_batch program (default, int8, fp32, quantize_stage3): "
          f"{graphs.capture_s['run_batch']!r}")

    # two calls queued before either is read
    gens = [torch.Generator(device="cuda").manual_seed(seed + 1) for _ in range(2)]
    got = [graphed(b, bank, gens[0]) for b in batches]
    ref = [eager(b, bank, gens[1]) for b in batches]
    torch.cuda.synchronize()
    for i in range(2):
        errs[f"queued call {i}"] = graph_outputs_equal(f"queued call {i}", got[i], ref[i])
    check(not torch.equal(got[0][1], got[1][1]), "the two queued calls matched other templates")

    # a second bank of the same shape: the views in another order, swapped in and out of the slot
    perm = torch.randperm(162, generator=torch.Generator().manual_seed(seed)).to("cuda")
    other = [torch.as_tensor(a, device="cuda")[perm] for a in world["bank_np"]]
    t0 = time.perf_counter()
    bank2 = P.build_bank_graphed(graphs, model, *other, chunk=32)
    torch.cuda.synchronize()
    ref2 = P.build_bank(model, *other, chunk=32)
    check(all(torch.equal(a, b) for a, b in zip(bank2.feats + bank2.dpt + bank2[1:6], ref2.feats + ref2.dpt + ref2[1:6])),
          "build_bank_graphed gives the eager bank bitwise")
    print(f"[graphs] build_bank_graphed (its first call: two chunk programs captured, "
          f"{graphs.capture_s['bank_chunk']!r} s) {time.perf_counter() - t0!r} s; bitwise the eager bank")
    del ref2
    gens = [torch.Generator(device="cuda").manual_seed(seed + 2) for _ in range(2)]
    for i, b in enumerate((bank2, bank, bank2)):
        pair(f"bank swap {i}", batches[0], b, gens)
    check(len(graphs._slots) == 1, "both banks share one slot")
    del bank2, graphs

    return replay_launches


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
    # the scale head calmed too: a seeded random one predicts 2D scales
    # down to 0.002, where the stage-2 depth (template depth / scale) turns
    # the card's last-bit differences into 2e-5 of the pose
    for dtype, tol, tol3 in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, 3e-2, 3e-2)):
        cpu = PicoPose("vit_tiny_test", (0, 1, 2, 3), dtype, device="cpu")
        init_random_(cpu, seed)
        calm_stage3_heads_(cpu)
        calm_scale_head_(cpu)
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


# ---------------------------------------------------------------- phase 13: ranks and devices

RANKS_B = 8  # the global batch of phase 13's training steps
RANKS_STEPS = 2
RANKS_LR = 1e-4  # base.yaml's AdamW at a constant lr (no warm-up), so that two steps move the parameters
RANKS_MODES = ("ddp", "fsdp")  # phase 13a, one rank
# phase 13a-b run ViT-L's width at half its depth: the checks are of the
# collectives and the layouts, which the block count leaves as they are,
# and the blocks' bytes set the phase's time
RANKS_DEPTH, RANKS_TAPS = 12, (2, 5, 8, 11)
RANKS_FORWARD = {"layernorm": 4 * RANKS_DEPTH, "attention": 2 * RANKS_DEPTH, "corr_window": 3, "warp": 3}
# phase 13b over two ranks: (compute dtype, mode, n_data, n_model)
RANKS_RUNS = ((torch.float32, "ddp", 2, 1), (torch.float32, "fsdp", 2, 1), (torch.float32, "tp", 1, 2),
              (torch.bfloat16, "ddp", 2, 1))
# Limits of phase 13b's runs against the one-process step at the global batch, by compute dtype: each
# step's losses (relative; the first step's come before any update), the first step's gradient (as
# AdamW's first moment after it, relative RMS), the change of the parameters after the two updates
# (relative RMS per group) and each parameter (in lr: an update moves a parameter by about lr whatever its
# gradient, so this bound catches a misplaced shard, the RMS bounds a wrong gradient or a missed update).
# With base.yaml's betas (0.5, 0.999) the first update moves a parameter by at most lr and the second by
# at most 1.054 lr, so two correct runs differ by at most 4.11 lr: an element whose gradient is near 0
# takes the sign of the sums' rounding in each run and each step.  fp32: only the order of the fp32 sums
# differs; the gradient is held to the CPU tests' 1e-3.  bf16: the
# forward matches as in fp32 (the ViT's rows come out bitwise at 4 rows and at 8, ``shape_witness``), but
# each rank rounds its weight gradients to bf16 before the ranks' fp32 sum, where one process rounds the
# whole batch's once; AdamW's first update, about lr times the gradient's sign, turns each element whose
# sign that flips into 2 lr, and the second step computes from those parameters.  Past the first step's
# losses the bf16 limits are set from the readings on an NVIDIA H100 80GB HBM3, 700 W (gradient 4.2e-3
# with 0.40% of its elements of the other sign; step 2 losses 6.4e-3; the ViT's change 6.1e-2; 4.03 lr;
# fp32: 5.6e-5 to 1.2e-4, 2.0e-5 to 3.4e-5, 2.2e-3 to 3.5e-3, 2.05 to 2.29 lr; PERF.md).  At the JAX
# package's from-scratch draws (init_random_) fp32 tp's first-step gradient is closer to one process's
# (5.5e-5) but has 0.042% of its elements of the other sign (0.017% before): its second step's losses
# read 2.3e-4, its ViT's change 1.1e-2 and its parameters 3.70 lr (ddp 3.18 lr), so the fp32 limits past
# the first step are the second step's loss 1e-3, the change 3e-2 and each parameter 4.5 lr, as bf16's.
RANKS_LIMITS = {torch.float32: dict(loss=(1e-4, 1e-3), grad_rms=1e-3, state_rms=3e-2, param_lr=4.5),
                torch.bfloat16: dict(loss=(1e-4, 1e-2), grad_rms=1e-2, state_rms=0.1, param_lr=4.5)}


def ranks_vit() -> str:
    """ViT-L's width at RANKS_DEPTH blocks, registered under its own name
    in the package's table of this process (each rank's process calls
    this through ``_ranks_inputs``)."""
    from dataclasses import replace

    from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS

    name = f"dinov2_vitl14_depth{RANKS_DEPTH}"
    VIT_CONFIGS.setdefault(name, replace(VIT_CONFIGS["dinov2_vitl14"], depth=RANKS_DEPTH))
    return name


def _ranks_inputs(seed: int, dtype: torch.dtype = torch.bfloat16):
    """Phase 13's global batch of 8 sphere pairs on the card, the affine
    noise of each step (the global batch's draws), the model's arguments
    (``ranks_vit`` at ``dtype``) and base.yaml's AdamW at RANKS_LR."""
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.train.augment import draw_affine_noise

    dev = torch.device("cuda", 0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(RANKS_B, seed).items()}
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    noises = [draw_affine_noise(RANKS_B, g) for _ in range(RANKS_STEPS)]
    model_kw = dict(vit_type=ranks_vit(), blocks_to_take=RANKS_TAPS, compute_dtype=dtype)
    return batch, noises, model_kw, ts.make_optimizer(base_lr=RANKS_LR, warmup_factor=1.0)


def _ranks_state(seed: int, model_kw: dict, tx):
    from picopose_tpu_torch.train import step as ts

    state = ts.init_state(tx, seed, device="cuda:0", **model_kw)
    calm_scale_head_(state.model)
    return state


def _whole_state(state) -> dict:
    """Parameters, BatchNorm statistics and AdamW moments of a state
    (sharded or not), whole, as copies (a collective when sharded)."""
    from picopose_tpu_torch.parallel.shardings import full_optimizer_state, full_state_dict

    out = {f"model.{k}": v.detach().clone() for k, v in full_state_dict(state).items()}
    for i, m in full_optimizer_state(state)["optimizer"]["state"].items():
        out.update({f"{k}.{i}": v.detach().clone() for k, v in m.items()})
    return out


def shape_witness(model, batch: dict) -> dict:
    """What the row count of two data ranks changes in the forward, on one
    device and with no collective: the ViT's four taps of rows 0-3 run as
    a batch of 4 against the same rows of the batch of 8 (relative RMS,
    and the share of elements that differ)."""
    with torch.no_grad():
        whole = model.features(batch["real_rgb"])
        half = model.features(batch["real_rgb"][:4])
    d = [(h.double() - w[:4].double()) for h, w in zip(half, whole)]
    rms = (sum(float((x * x).sum()) for x in d) / sum(float((w[:4].double() ** 2).sum()) for w in whole)) ** 0.5
    share = sum(int((x != 0).sum()) for x in d) / sum(x.numel() for x in d)
    return {"vit_rows_rel_rms": rms, "vit_rows_share_differing": share}


def first_moments(state) -> dict:
    """AdamW's first moments of a state (sharded or not), whole: after the
    first update, (1 - b1) times the first step's gradient."""
    from picopose_tpu_torch.parallel.shardings import full_optimizer_state

    return {i: m["exp_avg"] for i, m in full_optimizer_state(state)["optimizer"]["state"].items()}


def nccl_one_rank(seed: int, port: int, out: str) -> dict:
    """Phase 13a, in its own process: a one-rank NCCL group on cuda:0.  For
    ddp and fsdp, ``make_train_step(state, shardings, mesh)`` captured at
    its first call and replayed at its second, against the eager sharded
    step (its program called directly) and against the one-device eager
    ``train_step``, from equal states, on the same batch and noise: losses,
    parameters, statistics and moments bitwise after each step; the
    collectives the capturing call issued (warm-up and capture) and none
    on the replay; the kernels of one replay in a profiler trace (NCCL's
    and copies by name, the wrappers' by kernel); ms per replay; the bytes
    the rank holds.  Writes the one-device references at fp32 and bf16
    (losses, the first moments after the first step, parameters and
    statistics after the last) to ``out`` for phase 13b, and measures
    ``shape_witness`` on their fresh models."""
    from torch.profiler import ProfilerActivity, profile

    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.parallel import collectives as C
    from picopose_tpu_torch.parallel import distributed as pd
    from picopose_tpu_torch.parallel import make_mesh, shard_state, state_shardings
    from picopose_tpu_torch.train import step as ts

    kernels.build()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pd.initialize(backend="nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0, device_id=dev)
    res: dict = {"modes": {}, "witness": {}}
    try:
        mesh = make_mesh(device=dev)
        for dtype in (torch.float32, torch.bfloat16):  # phase 13b's one-device references, then 13a's
            batch, noises, model_kw, tx = _ranks_inputs(seed, dtype)
            one = _ranks_state(seed, model_kw, tx)
            res["witness"][str(dtype)[6:]] = shape_witness(one.model, batch)
            ref_losses, ref_states, m1 = [], [], None
            for n in noises:
                ref_losses.append(ts.train_step(one, batch, n))
                ref_states.append(_whole_state(one))
                if m1 is None:
                    m1 = {i: m.cpu() for i, m in first_moments(one).items()}
            torch.save({"losses": [{k: float(v) for k, v in l.items()} for l in ref_losses], "m1": m1,
                        "state": {k[6:]: v.cpu() for k, v in ref_states[-1].items() if k.startswith("model.")}},
                       os.path.join(out, f"one_device_{str(dtype)[6:]}.pt"))
            del m1
            if dtype == torch.float32:
                del one, ref_states
        del one
        torch.cuda.empty_cache()
        for mode in RANKS_MODES:
            graphed = shard_state(_ranks_state(seed, model_kw, tx), mesh, mode)
            eager = shard_state(_ranks_state(seed, model_kw, tx), mesh, mode)
            step = ts.make_train_step(graphed, state_shardings(mesh, graphed, mode), mesh)
            forward = ts._Forward(eager.model)
            eager_step = lambda b, n: ts._host_step(eager, lambda update: ts._sharded_program(
                forward, eager.optimizer, eager.layout, b, n, update))
            r: dict = {"issued": []}
            for i, n in enumerate(noises):
                before = dict(C.ISSUED)
                lg = step(graphed, batch, n)
                r["issued"].append({k: v - before.get(k, 0) for k, v in C.ISSUED.items() if v != before.get(k, 0)})
                le = eager_step(batch, n)
                torch.cuda.synchronize()
                wg, we = _whole_state(graphed), _whole_state(eager)
                r[f"step{i + 1}_replay_vs_eager"] = all(torch.equal(lg[k], le[k]) for k in le) and \
                    all(torch.equal(wg[k], we[k]) for k in we)
                r[f"step{i + 1}_vs_one_device"] = all(torch.equal(lg[k], ref_losses[i][k]) for k in le) and \
                    sorted(wg) == sorted(ref_states[i]) and all(torch.equal(wg[k], ref_states[i][k]) for k in wg)
                del wg, we
            r["captures"], r["replays"] = dict(step.graphs.captures), dict(step.graphs.replays)
            r["buckets"] = len(graphed.layout.buckets)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(graphed, batch, noises[0])
                torch.cuda.synchronize()
            names: dict = {}
            for e in prof.key_averages():
                if any(s in e.key.lower() for s in ("nccl", "memcpy", "onerank")):
                    names[e.key[:80]] = e.count
            r["replay_trace_collectives"] = names
            r["replay_trace_kernels"] = traced_launches(prof.key_averages())
            r["replay_ms"] = host_ms(lambda: step(graphed, batch, noises[0]), 4)[1:]
            r["held_bytes"] = graphed.layout.held_bytes(graphed.optimizer)
            res["modes"][mode] = r
            del graphed, eager, step, forward
            torch.cuda.empty_cache()
    finally:
        pd.shutdown()
    return res


def gloo_rank(seed: int, rank: int, port: int, out: str) -> dict:
    """Phase 13b, one of two processes on cuda:0 in a gloo group: for each
    of RANKS_RUNS (ddp and fsdp over two data ranks, 4 rows each, and tp
    over two model ranks, all 8 rows, the ViT's and the affine head's
    layers Megatron-split, K2 on 8 of the 16 heads, at fp32 compute; ddp
    at bf16), the sharded step (eager: gloo) for RANKS_STEPS steps; rank
    0 holds the losses and the gathered state against phase 13a's
    one-device reference at the run's dtype.  Returns per run each step's
    losses' largest relative error, the change of the
    parameters per group (relative RMS) and the largest parameter
    difference in lr, digests of the replicated parameters and
    statistics, the bytes held and ms per step."""
    import hashlib

    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.parallel import distributed as pd
    from picopose_tpu_torch.parallel import full_state_dict, make_mesh, shard_batch, shard_state, state_shardings
    from picopose_tpu_torch.train import step as ts

    kernels.build()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pd.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    res: dict = {}
    try:
        for dtype, mode, n_data, n_model in RANKS_RUNS:
            batch, noises, model_kw, tx = _ranks_inputs(seed, dtype)
            name = f"one_device_{str(dtype)[6:]}.pt"
            ref = torch.load(os.path.join(out, name), map_location=dev, weights_only=True) if rank == 0 else None
            mesh = make_mesh(n_data, n_model, dev)
            rows = shard_batch(batch, mesh)
            state = _ranks_state(seed, model_kw, tx)
            before = {k: v.clone() for k, v in state.model.state_dict().items()} if rank == 0 else None
            shard_state(state, mesh, mode)
            step = ts.make_train_step(state, state_shardings(mesh, state, mode), mesh)
            kernels.reset_launches()
            losses, ms = [], []
            for i, n in enumerate(noises):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append({k: float(v) for k, v in step(state, rows, n).items()})
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:  # the first step's gradient (a collective when sharded), against one process's
                    m1 = first_moments(state)
                    if rank == 0:
                        num = sum(float(((m1[j].double() - g.to(dev).double()) ** 2).sum()) for j, g in ref["m1"].items())
                        den = sum(float((g.double() ** 2).sum()) for g in ref["m1"].values())
                        flips = sum(int((torch.sign(m1[j]) != torch.sign(g.to(dev))).sum()) for j, g in ref["m1"].items())
                        grad = {"rel_rms": (num / den) ** 0.5,
                                "sign_flips": flips / sum(g.numel() for g in ref["m1"].values())}
                    del m1
            r = {"ms": ms, "launches": dict(kernels.LAUNCHES), "held_bytes": state.layout.held_bytes(state.optimizer),
                 "rows": len(rows["real_rgb"])}
            layout = state.layout
            digest = lambda t: hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()
            r["replicated"] = hashlib.sha256("".join(
                [digest(t) for s, t in zip(layout.specs, layout.local) if not s.split]
                + [digest(b) for b in state.model.buffers()]).encode()).hexdigest()
            r["split"] = sum(s.split for s in layout.specs)
            whole = full_state_dict(state)
            if rank == 0:
                r["loss_rel"] = [max(abs(l[k] - ref["losses"][i][k]) / max(abs(ref["losses"][i][k]), 1e-12)
                                     for k in l) for i, l in enumerate(losses)]
                delta = lambda sd: {k: sd[k].float() - before[k].float() for k in before}
                r["state_rel_rms"] = rel_rms_by_group(delta(whole), delta(ref["state"]))
                params = {n for n, _ in state.model.named_parameters()}
                r["param_max_lr"], r["param_max_at"] = max(
                    (float((whole[k] - ref["state"][k]).abs().max()) / RANKS_LR, k) for k in params)
                r["loss"] = losses[-1]["loss"]
                r["grad"] = grad
            res[f"{mode} {str(dtype)[6:]}"] = r
            del state, step, whole, ref
            torch.cuda.empty_cache()
    finally:
        pd.shutdown()
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ranks_phase(seed: int) -> None:
    """Phase 13: the multi-device layer on the one card.  (a) a one-rank
    NCCL group (``nccl_one_rank``); (b) two gloo ranks sharing the card
    (``gloo_rank``), each step held against the one-process step at the
    global batch; each in fresh processes."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ranks_phase_", dir=here)
    try:
        t0 = time.perf_counter()
        a = in_fresh_interpreter(f"nccl_one_rank({seed}, {_free_port()}, {tmp!r})", "[ranks]")
        print(f"[ranks] (a) one-rank NCCL group, ViT-L's width at {RANKS_DEPTH} blocks, bf16, global batch "
              f"{RANKS_B}, AdamW lr {RANKS_LR}: "
              f"{time.perf_counter() - t0!r} s")
        for dtype, w in a["witness"].items():
            print(f"[ranks] (a) what 4 rows instead of 8 change in the forward, one device, {dtype}: the ViT's taps "
                  f"of rows 0-3 relative RMS {w['vit_rows_rel_rms']!r}, share of elements that differ "
                  f"{w['vit_rows_share_differing']!r}")
        for mode, r in a["modes"].items():
            print(f"[ranks] (a) {mode}: {r['buckets']} gradient buckets; collectives issued by each call "
                  f"{r['issued']}; captures {r['captures']}, replays {r['replays']}; replay bitwise the eager "
                  f"sharded step: {[r[f'step{i + 1}_replay_vs_eager'] for i in range(RANKS_STEPS)]}; bitwise the "
                  f"one-device step: {[r[f'step{i + 1}_vs_one_device'] for i in range(RANKS_STEPS)]}")
            print(f"[ranks] (a) {mode}: one replay's trace: NCCL and copy entries {r['replay_trace_collectives']}; "
                  f"the wrappers' kernels {r['replay_trace_kernels']}; replay ms {r['replay_ms']!r}; bytes held "
                  f"{r['held_bytes']}")
            for i in range(RANKS_STEPS):
                check(r[f"step{i + 1}_replay_vs_eager"], f"(a) {mode} step {i + 1}: the replay equals the eager step")
                check(r[f"step{i + 1}_vs_one_device"], f"(a) {mode} step {i + 1}: equals the one-device step")
            check(r["issued"][0].get("all_reduce") == 2 * r["buckets"] and not r["issued"][1],
                  f"(a) {mode}: the capturing call all-reduced each bucket (warm-up and capture), the replay "
                  "issued nothing from the host")
            check(r["replay_trace_kernels"] == RANKS_FORWARD, f"(a) {mode}: a replay ran K1, K2, K4, K5")
        t0 = time.perf_counter()
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import json, chip_smoke; print('FRESH_RESULT', json.dumps("
                                   f"chip_smoke.gloo_rank({seed}, {r}, {port}, {tmp!r})))"],
            cwd=here, env={**os.environ, "PYTHONPATH": here}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        outs = [p.communicate(timeout=900) for p in procs]
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                print(o[-3000:], e[-6000:], file=sys.stderr)
        check(all(p.returncode == 0 for p in procs), "(b) both gloo ranks exit 0")
        b = [json.loads(o.split("FRESH_RESULT ", 1)[1].splitlines()[0]) for o, _ in outs]
        print(f"[ranks] (b) two gloo ranks on cuda:0: {time.perf_counter() - t0!r} s")
        for dtype, mode, n_data, n_model in RANKS_RUNS:
            mode = f"{mode} {str(dtype)[6:]}"
            r0, r1 = b[0][mode], b[1][mode]
            print(f"[ranks] (b) {mode} ({n_data} x {n_model}, {r0['rows']} rows per rank): losses' largest "
                  f"relative error against the one-process step, by step "
                  f"{r0['loss_rel']!r} (loss {r0['loss']!r}); change of the parameters, relative RMS by group "
                  f"{r0['state_rel_rms']}; largest parameter difference {r0['param_max_lr']!r} lr (in "
                  f"{r0['param_max_at']}); the first "
                  f"step's gradient (AdamW's first moment) relative RMS {r0['grad']['rel_rms']!r}, share of elements "
                  f"of the other sign {r0['grad']['sign_flips']!r}; replicated "
                  f"tensors equal across ranks {r0['replicated'] == r1['replicated']}; split leaves {r0['split']}; "
                  f"bytes held rank 0 {r0['held_bytes']}, rank 1 {r1['held_bytes']}; ms per step rank 0 "
                  f"{r0['ms']!r}, rank 1 {r1['ms']!r}; the wrappers' launches per rank {r0['launches']}")
        for dtype, mode, _, _ in RANKS_RUNS:
            mode = f"{mode} {str(dtype)[6:]}"
            r0, r1 = b[0][mode], b[1][mode]
            lim = RANKS_LIMITS[dtype]
            check(all(e <= l for e, l in zip(r0["loss_rel"], lim["loss"])),
                  f"(b) {mode}: the steps' losses within {lim['loss']} relative")
            check(r0["grad"]["rel_rms"] <= lim["grad_rms"],
                  f"(b) {mode}: the first step's gradient within {lim['grad_rms']} relative RMS")
            check(max(r0["state_rel_rms"].values()) <= lim["state_rms"],
                  f"(b) {mode}: the change of the parameters within {lim['state_rms']} relative RMS per group")
            check(r0["param_max_lr"] <= lim["param_lr"], f"(b) {mode}: each parameter within {lim['param_lr']} lr")
            check(r0["replicated"] == r1["replicated"], f"(b) {mode}: replicated tensors bitwise across ranks")
            want = {k: v * RANKS_STEPS for k, v in RANKS_FORWARD.items()}
            check(r0["launches"] == r1["launches"] == want, f"(b) {mode}: each rank launched K1, K2, K4, K5 each step")
        ddp, fsdp = (sum(b[0][m]["held_bytes"].values()) for m in ("ddp float32", "fsdp float32"))
        print(f"[ranks] (b) fsdp holds {fsdp / ddp!r} of ddp's bytes per rank")
        check(b[0]["fsdp float32"]["split"] > 0 and fsdp <= 0.6 * ddp,
              "(b) fsdp: each rank holds about half of ddp's bytes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def devices_phase(seed: int, root: str, world: dict, argv: list) -> None:
    """Phase 13c, on phase 7's BOP tree and checkpoint: ``PoseEstimator(
    devices=[cuda:0, cuda:0])`` with both objects' banks placed round-robin
    against the one-device estimator (placement; ``estimate`` on the first
    frame's 20 detections bitwise), then ``evaluate_dataset`` of the model
    on ``cuda`` through its compiled programs, from a caller's generator:
    the one-device run at batch 10 against ``use_mesh=True`` over
    ``[cuda:0]`` at batch 10 and over ``[cuda:0, cuda:0]`` at batch 20
    (two parts of 10; the rounding leaves 20 as it is, and each object's
    20 instances make the same calls, in the same order, as at batch 10):
    the CSV's rows and order, scene, image, object, score, R and t equal,
    and no replica of the model made on the card it sits on.  The
    reference runs at the parts' batch: a bf16 run at 16 rows came out
    otherwise than two parts of 8 (PERF.md).  The template views are the
    ones phase 7 decoded (``world["templates"]``)."""
    import csv
    import warnings

    from picopose_tpu_torch.data.bop import BOPTestDataset
    from picopose_tpu_torch.eval import runner
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch import serve as serve_module
    from picopose_tpu_torch.serve import PoseEstimator
    from picopose_tpu_torch.utils.checkpoint import load_any
    from picopose_tpu_torch.utils.config import load_config
    from picopose_tpu_torch.utils.weights import load_flax_variables

    ckpt = argv[argv.index("--checkpoint_path") + 1]
    cfg = load_config(argv[argv.index("--config") + 1], argv[argv.index("--set") + 1:])
    t = cfg.test_dataset
    dataset = lambda: BOPTestDataset(t.data_dir, "smoke", os.path.join(t.detection_dir, "smoke.json"),
                                     n_template_view=t.n_template_view)
    tem_dir = os.path.join(t.template_dir, "smoke")
    ds = dataset()
    rgb, K = ds.load_raw(0)
    dets = ds.dets(0)
    two = ["cuda:0", "cuda:0"]
    views, load = dict(world.get("templates", {})), runner.load_template_views

    def cached(*a):  # each object's 162 views as phase 7 decoded them
        if a not in views:
            views[a] = load(*a)
        return views[a]

    t0 = time.perf_counter()
    variables = load_any(ckpt, depth=24)
    one = PoseEstimator(variables=variables)
    with patched((serve_module, "load_template_views", cached)):
        for obj in EVAL_OBJECTS:
            one.register_object(obj, tem_dir)
    est = PoseEstimator(variables=variables, devices=two)
    for obj in EVAL_OBJECTS:  # the same banks, placed round-robin
        est.register_bank(obj, one._banks[obj])
    results = [one.estimate(rgb, K, dets), est.estimate(rgb, K, dets)]
    placed, replicas = dict(est._bank_device), len(est._replicas)
    del one, est
    torch.cuda.empty_cache()
    same = all(np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t) and a.score == b.score
               for a, b in zip(*results))
    print(f"[devices] PoseEstimator(devices={two}): banks placed {placed}, replicas beside the home model "
          f"{replicas}; estimate on {len(dets)} detections bitwise the one-device estimator's: {same} "
          f"({time.perf_counter() - t0!r} s with both estimators' bank builds)")
    check(placed == {obj: torch.device("cuda", 0) for obj in EVAL_OBJECTS} and replicas == 0,
          "(c) both banks on cuda:0, no second replica of the model on one card")
    check(same and len(results[0]) == len(dets), "(c) estimate over devices equals the one-device estimate")

    model = PicoPose("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16, device="cuda")
    load_flax_variables(model, variables)
    del variables
    hyp = cfg.model.hypothesis

    made, replica_on = [], runner.replica_on

    def counted(home, device, seed):
        rep = replica_on(home, device, seed)
        made.append(rep is not home)
        return rep

    counts = {}
    for det in ds.dets(0) + ds.dets(1):
        counts[det["category_id"]] = counts.get(det["category_id"], 0) + 1
    check(all(-(-n // 10) == 2 * -(-n // 20) for n in counts.values()),
          f"(c) each object's instances {counts} make the same calls at batch 10 and in parts of 10")
    one_card = [torch.device("cuda", 0)]
    rows, times = {}, {}
    for tag, bs, kw in (("one device, batch 10", 10, {}),
                        ("mesh of one card, batch 10", 10, dict(use_mesh=True, devices=one_card)),
                        ("mesh of two, batch 20", 20, dict(use_mesh=True, devices=two))):
        path = os.path.join(root, "devices_" + re.sub(r"\W+", "_", tag) + ".csv")
        t0 = time.perf_counter()
        with warnings.catch_warnings(), patched((runner, "load_template_views", cached),
                                                (runner, "replica_on", counted)):
            warnings.simplefilter("ignore")
            runner.evaluate_dataset(model, dataset(), tem_dir, path, hyp=hyp, batch_size=bs, progress=False,
                                    generator=torch.Generator(device="cuda").manual_seed(7), **kw)
        times[tag] = time.perf_counter() - t0
        with open(path) as f:
            rows[tag] = [r[:6] for r in csv.reader(f)]
    pose = lambda r: (np.array(r[4].split(), float).reshape(3, 3), np.array(r[5].split(), float) / 1000.0)
    a, b, c = rows.values()
    print(f"[devices] evaluate_dataset of the model on 'cuda', compiled, generator seeded 7: one device at batch 10 "
          f"against use_mesh over [cuda:0] at batch 10: the first six columns (scene, image, object, score, R, t) "
          f"equal {a == b}; over [cuda:0, cuda:0] at batch 20 (parts of 10, instances per object {counts}) equal "
          f"{a == c}; replicas of the model made {sum(made)} of {len(made)} parts' devices; wall s {times}")
    check(not any(made) and len(made) == 3, "(c) no replica of the model on the card it sits on")
    check(len(a) == world["n_instances"] and a == b == c and all(
        np.abs(pose(r)[0].T @ pose(r)[0] - np.eye(3)).max() < 1e-3 and np.isfinite(pose(r)[1]).all() for r in a),
        "(c) from one generator, the mesh runs' rows, poses included, are the one-device run's")
    del model


# phase 14: train_to_ar's world cut to 64 training and 8 test views over
# two scenes; --steps 10 at 64 views and batch 8 makes 2 epochs of 5 steps
# (train_to_ar sets the epochs as examples/train_to_ar.py does; the loader
# starts its worker pool once per epoch, 8-15 s on the card's host)
AR_WORLD = ("--objects", "lshape,tex,cube", "--pair_frac", "0.375", "--scenes", "2", "--train_views", "64",
            "--test_views", "8")
AR_STEPS = 10
AR_TAGS = ("random", "trained", "trained_int8", "trained_topk1", "trained_quant")
AR_KEYS = ("AR_MSSD", "AR_MSPD", "AR_mssd_mspd", "AR_VSD", "AR_bop19")


# the accuracy loop's evaluation batches: run_test --batch 4 with 2
# hypotheses, so stage 3 runs 8 fp32 streams over 4 query maps; argument
# sets rotated per call at each grid (> 50 MB of L2 in fp32)
AR_B2, AR_GROUP = 4, 2
AR_SETS = {16: 18, 32: 5, 64: 2}


def ar_loop_kernel_checks(g: torch.Generator) -> dict:
    """K1-K5 at the accuracy loop's shapes (ViT-S, fp32): K1 on a bank
    chunk's and a training batch's rows (32 and 16 crops, 257 tokens, width
    384), K2 on their qkv views (6 heads), K3 for the evaluation's 4
    queries against a 42-view bank (S = 256, C = 384) in fp32 and its int8
    branch on the same operands quantised, K4 and K5 at the evaluation's
    stage 3 (AR_B2 query maps x AR_GROUP hypotheses, C = 256, fp32, lookup
    radius 2; one launch per decoder level and grid, on wild centres).
    Returns the fp32 rows of K2 (a bank chunk's 32 crops), K3, K4 and K5."""
    out = {}
    for rows in (32, 16):
        layernorm_row(g, rows, "ar", width=384, dtype=torch.float32)
        r = attention_row(g, "qkv views", rows, "ar", heads=6, dtype=torch.float32)
        out.setdefault("attention", r)
    out["match_scores"], q32, qm, t32 = match_row(g, 4, 42, 256, 384, torch.float32, "ar")
    match_int8_checks(q32, qm, t32, "ar")
    what = f"at the loop's shapes ({AR_B2} x {AR_GROUP} streams, fp32, wild centres)"
    out["corr_window"] = corr_timing(what, wild_corr_args(g, 2, AR_SETS, AR_B2, AR_GROUP, torch.float32))
    out["warp"] = warp_timing(what, [
        [(random_rows(g, AR_B2, G * G, dtype=torch.float32), wild_centres(g, AR_B2 * AR_GROUP, G), G, G, AR_GROUP)
         for _ in range(AR_SETS[G])] for G in (16, 32, 64)])
    return out


def ar_log(path: str) -> dict:
    """The kernel launches a child run under RUN_COUNTED printed last."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("[counts] ")]
    check(bool(lines), f"{os.path.basename(path)} holds the run's counts")
    return json.loads(lines[-1].removeprefix("[counts] "))["launches"]


def ar_loop_runs(seed: int) -> dict:
    """Phase 14's runs, the closed accuracy loop at its width (ViT-S, taps
    2/5/8/11, fp32, 2 hypotheses, 42-view banks) through
    ``picopose_tpu_torch.train_to_ar`` in a temporary directory in the
    checkout: a world of three objects (AR_WORLD) written by
    ``synthetic_world``, the random-weights arm, ``run_train`` (AR_STEPS, 2
    epochs of 5 steps), the trained arm and the three serving-mode arms, each
    scored by ``score_csv --vsd --bootstrap 2000``; every child run under
    RUN_COUNTED, so each prints its kernel launches.  Checks: the training
    rolls over from epoch 0 to epoch 1 within its one run (the log's epoch
    lines) and its loss falls (the last epoch's mean below the first's), every
    arm's CSV has one row per detection, every AR finite and in [0, 1] over
    the same GT instances, every run launched K1, K2, K4 and K5, each
    evaluation K3's fp32 branch, except the ``PICOPOSE_MATCH_INT8`` arm,
    which launched the int8 branch and not the fp32 one.  ``run_train``
    runs under RUN_TIMED: each step's time in the compiled step and since
    the previous one (loader-bound or step-bound).  Returns the launches of
    all the runs, summed per kernel."""
    import shutil
    import tempfile

    from picopose_tpu_torch import train_to_ar

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ar_loop_", dir=here)
    root = os.path.join(tmp, "world")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)  # the runs write log/ here
        module = train_to_ar.module

        def counted(name):  # the training and evaluation runs print their launches, the training its steps
            if name in ("run_train", "run_test"):
                return [sys.executable, "-c", RUN_TIMED if name == "run_train" else RUN_COUNTED,
                        f"picopose_tpu_torch.{name}"]
            return module(name)

        t0 = time.perf_counter()
        with patched((train_to_ar, "module", counted)):
            summary = train_to_ar.main(["--root", root, "--steps", str(AR_STEPS), *AR_WORLD])
        wall = time.perf_counter() - t0
        os.chdir(cwd)
        with open(os.path.join(root, "stage_seconds.json")) as f:
            seconds = json.load(f)
        print(f"[ar] train_to_ar {wall!r} s; stage seconds {seconds!r}")

        epochs, heads = [], []
        with open(os.path.join(tmp, "log", "picopose", "version_910", "training_logger.log")) as f:
            for line in f:
                if " done at iter " in line:
                    heads.append(line.split("] ", 1)[1].split(" |")[0])
                    epochs.append(float(line.split("loss(avg): ")[1].split(",")[0]))
        print(f"[ar] training: {heads!r}, loss(avg) per epoch {epochs!r}")
        half = AR_STEPS // 2
        check(heads == [f"epoch 0 done at iter {half}", f"epoch 1 done at iter {AR_STEPS}"],
              "run_train rolled over from epoch 0 to epoch 1 in one run")
        check(len(epochs) == 2 and np.isfinite(epochs).all() and epochs[-1] < epochs[0], "the training loss falls")

        with open(os.path.join(root, "dets", "fakeds.json")) as f:
            n_dets = len(json.load(f))
        arms = dict(zip(AR_TAGS, ("ar_random", "ar_trained", "ar_trained_int8_matching", "ar_trained_stage3_topk1",
                                  "ar_trained_quantize_stage3")))
        n_gt = summary["ar_random"]["n_gt"]
        total = {k: 0 for k in (*DEFAULT_PATH_KERNELS, "match_scores_int8")}
        for tag, key in arms.items():
            with open(os.path.join(root, f"csv_{tag}.csv")) as f:
                rows = [r for r in f.read().splitlines() if r]
            r = summary[key]
            launches = ar_log(os.path.join(root, f"eval_{tag}.log"))
            print(f"[ar] {tag}: {len(rows)} CSV rows of {n_dets} detections; "
                  f"{ {k: r[k] for k in AR_KEYS}!r}, ci95 {r['ci95']!r}, n_gt {r['n_gt']}; "
                  f"paired {r.get('paired_delta_vs_baseline')!r}; launches {launches!r}")
            check(len(rows) == n_dets, f"{tag}: one CSV row per detection")
            check(r["n_gt"] == n_gt > 0 and all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in AR_KEYS),
                  f"{tag}: every AR finite and in [0, 1] over the same GT instances")
            k3 = ("match_scores_int8", "match_scores") if tag == "trained_int8" else ("match_scores",
                                                                                      "match_scores_int8")
            check(all(launches.get(k, 0) > 0 for k in ("layernorm", "attention", "corr_window", "warp", k3[0]))
                  and launches.get(k3[1], 0) == 0, f"{tag}: K1, K2, K4, K5 and K3's {k3[0]} launched, not {k3[1]}")
            for k in total:
                total[k] += launches.get(k, 0)
        launches = ar_log(os.path.join(root, "train.log"))
        print(f"[ar] run_train launches {launches!r}")
        check(all(launches.get(k, 0) > 0 for k in ("layernorm", "attention", "corr_window", "warp")),
              "run_train launched K1, K2, K4 and K5")
        for k in total:
            total[k] += launches.get(k, 0)

        with open(os.path.join(root, "train.log")) as f:
            steps = json.loads([ln for ln in f.read().splitlines() if ln.startswith("[steps] ")][-1][8:])
        n = len(steps["step_ms"])
        check(n == 10, "run_train took 10 steps")
        # the first step captures the program; an epoch's first step waits for the loader's new pool
        per_epoch = n // 2
        step_ms = float(np.median(steps["step_ms"][1:]))
        within = [w for i, w in enumerate(steps["wait_ms"]) if i % per_epoch]
        starts = [w for i, w in enumerate(steps["wait_ms"]) if i and not i % per_epoch]
        wait_ms = float(np.median(within))
        print(f"[ar] run_train's steps (batch 8, 4 workers): in the compiled step {step_ms!r} ms (median of the "
              f"replays; the capturing first step {steps['step_ms'][0]!r} ms), between steps within an epoch "
              f"{wait_ms!r} ms (median), before each later epoch's first step {starts!r} ms (the loader's new "
              f"pool): {'loader' if wait_ms > 0.1 * step_ms else 'step'}-bound within an epoch; "
              f"{8e3 / (step_ms + wait_ms)!r} samples/s within an epoch")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def start_ar_loop(seed: int, log: str) -> subprocess.Popen:
    """Phase 14's runs (``ar_loop_runs``) in a process of their own, started
    ahead of phases 7, 11 and 13c and read at the end (``ar_loop_phase``):
    they are subprocesses on ViT-S that leave the card and the host room,
    and the script's time limit does not hold all the phases one after
    another.  Output goes to ``log``."""
    import atexit
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    code = f"import json, chip_smoke; print('FRESH_RESULT', json.dumps(chip_smoke.ar_loop_runs({seed})))"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, env={**os.environ, "PYTHONPATH": here},
                                stdout=f, stderr=subprocess.STDOUT, text=True, start_new_session=True)

    def stop():  # a phase that fails leaves no process of the loop running
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        if os.path.exists(log):
            os.remove(log)

    atexit.register(stop)
    return proc


def ar_loop_phase(seed: int, proc: subprocess.Popen, log: str) -> tuple[dict, dict]:
    """Phase 14: waits for ``start_ar_loop``'s process and prints its lines,
    then K1, K2 and K3 at the loop's shapes on the otherwise idle card
    (``ar_loop_kernel_checks``).  Returns the runs' launches, summed per
    kernel, and the fp32 rows of K2 and K3."""
    t0 = time.perf_counter()
    rc = proc.wait(timeout=1200)
    print(f"[ar] waited {time.perf_counter() - t0!r} s for the loop's process")
    with open(log) as f:
        out = f.read()
    for line in out.split("FRESH_RESULT ", 1)[0].splitlines():
        if line.startswith("[ar]"):
            print(line)
    if rc != 0:
        print(out[-8000:], file=sys.stderr)
    check(rc == 0, "phase 14's runs exit 0 and pass their checks")
    t0 = time.perf_counter()
    rows = ar_loop_kernel_checks(torch.Generator(device="cuda").manual_seed(seed + 14))
    print(f"[ar] kernels at the loop's shapes {time.perf_counter() - t0!r} s")
    return json.loads(out.split("FRESH_RESULT ", 1)[1].splitlines()[0]), rows


# ---------------------------------------------------------------- phase 15: demos, per-item banks, export_torch

PER_ITEM = (16, 162, 16, 1024)  # queries, views, grid side, channels: the main path's (ViT-L, 162 views)
DEMOS = (("synthetic_demo", ()), ("serve_demo", ("--vit", "dinov2_vitl14")))


def start_demos(tmp: str) -> dict:
    """The two demos as users call them (``python -m``; the synthetic one
    with its defaults), each under RUN_COUNTED in a process of its own,
    started together, output to ``<tmp>/<name>.log``; no serving-mode
    variable is passed on.  Returns name -> (process, log path)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PICOPOSE_MATCH_")}
    env["PYTHONPATH"] = here
    procs = {}
    for name, args in DEMOS:
        log = os.path.join(tmp, f"{name}.log")
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen([sys.executable, "-c", RUN_COUNTED, f"picopose_tpu_torch.{name}", *args],
                                            cwd=here, env=env, stdout=f, stderr=subprocess.STDOUT, text=True,
                                            start_new_session=True), log)
    return procs


def read_demo(name: str, proc: subprocess.Popen, log: str, card: str) -> None:
    """Wait for a demo, print its lines, check its exit code, its poses and
    its launches (K1-K5)."""
    rc = proc.wait(timeout=900)
    with open(log) as f:
        out = f.read()
    lines = out.splitlines()
    if rc != 0:
        print(out[-8000:], file=sys.stderr)
    check(rc == 0, f"{name} exits 0")
    for line in lines:
        if not line.startswith("[counts] "):
            print(f"[demos] {name} ({card}): {line}")
    launches = json.loads([ln for ln in lines if ln.startswith("[counts] ")][-1][len("[counts] "):])["launches"]
    check(all(launches.get(k, 0) > 0 for k in DEFAULT_PATH_KERNELS), f"{name} launched K1-K5: {launches}")
    if name == "synthetic_demo":
        poses = [json.loads(ln.split("[demo] best pose: ", 1)[1]) for ln in lines if "[demo] best pose: " in ln]
        poses = [np.array(p["R"] + [p["t_mm"]]) for p in poses]
    else:
        poses = [json.loads(ln.split(" pose: ", 1)[1]) for ln in lines if re.match(r"frame \d+ pose: ", ln)]
        poses = [np.array(p["R"] + [p["t"]]) for p in poses]
        check("objects=[1]" in out, "serve_demo's second estimator reloads object 1")
    want = 1 if name == "synthetic_demo" else 3
    check(len(poses) == want and all(p.shape == (4, 3) and np.isfinite(p).all() for p in poses),
          f"{name} prints {want} finite pose(s)")
    print(f"[demos] {name}: exit 0, {len(poses)} finite pose(s), launches {launches}")


@torch.inference_mode()
def per_item_check(seed: int) -> None:
    """Per-item banks at full width: B copies of a shared fp32 bank of N
    views (PER_ITEM; 2.7 GB) through ``match_templates``' per-item path
    (plain fp32 products, no TF32, views in chunks; no kernel) against K3
    fp32 on the shared bank (one launch): every view's score within 1e-5;
    where the two id orders differ, the swapped views' K3 scores lie
    within 2e-5 of each other (a near tie), counted."""
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.ops import matching as M

    B, N, h, C = PER_ITEM
    g = torch.Generator(device="cuda").manual_seed(seed + 15)
    bank = torch.randn(N, h, h, C, generator=g, device="cuda")
    q = torch.randn(B, h, h, C, generator=g, device="cuda") + 0.5 * bank[:B]  # planted best views
    mask = (torch.rand(B, 224, 224, generator=g, device="cuda") > 0.3).float()
    kernels.reset_launches()
    ref_s, ref_i = M.match_templates(bank, q, mask, topk=N, mode=None)
    torch.cuda.synchronize()
    check(dict(kernels.LAUNCHES) == {"match_scores": 1}, f"the shared fp32 bank launched K3 once: {kernels.LAUNCHES}")
    per_item = bank[None].repeat(B, 1, 1, 1, 1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got_s, got_i = M.match_templates(per_item, q, mask, topk=N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not kernels.LAUNCHES, f"per-item banks launch no kernel: {kernels.LAUNCHES}")
    by_view = lambda s, i: torch.empty_like(s).scatter_(1, i, s)
    ref_table = by_view(ref_s, ref_i)
    err = (by_view(got_s, got_i) - ref_table).abs().max().item()
    differ = got_i != ref_i
    gap = (ref_table.gather(1, got_i) - ref_s).abs()[differ]
    print(f"[demos] per-item banks {tuple(per_item.shape)} fp32 ({per_item.numel() * 4 / 2**30!r} GiB) against K3 "
          f"fp32 on the shared bank: max score error {err!r} (tolerance 1e-5), {int(differ.sum())} of {B * N} ranks "
          f"ordered otherwise (near ties: K3 scores at most {gap.max().item() if gap.numel() else 0.0!r} apart), "
          f"top-1 equal for {int((got_i[:, 0] == ref_i[:, 0]).sum())} of {B} queries; first call {wall!r} s, host "
          f"clock (phase 14's process shares the card)")
    check(err <= 1e-5, "per-item scores within 1e-5 of K3 fp32 on the shared bank")
    check(bool((gap <= 2e-5).all()), "per-item ids equal K3's except at near ties")
    check(bool((got_i[:, 0] == torch.arange(B, device="cuda")).all()), "each query finds its planted view")


def export_check(seed: int, tmp: str) -> None:
    """``python -m picopose_tpu_torch.export_torch`` on a ViT-S train state
    saved by utils/checkpoint.py::save, in a process with no card visible
    (it runs on the host): the file holds ``export_state_dict`` of the
    state's model, bitwise."""
    from picopose_tpu_torch.train.step import init_state, make_optimizer
    from picopose_tpu_torch.utils import checkpoint as ckpt
    from picopose_tpu_torch.utils.torch_export import export_state_dict

    here = os.path.dirname(os.path.abspath(__file__))
    state = init_state(make_optimizer(), seed, vit_type="dinov2_vits14", blocks_to_take=(2, 5, 8, 11),
                       compute_dtype=torch.float32)
    path = ckpt.save(tmp, 1, state, epoch=0)
    out = os.path.join(tmp, "vits.ckpt")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "picopose_tpu_torch.export_torch", path, out, "--depth", "12"],
                       cwd=here, env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=here),
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
    check(p.returncode == 0, "export_torch exits 0 with no card visible")
    got = torch.load(out, map_location="cpu", weights_only=True)["state_dict"]
    ref = export_state_dict(state.model.state_dict())
    check(sorted(got) == sorted(f"network.{k}" for k in ref), "export_torch writes export_state_dict's keys")
    bad = [k for k, v in ref.items() if not torch.equal(got[f"network.{k}"], torch.from_numpy(v))]
    check(not bad, f"export_torch writes export_state_dict's values: {bad[:3]}")
    print(f"[demos] export_torch: a ViT-S train state ({os.path.getsize(path) / 2**20!r} MiB) -> "
          f"{os.path.getsize(out) / 2**20!r} MiB, {len(ref)} tensors bitwise export_state_dict, in {wall!r} s "
          f"(a fresh interpreter, no card visible)")


def demos_phase(seed: int, card: str) -> None:
    """Phase 15: the demos in their processes while the per-item check
    and the export run here; a temporary directory in the checkout, removed
    after; a phase that fails stops the demos' processes."""
    import shutil
    import signal
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="demos_", dir=here)
    procs = start_demos(tmp)
    try:
        t0 = time.perf_counter()
        per_item_check(seed)
        print(f"[demos] per-item check {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        export_check(seed, tmp)
        print(f"[demos] export check {time.perf_counter() - t0!r} s")
        for name, (proc, log) in procs.items():
            read_demo(name, proc, log, card)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


T_START = time.perf_counter()


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

    from picopose_tpu_torch import native

    t0 = time.perf_counter()
    native.build_library(native.library_path())  # a missing compiler or a failed build raises
    native.load_library()
    cxx = native.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout.splitlines()[0]
    print(f"[build] host library {os.path.basename(native.library_path())} ({len(native.sources())} sources, one "
          f"{cxx} call: {' '.join(native.CXX_FLAGS + native.LD_FLAGS)}) built in {time.perf_counter() - t0!r} s; "
          f"{version}")

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
    int8_launches, world = serve_phase(SEED)
    launches["match_scores_int8"] = int8_launches["match_scores_int8"]
    print(f"[phase] serve {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    replay_launches = graph_phase(SEED, world)
    del world
    print(f"[phase] compiled programs (phase 10) {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    gradient_phase(SEED)
    print(f"[phase] gradients {time.perf_counter() - t0!r} s")
    ar_log_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"ar_loop_{os.getpid()}.log")
    ar_proc = start_ar_loop(SEED, ar_log_path)
    t0 = time.perf_counter()
    t_dec = []

    def decoder(*a):
        t = time.perf_counter()
        decoder_phase(SEED, *a)
        t_dec.append(time.perf_counter() - t)
        t = time.perf_counter()
        devices_phase(SEED, *a)
        t_dec.append(time.perf_counter() - t)
        t = time.perf_counter()
        formats_phase(SEED, *a)
        t_dec.append(time.perf_counter() - t)
        t = time.perf_counter()
        orbax_phase(SEED, *a)
        t_dec.append(time.perf_counter() - t)

    eval_cli_phase(SEED, then=decoder)
    print(f"[phase] eval CLI {time.perf_counter() - t0 - sum(t_dec)!r} s; configurable decoder (phase 11) "
          f"{t_dec[0]!r} s; devices (phase 13c) {t_dec[1]!r} s; image formats (phase 16) {t_dec[2]!r} s; "
          f"orbax checkpoints (phase 17) {t_dec[3]!r} s")
    t0 = time.perf_counter()
    train_launches, step_ms = train_phase(SEED)
    print(f"[phase] training step {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    loop_launches = loop_phase(SEED, step_ms)
    print(f"[phase] training loop {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    cad_to_ar_phase(SEED)
    print(f"[phase] CAD to AR (phase 12) {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    ranks_phase(SEED)
    print(f"[phase] ranks (phase 13a, 13b) {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    demos_phase(SEED, card)
    print(f"[phase] demos, per-item banks, export_torch (phase 15) {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    ar_launches, ar_rows = ar_loop_phase(SEED, ar_proc, ar_log_path)
    print(f"[phase] accuracy loop (phase 14, its runs started before phase 7) {time.perf_counter() - t0!r} s")

    src = "picopose_tpu_torch/kernels/csrc/"
    replaces = {
        "layernorm": "picopose_tpu/ops/pallas/layernorm.py:51",
        "attention": "picopose_tpu/ops/pallas/flash_attention.py:69",
        "match_scores": "picopose_tpu/ops/pallas/matching.py:81",
        "match_scores_int8": "picopose_tpu/ops/pallas/matching.py:37",
        "corr_window": "picopose_tpu/ops/pallas/corr.py:327",
        "warp": "picopose_tpu/ops/pallas/warp.py:102",
    }
    def brief(r: dict) -> dict:
        return {"max_abs_err": r["err"], "tol": r["tol"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"], "timed_by": r["timed_by"]}

    fp32 = {"attention": {"loop": brief(ar_rows["attention"])},
            "match_scores": {"main": brief(checks["match_scores_fp32"]), "loop": brief(ar_rows["match_scores"])},
            "corr_window": {"loop": brief(ar_rows["corr_window"])}, "warp": {"loop": brief(ar_rows["warp"])}}
    rows = []
    for name, (source, _, _) in kernels.KERNELS.items():
        r = checks[name]
        rows.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces[name], "launches": launches[name],
            "replay_launches": replay_launches[name],
            "train_launches": train_launches[name], "loop_launches": loop_launches[name],
            "ar_launches": ar_launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "timed_by": r["timed_by"],
            **({"fp32": fp32[name]} if name in fp32 else {}),
        })
    print(f"[total] chip_smoke.py {time.perf_counter() - T_START!r} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
