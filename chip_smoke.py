#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PicoPose on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit; build every CUDA kernel of the port
     from picopose_tpu_torch/kernels/csrc (one nvcc per source, in parallel);
  2. each kernel at the main path's shapes against its plain PyTorch
     version (stated tolerance), with kernel / plain / library-call times
     (CUDA events, inputs rotated so L2 does not hold them) and its bound;
  3. the port's stages 1-2 at full ViT-L width (dinov2_vitl14, taps
     5/11/17/23, bf16, seeded random weights): build_bank over 162 views
     (chunk 32), then select_templates + stage2_poses for 16 queries x 5
     hypotheses, with every kernel's launch counter set to 0 just before
     and read just after; outputs checked (finite, ids in range, each query
     finds its own template view, R^T R = I), then bank-build and per-batch
     times and a profile of one batch (device time by kernel, idle share);
  4. the same path at a small size (vit_tiny_test, 6 views, 2 queries) on
     the card against the plain CPU path at the same weights, fp32 and bf16.
Then the kernels as one JSON line, the card line, and the result line.
TF32 is off for matmuls and convolutions throughout.  Inputs and weights
are drawn from SEED.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12


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

    # K1: LayerNorm of the (16, 257, 1024) bf16 residual stream
    xs = [(rn(16, 257, 1024) * 3 + 1.5).bfloat16() for _ in range(8)]  # 8 x 8.4 MB > 50 MB L2
    scale, bias = rn(1024) * 0.2 + 1, rn(1024) * 0.5
    args = [(x, scale, bias) for x in xs]
    got, ref = L.layernorm_cuda(*args[0]), L.layernorm_plain(*args[0])
    torch.cuda.synchronize()
    # one bf16 rounding step apart at most: rtol 2^-7
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-3, rtol=2**-7)
    w16, b16 = scale.bfloat16(), bias.bfloat16()
    out["layernorm"] = dict(
        err=(got.float() - ref.float()).abs().max().item(), tol="atol 1e-3 + rtol 2^-7",
        ms=cuda_ms(L.layernorm_cuda, args), plain_ms=cuda_ms(L.layernorm_plain, args),
        library_ms=cuda_ms(lambda x, s, b: F.layer_norm(x, (1024,), w16, b16, 1e-6), args),
        bound=bound(2 * xs[0].numel() * 2 + 2 * 1024 * 4, 8 * xs[0].numel(), H100_FP32_FLOPS),
    )

    # K2: attention of the ViT-L query batch, (16, 16, 257, 64) bf16
    qkvs = [tuple(rn(16, 16, 257, 64).bfloat16() for _ in range(3)) for _ in range(3)]  # 76 MB
    got, ref = A.attention_cuda(*qkvs[0]), A.attention_plain(*qkvs[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=2**-7)
    BH, N, D = 16 * 16, 257, 64
    out["attention"] = dict(
        err=(got.float() - ref.float()).abs().max().item(), tol="atol 1e-2 + rtol 2^-7",
        ms=cuda_ms(A.attention_cuda, qkvs), plain_ms=cuda_ms(A.attention_plain, qkvs),
        library_ms=cuda_ms(F.scaled_dot_product_attention, qkvs),
        bound=bound(4 * BH * N * D * 2, 4 * BH * N * N * D, H100_BF16_FLOPS),
    )

    # K3: 16 queries against a 162-view bf16 bank (S = 256, C = 1024); each
    # query is a noisy copy of one view so the table has structure
    B, Nv, S, C = 16, 162, 256, 1024
    t = M.l2_normalize(rn(Nv, S, C))
    q = M.l2_normalize(t[torch.arange(B, device=dev) * 10] + 0.5 * C**-0.5 * rn(B, S, C))
    qm = (torch.rand(B, S, generator=g, device=dev) > 0.3).float()
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
        ms=cuda_ms(M.match_scores_cuda, margs, iters=10),
        plain_ms=cuda_ms(M.match_scores_plain, margs, iters=5),
        library_ms=cuda_ms(library, margs, iters=5),
        bound=bound(q.numel() * 2 + qm.numel() * 4 + t.numel() * 2 + B * Nv * 4,
                    2 * B * Nv * S * S * C, H100_BF16_FLOPS),
    )
    for name, r in out.items():
        print(f"[kernel] {name}: max_abs_err {r['err']!r} ({r['tol']}), kernel {r['ms']!r} ms, "
              f"plain {r['plain_ms']!r} ms, library {r['library_ms']!r} ms, "
              f"bound {r['bound'][0]!r} ms ({r['bound'][1]})")
    return out


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


def profile_batch(run) -> float:
    """Device time by kernel over one call of ``run`` (torch.profiler);
    returns the device's busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"[profile] device busy {busy_ms!r} ms ({wall_ms!r} ms wall under the profiler)")
    for e in sorted(events, key=dev_us, reverse=True)[:16]:
        print(f"[profile] {dev_us(e) / 1e3!r} ms x{e.count} {e.key[:100]}")
    return busy_ms


def full_slice(seed: int) -> dict:
    """Phase 3: the main path at full ViT-L width; returns launch counts."""
    from picopose_tpu_torch import kernels
    from picopose_tpu_torch.eval.pipeline import build_bank, select_templates, stage2_poses
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.utils.weights import init_random_

    n_views, B, hyp, chunk = 162, 16, 5, 32
    model = PicoPose("dinov2_vitl14", (5, 11, 17, 23), torch.bfloat16, device="cuda")
    init_random_(model, seed)
    queries = list(range(0, n_views, 10))[:B]
    bank_np, batch = synthetic_world(n_views, queries, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    bank, scores, ids, pred_Ms, poses = run_slice(model, bank_np, batch, hyp, chunk)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[slice] launches during the main-path run: {launches}")
    for name in kernels.KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} launched on the main path")
    check(ids.shape == (B, hyp) and poses.shape == (B * hyp, 4, 4), "output shapes")
    check_outputs("slice", scores, ids, pred_Ms, poses, n_views, queries)
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    # bank build and per-batch times, host clock around synchronised work
    dev_bank = [torch.as_tensor(a, device="cuda") for a in bank_np]
    dev_batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def host_ms(fn, runs):
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def one_batch():
        feats_real, _, ids = select_templates(model, dev_batch, bank, hyp=hyp)
        stage2_poses(model, dev_batch, bank, feats_real, ids)

    bank_ms = host_ms(lambda: build_bank(model, *dev_bank, chunk=chunk), 4)[1:]
    batch_ms = host_ms(one_batch, 21)[1:]
    per_batch = float(np.median(batch_ms))
    print(f"[slice] bank build (162 views, chunk 32) ms, 3 runs after one warm-up: {bank_ms!r}")
    print(f"[slice] per batch (16 queries, hyp 5, stages 1-2) ms, 20 runs after one warm-up: "
          f"median {per_batch!r}, min {min(batch_ms)!r}, max {max(batch_ms)!r} "
          f"= {B / per_batch * 1e3!r} crops/s at the median")
    print("[profile] one batch of 16 queries (select_templates + stage2_poses):")
    busy_ms = profile_batch(one_batch)
    print(f"[profile] device idle share against the unprofiled median: {1 - busy_ms / per_batch!r}")
    return launches


def small_reference(seed: int) -> None:
    """Phase 4: kernels on the card against the plain CPU path, same weights."""
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.utils.weights import init_random_

    def rel(got, ref):  # relative RMS error ||got - ref|| / ||ref||
        got, ref = got.cpu().double(), ref.cpu().double()
        return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()

    bank_np, batch = synthetic_world(6, [1, 4], seed + 1)
    # fp32: other summation orders only; bf16: other rounding points, and
    # only the selected (best) hypothesis is compared
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        cpu = PicoPose("vit_tiny_test", (0, 1, 2, 3), dtype, device="cpu")
        init_random_(cpu, seed)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from picopose_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    launches = full_slice(SEED)
    print(f"[phase] full-width slice {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    small_reference(SEED)
    print(f"[phase] small reference {time.perf_counter() - t0!r} s")

    src = "picopose_tpu_torch/kernels/csrc/"
    replaces = {
        "layernorm": "picopose_tpu/ops/pallas/layernorm.py:51",
        "attention": "picopose_tpu/ops/pallas/flash_attention.py:69",
        "match_scores": "picopose_tpu/ops/pallas/matching.py:81",
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
