"""Serving-API demo with zero external data, on the PyTorch port.

    python -m picopose_tpu_torch.serve_demo [--checkpoint model.ckpt] [--views 42] \
        [--vit dinov2_vits14] [--device cpu]

The port's counterpart of examples/serve_demo.py, with its flags plus
``--device`` (the card unless ``cpu`` is passed; no fallback to the CPU).
It renders a cube's template bank with the port's rasterizer
(native/renderer.py), starts a ``PoseEstimator`` (serve.py: fp32, 2
hypotheses, 50 PnP iterations, batches of 4), registers the object and
estimates its pose in three freshly rendered frames: the per-frame loop a
service runs.  Then it saves the banks and loads them into a second
estimator, which skips the backbone pass.  ``--vit`` picks the ViT and its
taps (``TAPS``).

Without ``--checkpoint`` the estimator draws its weights from seed 0
(utils/weights.py::init_random_, the JAX ``model.init``'s distributions,
not its values) and the poses mean nothing; pass a reference checkpoint
or a train state the port saved for a ported model.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

TAPS = {
    "dinov2_vitl14": (5, 11, 17, 23),
    "dinov2_vits14": (1, 3, 5, 7),
}
K = np.array([[572.4114, 0, 320.0], [0, 573.57043, 240.0], [0, 0, 1.0]], np.float32)
CUBE_MM = 60.0
FRAMES = 3


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="PoseEstimator on rendered frames of a cube (PyTorch port)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--views", type=int, default=42)
    ap.add_argument("--vit", default="dinov2_vits14", choices=sorted(TAPS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def frame_pose(frame: int) -> np.ndarray:
    """The cube's pose in frame ``frame`` (4 x 4, mm)."""
    from scipy.spatial.transform import Rotation

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("xyz", [0.3 * frame, 0.2, 0.5]).as_matrix()
    T[:3, 3] = [10.0, -5.0, 450.0 + 30 * frame]
    return T


def demo(views: int = 42, vit: str = "dinov2_vits14", checkpoint: str | None = None, variables=None,
         device=None, **model_kw) -> dict:
    """Register the cube, estimate three frames, save and reload the banks.

    ``variables``: the JAX package's flax variables (they take precedence
    over ``checkpoint``); with neither, seeded random weights.
    ``model_kw`` go to ``PoseEstimator`` over the demo's settings
    (``blocks_to_take`` is ``TAPS[vit]`` unless given).  Returns
    ``results`` (one PoseResult per frame), ``gt`` (the frames' poses, mm)
    and ``reloaded`` (the object ids the second estimator loaded).
    """
    from picopose_tpu_torch.native.renderer import load_ply, make_cube_ply, render_object_bank, render_views
    from picopose_tpu_torch.serve import PoseEstimator

    kw = dict(checkpoint=checkpoint, variables=variables, vit_type=vit, blocks_to_take=TAPS.get(vit),
              compute_dtype="float32", hyp=2, n_template_view=views, pnp_iters=50, max_batch=4,
              device=device)
    kw.update(model_kw)
    results, gts = [], []
    with tempfile.TemporaryDirectory() as root:
        cad = os.path.join(root, "obj_000001.ply")
        make_cube_ply(cad, size=CUBE_MM)
        bank_dir = os.path.join(root, "bank")
        render_object_bank(cad, bank_dir, level=0, obj_id=1)

        est = PoseEstimator(**kw)
        t0 = time.perf_counter()
        est.register_object(1, bank_dir)
        print(f"bank built in {time.perf_counter() - t0:.1f}s ({views} views)")

        verts, colors, faces = load_ply(cad)
        for frame in range(FRAMES):
            T = frame_pose(frame)
            rgba, _ = render_views(verts, colors, faces, T[None], K)
            rgb = rgba[0][..., :3]
            mask = (rgba[0][..., 3] > 0).astype(np.uint8)

            t0 = time.perf_counter()
            (res,) = est.estimate(rgb, K, [{"obj_id": 1, "mask": mask}])
            dt = time.perf_counter() - t0
            t_err = float(np.linalg.norm(res.t - T[:3, 3] / 1000.0))  # mm -> m
            print(f"frame {frame}: {dt * 1000:.0f} ms  score={res.score:.2f} "
                  f"success={res.success}  |t - t_gt|={t_err * 100:.1f} cm")
            print(f"frame {frame} pose: {json.dumps({'R': res.R.tolist(), 't': res.t.tolist()})}")
            results.append(res)
            gts.append(T)

        # bank persistence: a fresh estimator skips the backbone pass
        bank_cache = os.path.join(root, "banks")
        est.save_banks(bank_cache)
        est2 = PoseEstimator(**kw)
        t0 = time.perf_counter()
        objs = est2.load_banks(bank_cache)
        print(f"bank reloaded from disk in {time.perf_counter() - t0:.2f}s: objects={objs}")
    return {"results": results, "gt": np.stack(gts), "reloaded": objs}


def main(argv: list[str] | None = None) -> dict:
    args = get_parser().parse_args(argv)
    return demo(args.views, args.vit, args.checkpoint, device=args.device)


if __name__ == "__main__":
    main()
