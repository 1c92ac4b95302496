"""End-to-end demo with zero external data, on the PyTorch port.

    python -m picopose_tpu_torch.synthetic_demo [--checkpoint model.ckpt] [--views 42] [--device cpu]

The port's counterpart of examples/synthetic_demo.py, with its flags plus
``--device`` (the card unless ``cpu`` is passed; no fallback to the CPU).
It renders a cube's template bank (42 views, icosphere level 0) and one
ground-truth view of the same cube with the port's rasterizer
(native/renderer.py), builds the bank with ``build_bank_graphed``, runs
the three stages and RANSAC-PnP with ``run_batch_graphed`` and prints the
best hypothesis's pose error against the ground truth (``pose_summary``).

The model is the JAX demo's ``PicoPose()``: ViT-L/14, taps 5/11/17/23,
bf16, full width.  Without ``--checkpoint`` its weights are drawn by
utils/weights.py::init_random_(model, 0), from the distributions of the
JAX package's ``model.init`` but not its values (the port has no JAX), so
the poses are not the JAX demo's.  With random weights the neural stages
carry no signal: the demo shows the data contract and the runtime path.
For a meaningful pose, pass a reference checkpoint or a train state the
port saved:

    python -m picopose_tpu_torch.synthetic_demo --checkpoint /path/to/picopose.ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

GT_EULER_XYZ = (0.5, 0.2, 0.9)  # the ground-truth view's rotation, radians
GT_T_MM = (15.0, -8.0, 420.0)
CUBE_MM = 60.0


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="PicoPose end to end on a rendered cube (PyTorch port)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--views", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def demo(views: int = 42, checkpoint: str | None = None, variables=None, device=None, **model_kw) -> dict:
    """Render, build the bank, run one crop; returns the outputs.

    ``variables``: the JAX package's flax variables, carried across by
    ``load_flax_variables`` (they take precedence over ``checkpoint``);
    with neither, seeded random weights.  ``model_kw`` go to ``PicoPose``
    (its defaults are the JAX demo's model).  Returns ``out`` (the
    EvalOutput), ``batch`` (the crop's numpy arrays), ``tem`` (the bank's
    views as ``load_template_views`` gives them), ``gt`` (4 x 4, mm),
    ``summary``, ``pose`` (the best R and t in mm, as lists), and the
    ``model`` and ``bank`` it ran.
    """
    import torch
    from scipy.spatial.transform import Rotation

    from picopose_tpu_torch.data.bop import load_template_views
    from picopose_tpu_torch.data.crops import (
        crop_and_normalize_rgb, crop_mask, crop_matrix, grid_pts2d, mask_square_bbox,
    )
    from picopose_tpu_torch.eval.metrics import pose_summary
    from picopose_tpu_torch.eval.pipeline import build_bank_graphed, run_batch_graphed
    from picopose_tpu_torch.models import PicoPose
    from picopose_tpu_torch.native.renderer import (
        TEMPLATES_K, load_ply, make_cube_ply, render_object_bank, render_views,
    )
    from picopose_tpu_torch.utils.checkpoint import load_any
    from picopose_tpu_torch.utils.graphs import GraphCache
    from picopose_tpu_torch.utils.precast import precast_inference_params
    from picopose_tpu_torch.utils.weights import init_random_, load_flax_variables

    model = PicoPose(**model_kw, device=device)
    if variables is None and checkpoint:
        variables = load_any(checkpoint, depth=model.feature_extractor.cfg.depth)
    if variables is not None:
        load_flax_variables(model, variables)
    else:
        print("[demo] random weights (structure demo only)")
        init_random_(model, 0)
    if model.compute_dtype == torch.bfloat16:
        precast_inference_params(model)  # bf16 weight storage, bitwise the same outputs

    with tempfile.TemporaryDirectory(prefix="picopose_demo_") as tmp:
        cad = os.path.join(tmp, "obj_000001.ply")
        make_cube_ply(cad, size=CUBE_MM)
        print(f"[demo] rendering a {views}-view template bank -> {tmp}")
        render_object_bank(cad, os.path.join(tmp, "bank"), level=0, obj_id=1)

        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = Rotation.from_euler("xyz", GT_EULER_XYZ).as_matrix()
        gt[:3, 3] = GT_T_MM
        verts, colors, faces = load_ply(cad)
        rgba, _ = render_views(verts, colors, faces, gt[None], TEMPLATES_K)
        tem = load_template_views(os.path.join(tmp, "bank"), 1, n_views=views)
    mask = (rgba[0, :, :, 3] > 0).astype(np.float32)
    bbox = mask_square_bbox(mask)
    M = crop_matrix(bbox, 224)
    batch = {
        "real_rgb": crop_and_normalize_rgb(rgba[0, :, :, :3], bbox, 224)[None],
        "real_mask": crop_mask(mask, bbox, 224)[None],
        "real_M": M[None],
        "real_K": TEMPLATES_K.astype(np.float32)[None],
        "real_pts2d": grid_pts2d(M)[None],
    }

    graphs = GraphCache(model.device)
    print(f"[demo] building the bank on the device ({views} views, 4 levels + DPT)")
    bank = build_bank_graphed(graphs, model, *(tem[k] for k in (
        "tem_rgb", "tem_mask", "tem_pts3d", "tem_pose", "tem_K", "tem_M")))
    print("[demo] running the compiled pipeline (captured on the first call)")
    generator = torch.Generator(device=model.device).manual_seed(0)
    out = run_batch_graphed(graphs, model, batch, bank, generator=generator)
    R = out.R[0, 0].cpu().numpy()
    t = out.t[0, 0].cpu().numpy() * 1000.0  # -> mm (bank poses are mm / 1000)
    summary = pose_summary(R, t, gt[:3, :3], gt[:3, 3])
    return {"out": out, "batch": batch, "tem": tem, "gt": gt, "summary": summary,
            "pose": {"R": R.tolist(), "t_mm": t.tolist()}, "model": model, "bank": bank}


def main(argv: list[str] | None = None) -> dict:
    args = get_parser().parse_args(argv)
    result = demo(args.views, args.checkpoint, device=args.device)
    out = result["out"]
    print(f"[demo] best-hypothesis inlier ratio: {float(out.inlier_ratio[0, 0]):.3f}")
    print(f"[demo] best pose: {json.dumps(result['pose'])}")
    print(f"[demo] pose error vs GT: {result['summary']}")
    print("[demo] done — pipeline executed end-to-end.")
    return result


if __name__ == "__main__":
    main()
