"""Score a bop19 CSV against BOP ground truth, without JAX.

    python -m picopose_tpu_torch.score_csv --csv preds.csv --data_dir data/BOP \
        --dataset lmo [--n_model_pts 500] [--vsd] [--bootstrap N] \
        [--dump_records records.pkl] [--paired_vs baseline.pkl]

The port's counterpart of the JAX package's score_csv.py, with every flag
of it (:17-41), over eval/bop_scoring.py: AR_MSSD and AR_MSPD, and with
``--vsd`` AR_VSD and AR_bop19, the object depth rendered by the port's C++
rasterizer (native/renderer.py::render_views) and the scenes' 16-bit depth
PNGs read by data/png.py::read_png.  ``--bootstrap N`` adds percentile
bootstrap 95% intervals over GT instances (key ``ci95``); ``--dump_records``
pickles the per-instance hit records and ``--paired_vs`` adds the paired
bootstrap AR deltas against such a file (key
``paired_delta_vs_baseline``).  Prints the result as JSON.  It uses no
device.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from picopose_tpu_torch.eval.bop_scoring import (
    GTInstance,
    ObjectModel,
    bootstrap_ar,
    continuous_syms,
    paired_delta_ar,
    read_csv,
    score_bop19,
)


def main(argv=None) -> dict:
    """Score the CSV; prints the result as JSON and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--n_model_pts", type=int, default=500)
    ap.add_argument("--vsd", action="store_true",
                    help="also compute AR_VSD (renders depth with the C++ "
                         "rasterizer and reads the scenes' depth images) -> "
                         "full AR_bop19")
    ap.add_argument("--bootstrap", type=int, default=0, metavar="N",
                    help="add N-resample percentile-bootstrap 95%% CIs over "
                         "GT instances (key 'ci95')")
    ap.add_argument("--dump_records", metavar="PKL",
                    help="pickle the per-GT-instance hit records to PKL for "
                         "later paired comparison (--paired_vs)")
    ap.add_argument("--paired_vs", metavar="PKL",
                    help="baseline records from a previous --dump_records run "
                         "over the SAME ground truth; adds paired-bootstrap "
                         "AR deltas (this run minus baseline, key "
                         "'paired_delta_vs_baseline')")
    args = ap.parse_args(argv)

    from picopose_tpu_torch.native.renderer import load_ply

    root = os.path.join(args.data_dir, args.dataset)
    model_dir = os.path.join(
        root, "models_cad" if args.dataset == "tless" else "models"
    )
    with open(os.path.join(model_dir, "models_info.json")) as f:
        models_info = {int(k): v for k, v in json.load(f).items()}

    rng = np.random.default_rng(0)
    models: dict[int, ObjectModel] = {}
    for obj_id, info in models_info.items():
        verts, _, _ = load_ply(os.path.join(model_dir, f"obj_{obj_id:06d}.ply"))
        if len(verts) > args.n_model_pts:
            verts = verts[rng.choice(len(verts), args.n_model_pts, replace=False)]
        syms = [np.eye(4)]
        for s in info.get("symmetries_discrete", []):
            syms.append(np.asarray(s, np.float64).reshape(4, 4))
        sym_arr = np.stack(syms)
        for s in info.get("symmetries_continuous", []):
            sym_arr = np.concatenate(
                [sym_arr, continuous_syms(s.get("axis", [0, 0, 1]))], axis=0
            )
        models[obj_id] = ObjectModel(
            pts=verts.astype(np.float64), diameter=float(info["diameter"]),
            syms=sym_arr,
        )

    estimates = read_csv(args.csv)
    needed = {(e.scene_id, e.im_id) for e in estimates}

    gts: list[GTInstance] = []
    K_by_image: dict[tuple[int, int], np.ndarray] = {}
    test_dir = os.path.join(root, "test")
    for scene in sorted({s for s, _ in needed}):
        sdir = os.path.join(test_dir, f"{scene:06d}")
        with open(os.path.join(sdir, "scene_gt.json")) as f:
            scene_gt = json.load(f)
        with open(os.path.join(sdir, "scene_camera.json")) as f:
            cams = json.load(f)
        gt_info = {}
        info_path = os.path.join(sdir, "scene_gt_info.json")
        if os.path.exists(info_path):
            with open(info_path) as f:
                gt_info = json.load(f)
        for im_s, entries in scene_gt.items():
            im = int(im_s)
            if (scene, im) not in needed:
                continue
            K_by_image[(scene, im)] = np.asarray(
                cams[im_s]["cam_K"], np.float64
            ).reshape(3, 3)
            infos = gt_info.get(im_s, [{}] * len(entries))
            for g, gi in zip(entries, infos):
                gts.append(
                    GTInstance(
                        scene_id=scene, im_id=im, obj_id=int(g["obj_id"]),
                        R=np.asarray(g["cam_R_m2c"], np.float64).reshape(3, 3),
                        t=np.asarray(g["cam_t_m2c"], np.float64).reshape(3),
                        visib_fract=float(gi.get("visib_fract", 1.0)),
                    )
                )

    render_depth = None
    scene_depth = None
    if args.vsd:
        from picopose_tpu_torch.data.png import read_png
        from picopose_tpu_torch.native.renderer import render_views

        meshes = {}
        for obj_id in models_info:
            meshes[obj_id] = load_ply(
                os.path.join(model_dir, f"obj_{obj_id:06d}.ply")
            )

        def render_depth(obj_id, R, t, Kk):
            verts, colors, faces = meshes[obj_id]
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3], pose[:3, 3] = R, t
            _, depth = render_views(
                verts, colors, faces, pose[None], Kk.astype(np.float32),
                (480, 640),
            )
            return depth[0].astype(np.float64)

        scene_depth = {}
        for scene, im in needed:
            p = os.path.join(test_dir, f"{scene:06d}", "depth", f"{im:06d}.png")
            if os.path.exists(p):
                with open(os.path.join(
                    test_dir, f"{scene:06d}", "scene_camera.json"
                )) as f:
                    ds = json.load(f)[str(im)].get("depth_scale", 1.0)
                scene_depth[(scene, im)] = (
                    np.asarray(read_png(p), np.float64) * ds
                )

    want_records = args.bootstrap or args.dump_records or args.paired_vs
    records = [] if want_records else None
    result = score_bop19(
        estimates, gts, models, K_by_image,
        render_depth=render_depth, scene_depth_by_image=scene_depth,
        per_instance=records,
    )
    if args.bootstrap:
        result["ci95"] = bootstrap_ar(records, n_boot=args.bootstrap)
    if args.dump_records:
        with open(args.dump_records, "wb") as f:
            pickle.dump(records, f)
    if args.paired_vs:
        with open(args.paired_vs, "rb") as f:
            baseline_records = pickle.load(f)
        result["paired_delta_vs_baseline"] = paired_delta_ar(
            baseline_records, records,
            n_boot=max(args.bootstrap, 2000),
        )
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
