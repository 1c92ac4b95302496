"""Render template banks from CAD models, without JAX.

    python -m picopose_tpu_torch.render_templates --models_dir data/BOP/lmo/models \
        --out_dir data/templates/lmo [--level 1] [--pose_table table.npy] \
        [--models_json models.json] [--start 0] [--end -1]

The port's counterpart of the JAX package's render_templates.py (the
same arguments, :23-38): for every ``obj_*.ply`` of ``--models_dir``, or
every ``{"obj_id", "cad_path" | "ply_path"}`` entry of ``--models_json``
(PLY, OBJ or GLB), render the icosphere level's RGBA + depth views at
640x480 with the C++ rasterizer (native/renderer.py::render_object_bank)
and write the bank in the reference layout.  It prints, per model, the
views and the seconds spent loading, rendering and writing PNGs
(utils/profiling.py::StageTimer).  It uses no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models_dir", help="dir of obj_XXXXXX.ply (BOP layout)")
    p.add_argument("--models_json", default=None,
                   help="GSO/ShapeNet-style models json: a list of "
                        "{'obj_id': int, 'cad_path'|'ply_path': str} entries")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--level", type=int, default=1, help="icosphere level (0/1/2)")
    p.add_argument("--pose_table", default=None,
                   help="external (N,4,4) obj pose table .npy (for ordering "
                        "compat with reference-rendered banks)")
    p.add_argument("--start", type=int, default=0, help="first model index")
    p.add_argument("--end", type=int, default=-1, help="one-past-last index")
    args = p.parse_args(argv)

    import numpy as np

    from picopose_tpu_torch.native.renderer import render_object_bank
    from picopose_tpu_torch.utils.profiling import StageTimer

    table = np.load(args.pose_table) if args.pose_table else None
    jobs: list[tuple[str, int | None]] = []
    if args.models_json:
        with open(args.models_json) as f:
            entries = json.load(f)
        if isinstance(entries, dict):
            entries = list(entries.values())
        for e in entries:
            path = e.get("cad_path") or e.get("ply_path") or e.get("path")
            jobs.append((path, int(e["obj_id"])))
    else:
        if not args.models_dir:
            raise SystemExit("need --models_dir or --models_json")
        for cad in sorted(glob.glob(os.path.join(args.models_dir, "obj_*.ply"))):
            jobs.append((cad, None))
    if not jobs:
        raise SystemExit("no models found")
    end = len(jobs) if args.end < 0 else args.end
    for cad, obj_id in jobs[args.start : end]:
        t0 = time.perf_counter()
        timer = StageTimer()
        poses = render_object_bank(cad, args.out_dir, args.level, table, obj_id, timer=timer)
        per_view = {k: 1000.0 * timer.totals[k] / len(poses) for k in ("render", "write")}
        print(f"{os.path.basename(cad)}: {len(poses)} views in {time.perf_counter() - t0:.1f}s "
              f"({timer.report()}); ms per view: render {per_view['render']!r}, "
              f"PNG write {per_view['write']!r}")


if __name__ == "__main__":
    main()
