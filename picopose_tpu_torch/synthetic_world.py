"""Generate a self-contained synthetic BOP + MegaPose world, without JAX.

    python -m picopose_tpu_torch.synthetic_world --root /tmp/world --train 128 --test 8
    python -m picopose_tpu_torch.synthetic_world --root /tmp/world_r5 --train 128 \
        --test 320 --objects lshape,tex,cube --pair_frac 0.375 --scenes 4

The port's counterpart of tools/synthetic_world.py, with the same flags,
the same draws from the same numpy ``Generator`` and the same tree:
template banks (a level-``--level`` test bank and a level-1 GSO training
bank, depth and pose x10), a BOP test scene tree (rgb and 16-bit depth
PNGs, scene_camera / scene_gt / scene_gt_info, models with
models_info.json, CNOS-style RLE detections, bop19 targets) and a
MegaPose-GSO training shard tree (q95 4:2:0 ``.rgb.jpg`` frames), rendered
from procedurally built CADs by the port's rasterizer
(native/renderer.py).  PNGs are written by data/png.py::write_png and
JPEGs by data/jpeg.py::write_jpeg (libjpeg's encoder at PIL's defaults),
so every image decodes to the arrays the JAX tool's imageio files decode
to, and every JSON and ``.npy`` file is equal to its.

This is the data of the closed accuracy loop (train_to_ar.py): run_train
trains on the training tree, run_test evaluates on the BOP tree and
score_csv scores the CSV against the scene_gt written here.

Object kinds (``--objects``):
  * ``lshape``  - an asymmetric vertex-coloured L solid (unambiguous poses);
  * ``tex``     - an asymmetric stepped block whose appearance comes only
    from a UV-mapped texture atlas (the textured rasterizer and the PLY
    ``texture_u/v`` loader);
  * ``cube``    - a cube whose colouring is invariant under its 24 proper
    rotations, declared by BOP ``symmetries_discrete`` in models_info, so
    the scorer must apply symmetry-aware MSSD / MSPD / VSD.

``--pair_frac`` renders that fraction of images with two overlapping
instances (z-buffer composited), with per-instance visible masks and
visib_fract; ``--scenes`` splits the test images over several scene ids.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil

import numpy as np

from picopose_tpu_torch.data.jpeg import write_jpeg
from picopose_tpu_torch.data.png import read_png, write_png
from picopose_tpu_torch.native.renderer import Mesh, load_mesh, render_mesh_views, render_object_bank

K = np.array(
    [[572.4114, 0, 320.0], [0, 573.57043, 240.0], [0, 0, 1.0]], np.float32
)
DS = "fakeds"
HW = (480, 640)


def encode_rle(mask: np.ndarray) -> dict:
    """COCO-style uncompressed RLE (column-major), as CNOS writes it."""
    flat = mask.flatten(order="F").astype(np.uint8)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:  # RLE starts with a zero-run
        counts = [0] + counts
    return {"size": [int(mask.shape[0]), int(mask.shape[1])], "counts": counts}


# ---------------------------------------------------------------- CAD builders


def _box(cx, cy, cz, hx, hy, hz, base):
    verts = np.array(
        [
            [cx + dx * hx, cy + dy * hy, cz + dz * hz]
            for dx in (-1, 1)
            for dy in (-1, 1)
            for dz in (-1, 1)
        ],
        np.float32,
    )
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [(base + a, base + b, base + c),
                  (base + a, base + c, base + d)]
    return verts, faces


def _write_ply(path, verts, colors, faces, uv=None, texture_file=None):
    with open(path, "wb") as f:
        hdr = ["ply", "format ascii 1.0"]
        if texture_file is not None:
            hdr.append(f"comment TextureFile {texture_file}")
        hdr += [
            f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z",
        ]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        if uv is not None:
            hdr += ["property float texture_u", "property float texture_v"]
        hdr += [
            f"element face {len(faces)}",
            "property list uchar int vertex_indices",
            "end_header",
        ]
        f.write(("\n".join(hdr) + "\n").encode())
        for i, v in enumerate(verts):
            row = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = colors[i]
                row += f" {c[0]} {c[1]} {c[2]}"
            if uv is not None:
                row += f" {uv[i][0]} {uv[i][1]}"
            f.write((row + "\n").encode())
        for a, b, c in faces:
            f.write(f"3 {a} {b} {c}\n".encode())


def make_lshape_ply(path: str, size: float = 60.0) -> None:
    """An asymmetric L-shaped solid (two boxes) with position-keyed vertex
    colors — no geometric or visual symmetry, so pose errors are
    unambiguous for AR scoring."""
    s = size / 2.0
    v1, f1 = _box(0, 0, 0, s, 0.45 * s, 0.45 * s, 0)  # long arm along x
    v2, f2 = _box(-0.55 * s, 0.7 * s, 0.1 * s, 0.45 * s, 0.6 * s, 0.35 * s, 8)
    verts = np.concatenate([v1, v2])
    faces = f1 + f2
    span = verts.max(0) - verts.min(0)
    colors = (
        (verts - verts.min(0)) / np.maximum(span, 1e-6) * 255.0
    ).astype(np.uint8)
    _write_ply(path, verts, colors, faces)


def make_textured_ply(path: str, size: float = 60.0, seed: int = 7) -> None:
    """An asymmetric stepped block whose ONLY appearance cue is a UV texture.

    Geometry: three stacked boxes of shrinking footprint, offset toward one
    corner (no rotational symmetry).  Vertices are duplicated per face so
    each face direction can carry its own UV patch; the 3x2 texture atlas
    gives every face direction (+x,-x,+y,-y,+z,-z) a distinct high-contrast
    cell, so pose information lives entirely in the texture — a renderer
    that dropped UV sampling would produce a uniform, unmatchable object."""
    s = size / 2.0
    parts = [
        _box(0, 0, -0.3 * s, s, 0.9 * s, 0.35 * s, 0),
        _box(-0.25 * s, -0.2 * s, 0.15 * s, 0.7 * s, 0.6 * s, 0.25 * s, 0),
        _box(-0.45 * s, -0.4 * s, 0.55 * s, 0.4 * s, 0.35 * s, 0.3 * s, 0),
    ]
    all_v, all_f = [], []
    base = 0
    for v, f in parts:
        all_v.append(v)
        all_f += [(a + base, b + base, c + base) for a, b, c in f]
        base += len(v)
    verts = np.concatenate(all_v)
    faces = np.asarray(all_f, np.int32)

    # duplicate vertices per face corner so UVs are per-corner
    tri = verts[faces].reshape(-1, 3)                     # (F*3, 3)
    new_faces = np.arange(len(tri), dtype=np.int32).reshape(-1, 3)

    # per-face dominant axis from the geometric normal
    a, b, c = (verts[faces[:, i]] for i in range(3))
    n = np.cross(b - a, c - a)
    axis = np.abs(n).argmax(1)                            # (F,)
    sign = (np.take_along_axis(n, axis[:, None], 1)[:, 0] > 0).astype(int)
    cell = axis * 2 + sign                                # 0..5 atlas cell

    mn, span = verts.min(0), verts.max(0) - verts.min(0)
    span = np.maximum(span, 1e-6)
    uv = np.zeros((len(tri), 2), np.float32)
    other = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    for fi in range(len(faces)):
        u_ax, v_ax = other[int(axis[fi])]
        col, row = int(cell[fi]) % 3, int(cell[fi]) // 3
        for k in range(3):
            p = tri[fi * 3 + k]
            lu = (p[u_ax] - mn[u_ax]) / span[u_ax]
            lv = (p[v_ax] - mn[v_ax]) / span[v_ax]
            # inset cells to avoid bleeding across atlas boundaries
            uv[fi * 3 + k, 0] = (col + 0.04 + 0.92 * lu) / 3.0
            uv[fi * 3 + k, 1] = (row + 0.04 + 0.92 * lv) / 2.0

    # high-contrast procedural atlas: per-cell hue + checker + blob glyphs
    rng = np.random.default_rng(seed)
    cellpx = 128
    tex = np.zeros((2 * cellpx, 3 * cellpx, 3), np.uint8)
    hues = np.array(
        [[230, 60, 60], [60, 200, 80], [70, 110, 235],
         [235, 200, 50], [200, 70, 220], [60, 210, 210]], np.float32
    )
    yy, xx = np.mgrid[0:cellpx, 0:cellpx].astype(np.float32) / cellpx
    for ci in range(6):
        r0, c0 = (ci // 3) * cellpx, (ci % 3) * cellpx
        checker = (((yy * 6).astype(int) + (xx * 6).astype(int)) % 2)
        base_c = hues[ci] * (0.45 + 0.55 * checker[..., None])
        grad = 0.65 + 0.35 * (xx * 0.5 + yy * 0.5)[..., None]
        cell_img = base_c * grad
        for _ in range(5):  # unique blob glyphs break in-cell symmetry
            cyx = rng.uniform(0.15, 0.85, 2)
            rad = rng.uniform(0.06, 0.16)
            m = (yy - cyx[0]) ** 2 + (xx - cyx[1]) ** 2 < rad * rad
            cell_img[m] = rng.uniform(0, 255, 3)
        tex[r0:r0 + cellpx, c0:c0 + cellpx] = np.clip(cell_img, 0, 255)

    tex_name = os.path.splitext(os.path.basename(path))[0] + "_tex.png"
    write_png(os.path.join(os.path.dirname(path), tex_name), tex)
    # PLY texcoords are v=0-at-bottom (loader flips); our uv built
    # v=0-at-top of the atlas image -> store flipped
    uv_ply = uv.copy()
    uv_ply[:, 1] = 1.0 - uv_ply[:, 1]
    _write_ply(path, tri, None, new_faces, uv=uv_ply, texture_file=tex_name)


def make_sym_cube_ply(path: str, size: float = 60.0) -> None:
    """A cube whose vertex colors are keyed to |coordinate| — invariant under
    the full octahedral rotation group, so appearance carries NO information
    distinguishing the 24 equivalent poses; the scorer must use the declared
    symmetries_discrete to score it fairly."""
    s = size / 2.0
    verts, faces = _box(0, 0, 0, s, s, s, 0)
    colors = (np.abs(verts) / s * 200.0 + 55.0).astype(np.uint8)
    _write_ply(path, verts, colors, faces)


def cube_rotations() -> list[np.ndarray]:
    """The 23 non-identity proper rotations of the cube as 4x4 transforms
    (BOP models_info symmetries_discrete convention: identity excluded)."""
    from itertools import permutations, product

    out = []
    for perm in permutations(range(3)):
        for signs in product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3))
            for i, (p, sg) in enumerate(zip(perm, signs)):
                R[i, p] = sg
            if abs(np.linalg.det(R) - 1.0) < 1e-9 and not np.allclose(
                R, np.eye(3)
            ):
                T = np.eye(4)
                T[:3, :3] = R
                out.append(T)
    assert len(out) == 23
    return out


# ------------------------------------------------------------ pose generation


def random_poses(n: int, rng: np.random.Generator, z0: float) -> np.ndarray:
    """Uniform random rotations (quaternion method) + jittered translation."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(n, 3, 3)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R.astype(np.float32)
    T[:, 0, 3] = rng.uniform(-30, 30, n)
    T[:, 1, 3] = rng.uniform(-25, 25, n)
    T[:, 2, 3] = z0 * rng.uniform(0.85, 1.25, n)
    return T


# ------------------------------------------------------------- world objects


@dataclasses.dataclass
class WorldObject:
    obj_id: int
    kind: str
    cad_path: str
    mesh: Mesh
    diameter: float
    z0: float
    symmetries: list      # non-identity 4x4s for models_info (may be empty)


_MAKERS = {
    "lshape": make_lshape_ply,
    "tex": make_textured_ply,
    "cube": make_sym_cube_ply,
}


def build_objects(root: str, kinds: list[str], size: float) -> list[WorldObject]:
    objs = []
    for i, kind in enumerate(kinds):
        obj_id = i + 1
        cad = os.path.join(root, f"obj_{obj_id:06d}.ply")
        _MAKERS[kind](cad, size)
        mesh = load_mesh(cad)
        if kind == "tex":
            assert mesh.texture is not None, "textured CAD lost its texture"
        diameter = mesh.diameter
        objs.append(
            WorldObject(
                obj_id=obj_id, kind=kind, cad_path=cad, mesh=mesh,
                diameter=diameter, z0=4.0 * diameter,
                symmetries=cube_rotations() if kind == "cube" else [],
            )
        )
    return objs


# ------------------------------------------------------------ scene rendering


def render_composite(objs, poses):
    """Render instances (obj, pose) into ONE image via host z-buffering.

    Returns (rgb (H,W,3) u8, depth (H,W) u16 mm, vis_masks, full_masks) —
    vis_masks are per-instance VISIBLE pixels after occlusion (what CNOS
    sees), full_masks the unoccluded renders (px_count_all)."""
    H, W = HW
    rgbs, depths = [], []
    for o, p in zip(objs, poses):
        rgba, depth = render_mesh_views(
            o.mesh, np.asarray(p, np.float32)[None], K, HW
        )
        rgbs.append(rgba[0])
        depths.append(depth[0])
    d = np.stack(depths).astype(np.float64)          # (k, H, W), 0 = miss
    dd = np.where(d > 0, d, np.inf)
    winner = dd.argmin(0)
    hit = np.isfinite(dd.min(0))
    rgb = np.zeros((H, W, 3), np.uint8)
    depth_img = np.zeros((H, W), np.uint16)
    vis_masks, full_masks = [], []
    for i in range(len(objs)):
        vis = hit & (winner == i)
        rgb[vis] = rgbs[i][vis][:, :3]
        depth_img[vis] = depths[i][vis]
        vis_masks.append(vis.astype(np.uint8))
        full_masks.append((d[i] > 0).astype(np.uint8))
    return rgb, depth_img, vis_masks, full_masks


def sample_image_instances(objs, rng, pair: bool, max_tries: int = 8):
    """Pick 1 or 2 instances (distinct objects) and poses; pairs are placed
    to overlap in the image with both instances >= ~20% visible."""
    if not pair or len(objs) < 1:
        o = objs[rng.integers(len(objs))]
        return [o], [random_poses(1, rng, o.z0)[0]]
    ia = int(rng.integers(len(objs)))
    ib = int(rng.integers(len(objs)))
    if len(objs) > 1:
        while ib == ia:
            ib = int(rng.integers(len(objs)))
    oa, ob = objs[ia], objs[ib]
    pa = random_poses(1, rng, oa.z0)[0]
    best = None
    for _ in range(max_tries):
        pb = random_poses(1, rng, ob.z0)[0]
        # place B's center near A's projected center, slightly offset
        off = rng.uniform(0.25, 0.7) * (oa.diameter + ob.diameter) / 4.0
        ang = rng.uniform(0, 2 * np.pi)
        scale_z = pb[2, 3] / pa[2, 3]
        pb[0, 3] = (pa[0, 3] + off * np.cos(ang)) * scale_z
        pb[1, 3] = (pa[1, 3] + off * np.sin(ang)) * scale_z
        _, _, vis, full = render_composite([oa, ob], [pa, pb])
        fracs = [
            v.sum() / max(f.sum(), 1) for v, f in zip(vis, full)
        ]
        overlap = (full[0] & full[1]).sum() > 0
        if overlap and min(fracs) >= 0.2:
            return [oa, ob], [pa, pb]
        if best is None or min(fracs) > best[0]:
            best = (min(fracs), [pa, pb.copy()])
    return [oa, ob], best[1]


# ------------------------------------------------------------------- builders


def write_models_dir(root: str, objs: list[WorldObject]) -> None:
    mdir = os.path.join(root, "bop", DS, "models")
    os.makedirs(mdir)
    info = {}
    for o in objs:
        shutil.copy(o.cad_path, os.path.join(mdir, os.path.basename(o.cad_path)))
        tex = os.path.splitext(o.cad_path)[0] + "_tex.png"
        if os.path.exists(tex):
            shutil.copy(tex, mdir)
        mn, mx = o.mesh.verts.min(0), o.mesh.verts.max(0)
        entry = {
            "diameter": o.diameter,
            "min_x": float(mn[0]), "min_y": float(mn[1]), "min_z": float(mn[2]),
            "size_x": float(mx[0] - mn[0]), "size_y": float(mx[1] - mn[1]),
            "size_z": float(mx[2] - mn[2]),
        }
        if o.symmetries:
            entry["symmetries_discrete"] = [
                np.asarray(s, np.float64).reshape(-1).tolist()
                for s in o.symmetries
            ]
        info[str(o.obj_id)] = entry
    with open(os.path.join(mdir, "models_info.json"), "w") as f:
        json.dump(info, f)


def build_test_tree(root, objs, n_test, n_scenes, pair_frac, rng):
    """BOP test scenes (scoreable: models + gt + depth) + CNOS dets/targets."""
    dets, targets = [], []
    per_scene = [n_test // n_scenes + (s < n_test % n_scenes)
                 for s in range(n_scenes)]
    n_gt = 0
    for s in range(n_scenes):
        scene_id = s + 1
        scene_dir = os.path.join(root, "bop", DS, "test", f"{scene_id:06d}")
        os.makedirs(os.path.join(scene_dir, "rgb"))
        os.makedirs(os.path.join(scene_dir, "depth"))
        cam, gt, gt_info = {}, {}, {}
        for im_id in range(per_scene[s]):
            pair = rng.random() < pair_frac
            inst_objs, inst_poses = sample_image_instances(objs, rng, pair)
            rgb, depth, vis, full = render_composite(inst_objs, inst_poses)
            write_png(os.path.join(scene_dir, "rgb", f"{im_id:06d}.png"), rgb)
            write_png(os.path.join(scene_dir, "depth", f"{im_id:06d}.png"), depth)
            cam[str(im_id)] = {
                "cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0
            }
            gt[str(im_id)], gt_info[str(im_id)] = [], []
            counts = {}
            for o, pose, vm, fm in zip(inst_objs, inst_poses, vis, full):
                visib = vm.sum() / max(fm.sum(), 1)
                gt[str(im_id)].append({
                    "obj_id": o.obj_id,
                    "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                    "cam_t_m2c": pose[:3, 3].reshape(-1).tolist(),
                })
                ys, xs = np.where(vm)
                bbox = (
                    [int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1),
                     int(ys.max() - ys.min() + 1)]
                    if len(xs) else [0, 0, 1, 1]
                )
                gt_info[str(im_id)].append({
                    "bbox_visib": bbox,
                    "px_count_visib": int(vm.sum()),
                    "px_count_all": int(fm.sum()),
                    "px_count_valid": int(vm.sum()),
                    "visib_fract": float(visib),
                })
                n_gt += 1
                if visib >= 0.1 and vm.sum() >= 32:
                    dets.append({
                        "scene_id": scene_id, "image_id": im_id,
                        "category_id": o.obj_id, "bbox": bbox,
                        "score": 0.9, "time": 0.05,
                        "segmentation": encode_rle(vm),
                    })
                    counts[o.obj_id] = counts.get(o.obj_id, 0) + 1
            for obj_id, cnt in counts.items():
                targets.append({
                    "scene_id": scene_id, "im_id": im_id,
                    "obj_id": obj_id, "inst_count": cnt,
                })
        for name, obj in [
            ("scene_camera.json", cam), ("scene_gt.json", gt),
            ("scene_gt_info.json", gt_info),
        ]:
            with open(os.path.join(scene_dir, name), "w") as f:
                json.dump(obj, f)
    with open(os.path.join(root, "bop", DS, "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)
    os.makedirs(os.path.join(root, "dets"), exist_ok=True)
    with open(os.path.join(root, "dets", f"{DS}.json"), "w") as f:
        json.dump(dets, f)
    return n_gt, len(targets)


def build_train_tree(root, objs, n_train, pair_frac, rng):
    """MegaPose-GSO webdataset-layout training tree.  REAL-branch gt/depth
    use the plain BOP convention (mm; the loader divides by 1000 only —
    provider/training_dataset.py real branch / data/megapose.py
    _process_real).  Only the TEMPLATE bank carries the GSO x10 so the
    loader's x0.1/1000 restores meters (training_dataset.py:294-298)."""
    web = os.path.join(root, "mp", "MegaPose-GSO", "train_pbr_web")
    shard = os.path.join(web, "shard-000000")
    os.makedirs(shard)
    key_to_shard = {}
    for i in range(n_train):
        pair = rng.random() < pair_frac
        inst_objs, inst_poses = sample_image_instances(objs, rng, pair)
        rgb, depth, vis, full = render_composite(inst_objs, inst_poses)
        key = f"{i:08d}"
        key_to_shard[key] = 0
        base = os.path.join(shard, key)
        write_jpeg(base + ".rgb.jpg", rgb, quality=95)
        write_png(base + ".depth.png", depth)  # uint16 mm
        masks, gt, gt_info = {}, [], []
        for j, (o, pose, vm, fm) in enumerate(
            zip(inst_objs, inst_poses, vis, full)
        ):
            masks[str(j)] = encode_rle(vm)
            gt.append({
                "obj_id": o.obj_id,
                "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                "cam_t_m2c": pose[:3, 3].reshape(-1).tolist(),
            })
            gt_info.append({
                "px_count_valid": int(vm.sum()),
                "visib_fract": float(vm.sum() / max(fm.sum(), 1)),
            })
        with open(base + ".mask_visib.json", "w") as f:
            json.dump(masks, f)
        with open(base + ".gt.json", "w") as f:
            json.dump(gt, f)
        with open(base + ".gt_info.json", "w") as f:
            json.dump(gt_info, f)
        with open(base + ".camera.json", "w") as f:
            json.dump({"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}, f)
    with open(os.path.join(web, "key_to_shard.json"), "w") as f:
        json.dump(key_to_shard, f)


def build_banks(root, objs, level):
    """Test bank at --level; GSO training bank MUST be level 1 (162 views) —
    the training loader's nearest-view table is the reference's fixed
    level-1 icosphere (data/megapose.py, training_dataset.py:320-332).
    GSO depth & pose x10 (the loader's x0.1/1000 restores meters)."""
    bank_dir = os.path.join(root, "templates", DS)
    tdir = os.path.join(root, "mp", "MegaPose-Templates", "GSO")
    for o in objs:
        render_object_bank(o.cad_path, bank_dir, level=level, obj_id=o.obj_id)
        render_object_bank(o.cad_path, tdir, level=1, obj_id=o.obj_id)
        pose_p = os.path.join(tdir, "object_poses", f"{o.obj_id:06d}.npy")
        poses = np.load(pose_p).copy()
        poses[:, :3, 3] *= 10.0
        np.save(pose_p, poses)
        vdir = os.path.join(tdir, f"{o.obj_id:06d}")
        for fn in os.listdir(vdir):
            if fn.endswith("_depth.png"):
                p = os.path.join(vdir, fn)
                d = read_png(p).astype(np.float64) * 10.0
                write_png(p, np.clip(d, 0, 65535).astype(np.uint16))


def build(root: str, n_train: int, n_test: int, size: float, level: int,
          seed: int, mesh: str = "lshape", objects: list[str] | None = None,
          pair_frac: float = 0.0, n_scenes: int = 1) -> None:
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    rng = np.random.default_rng(seed)

    kinds = list(objects) if objects else [mesh]
    objs = build_objects(root, kinds, size)
    build_banks(root, objs, level)
    n_gt, n_targets = build_test_tree(
        root, objs, n_test, n_scenes, pair_frac, rng
    )
    build_train_tree(root, objs, n_train, pair_frac, rng)
    write_models_dir(root, objs)

    print(
        f"synthetic world at {root}: {n_train} train images / {n_test} test "
        f"images over {n_scenes} scene(s), {n_gt} GT instances "
        f"({n_targets} target rows), objects={kinds}, pair_frac={pair_frac}, "
        f"bank level {level}"
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="synthetic BOP + MegaPose world (PyTorch port)")
    ap.add_argument("--root", default="/tmp/synthetic_world")
    ap.add_argument("--train", type=int, default=128)
    ap.add_argument("--test", type=int, default=8)
    ap.add_argument("--size", type=float, default=60.0)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["lshape", "cube"], default="lshape")
    ap.add_argument("--objects", default="",
                    help="comma list from {lshape,tex,cube}; overrides --mesh")
    ap.add_argument("--pair_frac", type=float, default=0.0,
                    help="fraction of images with two overlapping instances")
    ap.add_argument("--scenes", type=int, default=1)
    args = ap.parse_args(argv)
    objects = [o for o in args.objects.split(",") if o] or None
    build(args.root, args.train, args.test, args.size, args.level, args.seed,
          args.mesh, objects=objects, pair_frac=args.pair_frac,
          n_scenes=args.scenes)


if __name__ == "__main__":
    main()
