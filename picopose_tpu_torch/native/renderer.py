"""Template rendering: mesh loading (PLY/OBJ/GLB), the C++ rasterizer and
bank writing.

The port's copy of picopose_tpu/native/renderer.py: ``Mesh`` (:38),
``load_ply`` (:59), ``load_ply_mesh`` (:69), ``load_obj_mesh`` (:183),
``load_glb_mesh`` (:264), ``load_mesh`` (:355), ``render_views`` (:367),
``render_mesh_views`` (:435) and ``render_object_bank`` (:449), over the
port's own copy of the rasterizer (csrc/rasterizer.cpp, built by
native/__init__.py).  Textures decode through data/jpeg.py::decode_image
(every PNG, JPEG and TIFF variant PIL reads but those data/jpeg.py lists
as refused; palette PNGs through their palette, as imageio gives them)
where the JAX package uses imageio: a texture in another format raises,
naming the file.  Banks are
written with data/png.py::write_png in the reference's on-disk layout
({view:06d}.png RGBA, {view:06d}_depth.png 16-bit mm,
object_poses/{obj:06d}.npy), so they decode to the arrays of the JAX
package's banks of the same mesh.  ``make_cube_ply`` writes the
vertex-coloured cube the demos render (the JAX demos take theirs from
tests/test_native.py, which the port does not import).

For each CAD model the viewpoints are the icosphere poses at z = the
model's diameter, rendered as RGBA + depth at 640x480 with the fixed
template K (rendering/scripts/render_bop_templates.py's equivalent).

Mesh formats (reference coverage: Panda3D loads textured BOP PLYs via
call_panda3d.py:29-60; GSO/ShapeNet banks are rendered from OBJ/GLB CADs by
render_gso_templates.py:100-160 / render_shapenet_templates.py):
  * PLY ascii/binary: positions, vertex colors, per-vertex `texture_u/v`
    (or `s/t`) texcoords + `comment TextureFile <png>` texture reference;
  * OBJ + MTL: `v/vt/f`, fan triangulation, `map_Kd` diffuse texture;
  * GLB (binary glTF 2.0): POSITION / TEXCOORD_0 / indices accessors +
    baseColorTexture image (embedded buffer).
UVs are handed to the rasterizer per face corner (see csrc/rasterizer.cpp)
with the v axis flipped to image convention (v = 0 at the top row).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from picopose_tpu_torch.data.jpeg import decode_image
from picopose_tpu_torch.data.png import write_png
from picopose_tpu_torch.native import call, ptr
from picopose_tpu_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class Mesh:
    """A renderable mesh: positions + faces, optional vertex colors, and an
    optional UV-mapped texture (UVs per face corner, image convention)."""

    verts: np.ndarray                 # (V, 3) float32, model units
    faces: np.ndarray                 # (F, 3) int32
    colors: np.ndarray | None = None  # (V, 3) float32 in [0, 1]
    uv: np.ndarray | None = None      # (F, 3, 2) float32, v=0 at top
    texture: np.ndarray | None = None # (h, w, 3) uint8

    @property
    def diameter(self) -> float:
        radii = np.linalg.norm(self.verts - self.verts.mean(0), axis=1)
        return float(2.0 * radii.max())

TEMPLATES_K = np.array(
    [[572.4114, 0.0, 320.0], [0.0, 573.57043, 240.0], [0.0, 0.0, 1.0]],
    np.float32,
)  # call_panda3d.py:48-54


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """Minimal PLY loader (ascii + binary_little_endian), replacing trimesh.

    Returns (verts (V, 3) float32, colors (V, 3) float32 in [0,1] or None,
    faces (F, 3) int32).  For texture support use `load_ply_mesh`.
    """
    m = load_ply_mesh(path)
    return m.verts, m.colors, m.faces


def load_ply_mesh(path: str) -> Mesh:
    """Full PLY loader: positions, vertex colors, per-vertex texcoords
    (`texture_u/texture_v` or `s/t`, the BOP textured-CAD convention) and the
    `comment TextureFile <name>` texture reference resolved next to the PLY."""
    texture_file = None
    with open(path, "rb") as f:
        # ---- header
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        props: list[tuple[str, str]] = []
        while True:
            line = f.readline().strip().decode("ascii", "ignore")
            if line.startswith("comment") or line.startswith("obj_info"):
                parts = line.split()
                if len(parts) >= 3 and parts[1].lower() in (
                    "texturefile", "texture_file"
                ):
                    texture_file = parts[2]
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                props = []
                elements.append((name, int(cnt), props))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    props.append((parts[-1], f"list:{parts[2]}:{parts[3]}"))
                else:
                    props.append((parts[-1], parts[1]))
            elif line == "end_header":
                break

        np_types = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        }

        verts = colors = faces = vert_uv = None
        for name, cnt, props_ in elements:
            if name == "vertex":
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(cnt)]
                    arr = np.array(rows, dtype=np.float64)
                    names = [p[0] for p in props_]
                else:
                    dt = np.dtype([(p[0], "<" + np_types[p[1]]) for p in props_])
                    arr_s = np.frombuffer(f.read(cnt * dt.itemsize), dtype=dt)
                    names = list(dt.names)
                    arr = np.stack(
                        [arr_s[n].astype(np.float64) for n in names], axis=1
                    )
                ix = [names.index(c) for c in ("x", "y", "z")]
                verts = arr[:, ix].astype(np.float32)
                if all(c in names for c in ("red", "green", "blue")):
                    ic = [names.index(c) for c in ("red", "green", "blue")]
                    colors = (arr[:, ic] / 255.0).astype(np.float32)
                for u_name, v_name in (("texture_u", "texture_v"), ("s", "t")):
                    if u_name in names and v_name in names:
                        iuv = [names.index(u_name), names.index(v_name)]
                        vert_uv = arr[:, iuv].astype(np.float32)
                        break
            elif name == "face":
                tris = []
                if fmt == "ascii":
                    for _ in range(cnt):
                        vals = list(map(int, f.readline().split()))
                        k = vals[0]
                        for j in range(1, k - 1):  # fan-triangulate
                            tris.append((vals[1], vals[1 + j], vals[2 + j]))
                else:
                    list_spec = props_[0][1]  # "list:<count_t>:<idx_t>"
                    _, ct, it = list_spec.split(":")
                    ct_dt = np.dtype("<" + np_types[ct])
                    it_dt = np.dtype("<" + np_types[it])
                    for _ in range(cnt):
                        k = int(np.frombuffer(f.read(ct_dt.itemsize), ct_dt)[0])
                        idx = np.frombuffer(f.read(k * it_dt.itemsize), it_dt)
                        for j in range(1, k - 1):
                            tris.append((idx[0], idx[j], idx[j + 1]))
                faces = np.asarray(tris, dtype=np.int32)
    assert verts is not None and faces is not None, f"bad ply: {path}"

    uv = texture = None
    if vert_uv is not None and texture_file is not None:
        tex_path = os.path.join(os.path.dirname(path), texture_file)
        if os.path.exists(tex_path):
            texture = _load_texture_image(tex_path)
            # per-vertex -> per-corner; PLY texcoords use v=0 at the BOTTOM
            # (OpenGL convention, same as OBJ) -> flip to image convention
            uv = vert_uv[faces].copy()
            uv[..., 1] = 1.0 - uv[..., 1]
    return Mesh(verts=verts, faces=faces, colors=colors, uv=uv, texture=texture)


def _load_texture_image(path: str) -> np.ndarray:
    """Read a texture to (h, w, 3) uint8 RGB."""
    with open(path, "rb") as f:
        img = decode_image(f.read(), path, palette=True)
    if img.dtype != np.uint8:
        img = np.clip(
            img.astype(np.float64) / max(1.0, float(img.max()) / 255.0), 0, 255
        ).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_obj_mesh(path: str) -> Mesh:
    """Wavefront OBJ + MTL loader (GSO / ShapeNetCore CAD format; reference
    renders these via Panda3D — render_gso_templates.py:100-160).

    Supports v / vt / f (any polygon, fan-triangulated; v//vn and v/vt/vn
    index styles; negative indices) and the diffuse texture (`map_Kd`) of the
    first material that has one.  OBJ vt uses v=0 at the BOTTOM; flipped here
    to image convention for the rasterizer.
    """
    verts: list[list[float]] = []
    vts: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    face_uv_idx: list[tuple[int, int, int]] = []
    mtl_files: list[str] = []

    def _resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vts.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "mtllib":
                mtl_files.append(" ".join(parts[1:]))
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = _resolve(int(comp[0]), len(verts))
                    ti = (
                        _resolve(int(comp[1]), len(vts))
                        if len(comp) > 1 and comp[1]
                        else -1
                    )
                    corners.append((vi, ti))
                for j in range(1, len(corners) - 1):  # fan-triangulate
                    a, b, c = corners[0], corners[j], corners[j + 1]
                    faces.append((a[0], b[0], c[0]))
                    face_uv_idx.append((a[1], b[1], c[1]))

    v_arr = np.asarray(verts, np.float32)
    f_arr = np.asarray(faces, np.int32)

    texture = None
    for mtl in mtl_files:
        mtl_path = os.path.join(os.path.dirname(path), mtl)
        if not os.path.exists(mtl_path):
            continue
        with open(mtl_path, "r", errors="ignore") as f:
            for line in f:
                parts = line.split()
                if parts and parts[0] == "map_Kd":
                    tex_path = os.path.join(
                        os.path.dirname(mtl_path), " ".join(parts[1:])
                    )
                    if os.path.exists(tex_path):
                        texture = _load_texture_image(tex_path)
                        break
        if texture is not None:
            break

    uv = None
    if vts and texture is not None and all(
        all(t >= 0 for t in tri) for tri in face_uv_idx
    ):
        vt_arr = np.asarray(vts, np.float32)
        uv = vt_arr[np.asarray(face_uv_idx, np.int64)].copy()  # (F, 3, 2)
        uv[..., 1] = 1.0 - uv[..., 1]
    return Mesh(verts=v_arr, faces=f_arr, uv=uv, texture=texture)


_GLTF_CTYPE = {5120: "i1", 5121: "u1", 5122: "i2", 5123: "u2", 5125: "u4", 5126: "f4"}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def load_glb_mesh(path: str) -> Mesh:
    """Minimal binary glTF 2.0 loader: merges all triangle primitives'
    POSITION / TEXCOORD_0 / indices; takes the first baseColorTexture image
    (embedded PNG/JPEG decoded by data/jpeg.py::decode_image).  Enough for GSO-style single-
    object CADs; not a general glTF implementation (no sparse accessors,
    external buffers, or node transforms)."""
    with open(path, "rb") as f:
        magic, _ver, _total = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67, f"not a glb file: {path}"
        gltf = None
        bin_chunk = b""
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            clen, ctype = struct.unpack("<II", hdr)
            data = f.read(clen)
            if ctype == 0x4E4F534A:  # 'JSON'
                gltf = json.loads(data)
            elif ctype == 0x004E4942:  # 'BIN'
                bin_chunk = data
    assert gltf is not None, f"glb missing JSON chunk: {path}"

    def read_accessor(idx: int) -> np.ndarray:
        acc = gltf["accessors"][idx]
        bv = gltf["bufferViews"][acc["bufferView"]]
        n = _GLTF_NCOMP[acc["type"]]
        dt = np.dtype("<" + _GLTF_CTYPE[acc["componentType"]])
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        count = acc["count"]
        stride = bv.get("byteStride", 0) or n * dt.itemsize
        if stride == n * dt.itemsize:
            out = np.frombuffer(bin_chunk, dt, count * n, offset).reshape(count, n)
        else:  # interleaved
            raw = np.frombuffer(
                bin_chunk, np.uint8, count * stride, offset
            ).reshape(count, stride)
            out = raw[:, : n * dt.itemsize].copy().view(dt).reshape(count, n)
        return out

    all_v, all_f, all_vt = [], [], []
    tex_index = None
    base = 0
    for mesh in gltf.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            pos = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = read_accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            tris = idx.reshape(-1, 3)
            all_v.append(pos)
            all_f.append(tris + base)
            if "TEXCOORD_0" in prim["attributes"]:
                vt = read_accessor(prim["attributes"]["TEXCOORD_0"]).astype(np.float32)
                all_vt.append(vt)
            if tex_index is None and "material" in prim:
                mat = gltf["materials"][prim["material"]]
                pbr = mat.get("pbrMetallicRoughness", {})
                if "baseColorTexture" in pbr:
                    tex_index = pbr["baseColorTexture"]["index"]
            base += len(pos)

    verts = np.concatenate(all_v, axis=0)
    faces = np.concatenate(all_f, axis=0).astype(np.int32)

    texture = uv = None
    if tex_index is not None:
        img_idx = gltf["textures"][tex_index]["source"]
        img = gltf["images"][img_idx]
        if "bufferView" in img:
            bv = gltf["bufferViews"][img["bufferView"]]
            off = bv.get("byteOffset", 0)
            blob = bin_chunk[off : off + bv["byteLength"]]
            decoded = decode_image(blob, f"{path} (image {img_idx})", palette=True)
            if decoded.ndim == 2:
                decoded = np.stack([decoded] * 3, axis=-1)
            texture = np.ascontiguousarray(decoded[..., :3].astype(np.uint8))
    if texture is not None and all_vt and len(all_vt) == len(all_v):
        vt_all = np.concatenate(all_vt, axis=0)
        # glTF UV origin is TOP-left already — no v flip
        uv = vt_all[faces.astype(np.int64)].astype(np.float32)
    return Mesh(verts=verts, faces=faces, uv=uv, texture=texture)


def load_mesh(path: str) -> Mesh:
    """Load a CAD by extension: .ply (BOP), .obj (GSO/ShapeNet), .glb/.gltf."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply_mesh(path)
    if ext == ".obj":
        return load_obj_mesh(path)
    if ext in (".glb", ".gltf"):
        return load_glb_mesh(path)
    raise ValueError(f"unsupported mesh format {ext!r}: {path}")


def _threads(n_threads: int) -> int:
    """``n_threads``, or min(16, cores) when it is 0 or less."""
    return int(n_threads) if n_threads > 0 else min(16, os.cpu_count() or 1)


def render_views(
    verts: np.ndarray,
    colors: np.ndarray | None,
    faces: np.ndarray,
    poses: np.ndarray,
    K: np.ndarray = TEMPLATES_K,
    hw: tuple[int, int] = (480, 640),
    n_threads: int = 0,
    uv: np.ndarray | None = None,
    texture: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Rasterize (N, 4, 4) camera-from-model poses -> (rgba (N, H, W, 4)
    uint8, depth (N, H, W) uint16 mm).

    When `uv` ((F, 3, 2) per-corner texcoords, v=0 top) and `texture`
    ((h, w, 3) uint8) are given, faces are textured (perspective-correct
    bilinear sampling); otherwise vertex `colors` / neutral albedo apply.
    """
    H, W = hw
    N = len(poses)
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    poses = np.ascontiguousarray(poses, np.float32)
    Kc = np.ascontiguousarray(K, np.float32)
    rgba = np.zeros((N, H, W, 4), np.uint8)
    depth = np.zeros((N, H, W), np.uint16)
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.float32)
    tex_w = tex_h = 0
    if uv is not None and texture is not None:
        assert uv.shape == (len(faces), 3, 2), uv.shape
        uv = np.ascontiguousarray(uv, np.float32)
        texture = np.ascontiguousarray(texture, np.uint8)
        assert texture.ndim == 3 and texture.shape[2] == 3, texture.shape
        tex_h, tex_w = texture.shape[:2]
    else:
        uv = texture = None
    call(
        "render_templates_tex", ptr(verts), ptr(colors), len(verts), ptr(faces), len(faces),
        ptr(uv), ptr(texture), tex_w, tex_h, ptr(Kc), ptr(poses), N, W, H, _threads(n_threads),
        ptr(rgba), ptr(depth),
    )
    return rgba, depth


def render_mesh_views(
    mesh: Mesh,
    poses: np.ndarray,
    K: np.ndarray = TEMPLATES_K,
    hw: tuple[int, int] = (480, 640),
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """`render_views` over a loaded `Mesh` (texture-aware)."""
    return render_views(
        mesh.verts, mesh.colors, mesh.faces, poses, K=K, hw=hw,
        n_threads=n_threads, uv=mesh.uv, texture=mesh.texture,
    )


def make_cube_ply(path: str, size: float = 50.0) -> tuple[np.ndarray, list]:
    """Write a cube of side ``size`` (mm) centred at the origin, with
    vertex colours, as an ascii PLY: the bytes the JAX package's demos
    write (their cube comes from tests/test_native.py::make_cube_ply).
    Returns (verts, faces)."""
    s = size / 2
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float32)
    colors = ((verts / size + 0.5) * 255).astype(np.uint8)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [tri for a, b, c, d in quads for tri in ((a, b, c), (a, c, d))]
    hdr = [
        "ply",
        "format ascii 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        for v, c in zip(verts, colors):
            f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n".encode())
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())
    return verts, faces


def render_object_bank(
    cad_path: str,
    out_dir: str,
    level: int = 1,
    pose_table: np.ndarray | None = None,
    obj_id: int | None = None,
    n_threads: int = 0,
    timer=None,
) -> np.ndarray:
    """Render one CAD's template bank in the reference layout.

    Viewpoints: icosphere level poses with z set to the model diameter
    (render_bop_templates.py:104-115).  Returns the (N, 4, 4) pose table
    written to object_poses/<obj>.npy (mm units, like the reference banks).
    ``n_threads`` as ``render_views``'s, also the threads that write the
    PNGs (the JAX package writes them one after another); ``timer``, a
    utils/profiling.py::StageTimer, gets the sections "load", "render" and
    "write".
    """
    from picopose_tpu_torch.geom.templates import template_object_poses

    timer = timer or StageTimer()
    with timer.section("load"):
        mesh = load_mesh(cad_path)
    diameter = mesh.diameter

    poses = (
        pose_table.copy()
        if pose_table is not None
        else template_object_poses(level).copy()
    )
    poses[:, :3, 3] *= diameter / 1000.0  # table radius 1000 -> diameter

    with timer.section("render"):
        rgba, depth = render_mesh_views(mesh, poses, n_threads=n_threads)

    if obj_id is None:
        obj_id = int(os.path.splitext(os.path.basename(cad_path))[0].split("_")[-1])
    vdir = os.path.join(out_dir, f"{obj_id:06d}")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "object_poses"), exist_ok=True)
    with timer.section("write"), ThreadPoolExecutor(_threads(n_threads)) as pool:  # zlib releases the GIL
        jobs = [pool.submit(write_png, os.path.join(vdir, f"{v:06d}{suffix}.png"), img[v])
                for v in range(len(poses)) for suffix, img in (("", rgba), ("_depth", depth))]
        np.save(os.path.join(out_dir, "object_poses", f"{obj_id:06d}.npy"), poses)
        for job in jobs:
            job.result()
    return poses
