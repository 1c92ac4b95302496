"""The port's renderer (picopose_tpu_torch/native/renderer.py, the C++
rasterizer, render_templates) and PNG writer against the JAX package's,
on the CPU.

Meshes: the cube PLY of tests/test_native.py (ascii and binary, vertex
colours) and the textured quad PLY / OBJ + MTL / GLB of
tests/test_textured_render.py.  The loaders give equal meshes; the
rasterizer is the same source built with the same compiler and flags, so
``render_views`` is bitwise the JAX one, textured or not; banks written by
``render_object_bank`` and ``python -m picopose_tpu_torch.render_templates``
decode (through PIL and through the port's ``read_png``) to the JAX
package's bank of the same mesh, with equal pose tables.  PNGs from
``write_png`` decode to the array written, in PIL and in ``read_png``.
Renders are small or few and use 1 or 2 threads.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image
from test_native import make_cube_ply
from test_textured_render import write_quad_glb, write_quad_obj, write_textured_ply

from picopose_tpu.geom.templates import template_object_poses as jax_object_poses
from picopose_tpu.native import renderer as J
from picopose_tpu_torch import native
from picopose_tpu_torch.data.png import encode_png, read_png, write_png
from picopose_tpu_torch.native import renderer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_SMALL = np.array([[143.1, 0, 80.0], [0, 143.4, 60.0], [0, 0, 1.0]], np.float32)  # TEMPLATES_K / 4


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """name -> path of each test mesh."""
    d = tmp_path_factory.mktemp("meshes")
    paths = {}
    for binary in (False, True):
        p = str(d / f"obj_00000{1 + binary}.ply")
        make_cube_ply(p, size=50.0, binary=binary)
        paths["cube_binary" if binary else "cube_ascii"] = p
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = [255, 0, 0]
    tex[:, 4:] = [0, 0, 255]
    tex[2:4, 1:7] = [20, 200, 40]
    Image.fromarray(tex).save(d / "tex.png")
    write_textured_ply(str(d / "quad.ply"), "tex.png")
    paths["quad_ply"] = str(d / "quad.ply")
    obj_dir = d / "obj"
    obj_dir.mkdir()
    paths["quad_obj"] = write_quad_obj(str(obj_dir))
    paths["quad_glb"] = str(d / "quad.glb")
    write_quad_glb(paths["quad_glb"])
    return paths


def _assert_meshes_equal(got, ref):
    for field in ("verts", "faces", "colors", "uv", "texture"):
        a, b = getattr(got, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if b is not None:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.diameter == ref.diameter


@pytest.mark.parametrize("name", ["cube_ascii", "cube_binary", "quad_ply", "quad_obj", "quad_glb"])
def test_loaders_give_the_jax_meshes(meshes, name):
    got, ref = T.load_mesh(meshes[name]), J.load_mesh(meshes[name])
    _assert_meshes_equal(got, ref)
    if name.startswith("quad"):
        assert got.texture is not None and got.uv is not None
    if name.endswith("ply"):
        for a, b in zip(T.load_ply(meshes[name]), J.load_ply(meshes[name])):
            np.testing.assert_array_equal(a, b)


def test_a_texture_the_port_cannot_read_raises_naming_it(tmp_path):
    """A BMP texture (imageio reads it; the port's decoder does not) raises,
    naming it; palette PNG and TIFF textures, which it once refused, load
    as imageio loads them (a PNG's RGB through its palette; a TIFF's
    indices, as imageio's tifffile reads it)."""
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, 4:] = [0, 0, 255]
    for name in ("pal.png", "pal.tif"):
        Image.fromarray(tex).convert("P").save(tmp_path / name)
        write_textured_ply(str(tmp_path / "obj.ply"), name)
        got, ref = T.load_ply_mesh(str(tmp_path / "obj.ply")), J.load_ply_mesh(str(tmp_path / "obj.ply"))
        assert got.texture.shape == (8, 8, 3)
        np.testing.assert_array_equal(got.texture, ref.texture)
    Image.fromarray(tex).save(tmp_path / "tex.bmp")
    write_textured_ply(str(tmp_path / "obj.ply"), "tex.bmp")
    assert J.load_ply_mesh(str(tmp_path / "obj.ply")).texture is not None
    with pytest.raises(NotImplementedError, match="tex.bmp"):
        T.load_ply_mesh(str(tmp_path / "obj.ply"))


def _poses(n, z=400.0, seed=0):
    """n camera-from-model poses at depth z, the first fronto-parallel."""
    from scipy.spatial.transform import Rotation

    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[1:, :3, :3] = Rotation.random(n - 1, random_state=seed).as_matrix()
    poses[:, :3, 3] = [3.0, -2.0, z]
    return poses


@pytest.mark.parametrize("name", ["cube_ascii", "quad_ply", "quad_obj", "quad_glb"])
@pytest.mark.parametrize("n_threads", [1, 2])
def test_render_views_is_bitwise_the_jax_one(meshes, name, n_threads):
    mesh = J.load_mesh(meshes[name])
    poses = _poses(5)
    kw = dict(K=K_SMALL, hw=(120, 160), n_threads=n_threads, uv=mesh.uv, texture=mesh.texture)
    native.reset_calls()
    rgba, depth = T.render_views(mesh.verts, mesh.colors, mesh.faces, poses, **kw)
    assert native.CALLS == {"render_templates_tex": 1}
    ref_rgba, ref_depth = J.render_views(mesh.verts, mesh.colors, mesh.faces, poses, **kw)
    assert rgba.shape == (5, 120, 160, 4) and depth.shape == (5, 120, 160) and depth.dtype == np.uint16
    np.testing.assert_array_equal(rgba, ref_rgba)
    np.testing.assert_array_equal(depth, ref_depth)
    assert (rgba[..., 3] > 0).sum() > 100 and depth.max() > 0


def test_render_at_template_size_and_cube_depth(meshes):
    """640x480 with TEMPLATES_K: the cube's front face at 375 mm at the
    centre pixel, as tests/test_native.py checks the JAX renderer."""
    v, c, f = T.load_ply(meshes["cube_ascii"])
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 400.0
    rgba, depth = T.render_views(v, c, f, pose[None], T.TEMPLATES_K, (480, 640), n_threads=2)
    ref = J.render_views(v, c, f, pose[None], J.TEMPLATES_K, (480, 640), n_threads=2)
    np.testing.assert_array_equal(rgba, ref[0])
    np.testing.assert_array_equal(depth, ref[1])
    assert abs(int(depth[0, 240, 320]) - 375) <= 1
    np.testing.assert_array_equal(T.TEMPLATES_K, J.TEMPLATES_K)


def _assert_banks_equal(got_dir, ref_dir, obj_id, n_views):
    for v in range(n_views):
        for suffix in ("", "_depth"):
            name = os.path.join(f"{obj_id:06d}", f"{v:06d}{suffix}.png")
            ref = np.asarray(Image.open(os.path.join(ref_dir, name)))
            pil = np.asarray(Image.open(os.path.join(got_dir, name)))
            ours = read_png(os.path.join(got_dir, name))
            assert pil.dtype == ref.dtype and pil.shape == ref.shape, name
            np.testing.assert_array_equal(pil, ref, err_msg=name)
            np.testing.assert_array_equal(ours, ref, err_msg=name)
    np.testing.assert_array_equal(np.load(os.path.join(got_dir, "object_poses", f"{obj_id:06d}.npy")),
                                  np.load(os.path.join(ref_dir, "object_poses", f"{obj_id:06d}.npy")))


def test_render_object_bank_is_the_jax_bank(meshes, tmp_path):
    """A textured OBJ's bank over six level-0 views, obj_id given."""
    table = jax_object_poses(0)[::7].copy()
    got = T.render_object_bank(meshes["quad_obj"], str(tmp_path / "port"), 0, table, obj_id=7, n_threads=2)
    ref = J.render_object_bank(meshes["quad_obj"], str(tmp_path / "jax"), 0, table, obj_id=7)
    np.testing.assert_array_equal(got, ref)
    _assert_banks_equal(str(tmp_path / "port"), str(tmp_path / "jax"), 7, len(table))
    rgba = read_png(str(tmp_path / "port" / "000007" / "000000.png"))
    assert rgba.shape == (480, 640, 4) and (rgba[..., 3] > 0).any()


def test_render_templates_cli_is_the_jax_bank(meshes, tmp_path):
    """The port's CLI with ``--models_dir`` (the cube PLY at level 0, 42
    views) and with ``--models_json``, ``--pose_table``, ``--start`` and
    ``--end`` (the second of two textured models, a GLB), against the JAX
    package's ``render_object_bank`` (what its CLI calls) on the same
    meshes."""
    models = tmp_path / "models"
    models.mkdir()
    os.link(meshes["cube_binary"], models / "obj_000002.ply")
    run = lambda *args: subprocess.run([sys.executable, "-m", "picopose_tpu_torch.render_templates", *args],
                                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    out = run("--models_dir", str(models), "--out_dir", str(tmp_path / "port"), "--level", "0")
    assert out.returncode == 0, out.stderr
    assert "obj_000002.ply: 42 views" in out.stdout and "ms per view: render" in out.stdout
    J.render_object_bank(str(models / "obj_000002.ply"), str(tmp_path / "jax"), 0)
    _assert_banks_equal(str(tmp_path / "port"), str(tmp_path / "jax"), 2, 42)

    spec = tmp_path / "models.json"
    spec.write_text(
        '[{"obj_id": 5, "cad_path": "%s"}, {"obj_id": 9, "cad_path": "%s"}]'
        % (meshes["quad_ply"], meshes["quad_glb"])
    )
    table = jax_object_poses(0)[:4]
    np.save(tmp_path / "table.npy", table)
    out = run("--models_json", str(spec), "--pose_table", str(tmp_path / "table.npy"), "--start", "1",
              "--end", "2", "--out_dir", str(tmp_path / "port_json"))
    assert out.returncode == 0, out.stderr
    assert sorted(os.listdir(tmp_path / "port_json")) == ["000009", "object_poses"]
    J.render_object_bank(meshes["quad_glb"], str(tmp_path / "jax_json"), 1, table, 9)
    _assert_banks_equal(str(tmp_path / "port_json"), str(tmp_path / "jax_json"), 9, 4)


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb", "rgba"])
@pytest.mark.parametrize("shape", [(1, 1), (17, 31), (64, 48)])
def test_png_writer_reads_back_in_pil_and_read_png(tmp_path, kind, shape):
    rng = np.random.default_rng(sum(shape))
    arr = {
        "grey8": lambda: rng.integers(0, 256, shape, dtype=np.uint8),
        "grey16": lambda: rng.integers(0, 65536, shape, dtype=np.uint16),
        "rgb": lambda: rng.integers(0, 256, shape + (3,), dtype=np.uint8),
        "rgba": lambda: rng.integers(0, 256, shape + (4,), dtype=np.uint8),
    }[kind]()
    path = str(tmp_path / "a.png")
    write_png(path, arr)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil, arr)
    ours = read_png(path)
    assert ours.dtype == arr.dtype and ours.shape == arr.shape
    np.testing.assert_array_equal(ours, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(arr)))), arr)


def test_png_writer_refuses_other_arrays():
    for arr in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError, match="cannot write"):
            encode_png(arr)
