"""The PyTorch port stands alone: it imports neither JAX, flax nor the JAX
package, nor the host libraries the JAX package reads images, configs and
checkpoints with (PIL, cv2, imageio, PyYAML, orbax, tensorstore, and the
zstd bindings zstandard and zstd), and its entry points never fall back to
the CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "picopose_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "picopose_tpu")
# host libraries of the JAX package that the port does without
HOST_LIBRARIES = ("PIL", "cv2", "imageio", "yaml", "orbax", "tensorstore", "zstandard", "zstd")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PACKAGE):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_import_nothing_of_jax():
    files = _port_files()
    assert len(files) > 15
    parallel = {"__init__.py", "distributed.py", "mesh.py", "shardings.py", "collectives.py"}
    assert parallel <= {os.path.basename(f) for f in files if os.sep + "parallel" + os.sep in f}
    bad = {
        (os.path.relpath(f, ROOT), r) for f in files for r in _imported_roots(f)
        if r in FORBIDDEN
    }
    assert not bad, bad


@pytest.mark.parametrize("library", HOST_LIBRARIES)
def test_port_files_import_no_host_library_of_the_jax_package(library):
    bad = {os.path.relpath(f, ROOT) for f in _port_files() if library in set(_imported_roots(f))}
    assert not bad, bad


@pytest.mark.parametrize("module", ["synthetic_world.py", "train_to_ar.py", "synthetic_demo.py", "serve_demo.py",
                                    "export_torch.py"])
def test_accuracy_loop_modules_import_neither_jax_nor_an_image_library(module):
    """The closed accuracy loop's world builder and loop, the demos and
    the exporter write and read their images and checkpoints with the
    port's own code."""
    path = os.path.join(PACKAGE, module)
    assert path in _port_files()
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN + HOST_LIBRARIES), roots


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, picopose_tpu_torch, picopose_tpu_torch.eval.pipeline, "
        "picopose_tpu_torch.utils.weights, picopose_tpu_torch.serve, "
        "picopose_tpu_torch.ops.preprocess, picopose_tpu_torch.ops.qconv, "
        "picopose_tpu_torch.utils.precast, picopose_tpu_torch.run_test, "
        "picopose_tpu_torch.eval.runner, picopose_tpu_torch.data.bop, picopose_tpu_torch.data.png, "
        "picopose_tpu_torch.utils.checkpoint, picopose_tpu_torch.utils.config, "
        "picopose_tpu_torch.utils.torch_export, picopose_tpu_torch.train.step, "
        "picopose_tpu_torch.train.loop, picopose_tpu_torch.train.keypoints, "
        "picopose_tpu_torch.train.losses, picopose_tpu_torch.train.augment, "
        "picopose_tpu_torch.geom.projection, picopose_tpu_torch.data.synthetic, "
        "picopose_tpu_torch.data.jpeg, picopose_tpu_torch.data.color_augment, "
        "picopose_tpu_torch.data.megapose, picopose_tpu_torch.geom.templates, "
        "picopose_tpu_torch.utils.logging, picopose_tpu_torch.run_train, "
        "picopose_tpu_torch.utils.graphs, picopose_tpu_torch.native.fastpath, "
        "picopose_tpu_torch.native.renderer, picopose_tpu_torch.render_templates, "
        "picopose_tpu_torch.score_csv, picopose_tpu_torch.eval.bop_scoring, "
        "picopose_tpu_torch.eval.metrics, picopose_tpu_torch.utils.profiling, "
        "picopose_tpu_torch.data.tiff, picopose_tpu_torch.parallel, "
        "picopose_tpu_torch.parallel.distributed, picopose_tpu_torch.parallel.mesh, "
        "picopose_tpu_torch.parallel.shardings, picopose_tpu_torch.parallel.collectives, "
        "picopose_tpu_torch.synthetic_world, picopose_tpu_torch.train_to_ar, "
        "picopose_tpu_torch.synthetic_demo, picopose_tpu_torch.serve_demo, picopose_tpu_torch.export_torch, "
        "picopose_tpu_torch.ops, picopose_tpu_torch.geom, picopose_tpu_torch.utils.orbax_read, "
        "picopose_tpu_torch.utils.ocdbt, picopose_tpu_torch.utils.zarr2, picopose_tpu_torch.native.codec; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + HOST_LIBRARIES!r}))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from picopose_tpu_torch import resolve_device
    from picopose_tpu_torch.models import PicoPose

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PicoPose("vit_tiny_test", (0, 1, 2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PicoPose("vit_tiny_test", (0, 1, 2, 3), device="cuda")
    model = PicoPose("vit_tiny_test", (0, 1, 2, 3), torch.float32, device="cpu")
    assert model.device.type == "cpu"
    assert next(model.parameters()).device.type == "cpu"


def test_training_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from picopose_tpu_torch.train import step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3), compute_dtype=torch.float32)
    tx = step.make_optimizer()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step.init_state(tx, device=device, **small)
    state = step.init_state(tx, device="cpu", **small)
    assert state.step == 0 and state.model.training and state.model.device.type == "cpu"
    opt = state.optimizer
    assert all(t.device.type == "cpu" for t in (*opt.params, *opt.tensors()))


def test_the_training_loop_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """run_training and run_train raise before reading any data."""
    from picopose_tpu_torch import run_train
    from picopose_tpu_torch.train.loop import run_training
    from picopose_tpu_torch.utils.config import load_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(None, ["train_dataset.data_dir=/nonexistent"])
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_training(cfg, "/nonexistent/log", device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train.main(["--set", "train_dataset.data_dir=/nonexistent"])


def test_importing_the_data_path_starts_no_cuda():
    """The loader's worker processes import these modules: no CUDA context
    and no kernel build on import."""
    code = (
        "import torch, picopose_tpu_torch.train.loop, picopose_tpu_torch.data.megapose; "
        "from picopose_tpu_torch import kernels; "
        "print(torch.cuda.is_initialized(), len(kernels._libs))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "False 0", out.stdout


def test_pose_estimator_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from picopose_tpu_torch.serve import PoseEstimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3), compute_dtype="float32")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PoseEstimator(**small, device=device)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        est = PoseEstimator(**small, device="cpu")
    assert est.device.type == "cpu" and est.generator.device.type == "cpu"
    assert next(est.model.parameters()).device.type == "cpu"


def _code_strings(path):
    """String constants of a file's code, its docstrings left out."""
    tree = ast.parse(open(path).read(), filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_port_files_name_neither_the_jax_native_directory_nor_its_library():
    """The port builds its own copies of the C++ sources (picopose_tpu_torch/
    native/csrc) and its own zstd decoder; its code names neither the
    top-level ``native/`` nor ``libpicopose_native.so``."""
    bad = set()
    for f in _port_files():
        for s in _code_strings(f):
            if "libpicopose_native" in s or s.rstrip("/") == "native" or s.startswith("native/"):
                bad.add((os.path.relpath(f, ROOT), s))
    assert not bad, bad
    sources = os.listdir(os.path.join(PACKAGE, "native", "csrc"))
    assert sorted(sources) == ["fastpath.cpp", "rasterizer.cpp", "zstd.cpp"]


def test_the_port_loads_its_own_host_library():
    """After a crop, an RLE decode and a render, the process maps the
    port's library and not the JAX package's, and has started no CUDA."""
    code = (
        "import numpy as np\n"
        "from picopose_tpu_torch.data import crops, rle\n"
        "from picopose_tpu_torch.native import renderer, CALLS\n"
        "crops.crop_and_normalize_rgb(np.zeros((8, 8, 3), np.uint8), (0, 8, 0, 8), 4)\n"
        "rle.rle_to_mask({'size': [2, 2], 'counts': [1, 2, 1]})\n"
        "renderer.render_views(np.eye(3, dtype=np.float32), None, np.array([[0, 1, 2]]), "
        "np.eye(4)[None], hw=(4, 4), n_threads=1)\n"
        "maps = open('/proc/self/maps').read()\n"
        "import torch\n"
        "print(sorted(CALLS), 'libpicopose_host-' in maps, 'libpicopose_native' in maps, "
        "torch.cuda.is_initialized())"
    )
    env = {k: v for k, v in os.environ.items() if k != "PICOPOSE_NO_FASTPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == ("['crop_resize_normalize', 'render_templates_tex', 'rle_counts_to_mask'] "
                                  "True False False"), out.stdout + out.stderr


def test_importing_the_host_entry_points_starts_no_cuda():
    """render_templates, score_csv and the renderer run on the host: their
    import does not even import torch, starts no CUDA context and builds
    nothing."""
    code = (
        "import sys, picopose_tpu_torch.render_templates, picopose_tpu_torch.score_csv, "
        "picopose_tpu_torch.native.renderer, picopose_tpu_torch.eval.bop_scoring, "
        "picopose_tpu_torch.eval.metrics, picopose_tpu_torch.utils.profiling, picopose_tpu_torch.data.tiff; "
        "no_torch = 'torch' not in sys.modules; "
        "import torch; from picopose_tpu_torch import kernels, native; "
        "print(no_torch, torch.cuda.is_initialized(), len(kernels._libs), native._lib)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "True False 0 None", out.stdout


def test_a_card_or_rank_beyond_those_present_raises(monkeypatch):
    """``cuda:N`` past the cards present raises, and under ``torchrun`` the
    rank's card is ``cuda:LOCAL_RANK``, which must exist; an nccl rank
    without its card raises before joining the group."""
    from picopose_tpu_torch import resolve_device
    from picopose_tpu_torch.parallel import distributed as pd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="cuda:1 requested but 1 CUDA device"):
        resolve_device("cuda:1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="cuda:1 requested"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    for k, v in dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="localhost").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but this host has 1"):
        pd.initialize()
    assert not pd.is_initialized()
