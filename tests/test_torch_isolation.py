"""The PyTorch port stands alone: it imports neither JAX, flax nor the JAX
package, nor the host libraries the JAX package reads images, configs and
checkpoints with (PIL, cv2, imageio, PyYAML, orbax), and its entry points
never fall back to the CPU on their own."""

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
HOST_LIBRARIES = ("PIL", "cv2", "imageio", "yaml", "orbax")


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
    bad = {
        (os.path.relpath(f, ROOT), r) for f in files for r in _imported_roots(f)
        if r in FORBIDDEN
    }
    assert not bad, bad


@pytest.mark.parametrize("library", HOST_LIBRARIES)
def test_port_files_import_no_host_library_of_the_jax_package(library):
    bad = {os.path.relpath(f, ROOT) for f in _port_files() if library in set(_imported_roots(f))}
    assert not bad, bad


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
        "picopose_tpu_torch.utils.graphs; "
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
