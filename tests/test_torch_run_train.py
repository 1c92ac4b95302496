"""The training CLI of the port, ``python -m picopose_tpu_torch.run_train
--device cpu``, at vit_tiny_test on the small MegaPose tree
(tests/torch_bop_tree.py::write_megapose_tree): 2 epochs of 2 real steps
with a checkpoint per epoch, then ``--resume``.  Every logged loss is
finite; the train-state files (~850 MB each) are removed afterwards.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_bop_tree import write_megapose_tree

from picopose_tpu_torch import run_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_megapose_tree(str(tmp_path_factory.mktemp("mp")))


def _lines(log_dir):
    with open(os.path.join(log_dir, "training_logger.log")) as f:
        return [line.split("] ", 1)[1].split(" |")[0] for line in f]


def test_cli_trains_saves_per_epoch_and_resumes(tree, tmp_path, monkeypatch, capsys):
    """``python -m picopose_tpu_torch.run_train --device cpu``: 2 epochs of 2
    steps (checkpoints at 2 and 4), then ``--resume`` (in this process):
    the epoch counter restarts at 0, one epoch to step 6, saved there."""
    args = ["--device", "cpu", "--config", os.path.join(ROOT, "configs", "base.yaml"), "--version_id", "3",
            "--set", f"train_dataset.data_dir={tree}", "train_dataset.min_px_count_visib=100",
            "trainer.training_epoch=3", "lr_scheduler.max_iters=6", "lr_scheduler.warmup_iters=2",
            "trainer.iters_to_print=2", "train_dataloader.bs=1", "train_dataloader.num_workers=1",
            "train_dataloader.backend=threads", "model.vit_type=vit_tiny_test",
            "model.blocks_to_take=[0,1,2,3]", "model.compute_dtype=float32"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    try:
        r = subprocess.run([sys.executable, "-m", "picopose_tpu_torch.run_train", "--max_steps", "4", *args],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "training on cpu" in r.stdout
        log_dir = tmp_path / "log" / "picopose" / "version_3"
        assert sorted(os.listdir(log_dir / "checkpoints")) == ["2.pt", "4.pt"]
        assert _lines(log_dir) == ["iter 2", "epoch 0 done at iter 2", "iter 4", "epoch 1 done at iter 4"]
        with open(log_dir / "training_logger.log") as f:
            losses = [float(t.split(": ")[1]) for line in f for t in line.split(" | ")[-1].split(", ")]
        assert losses and np.isfinite(losses).all()

        monkeypatch.chdir(tmp_path)
        assert run_train.main(["--resume", "--max_steps", "6", *args]) == os.path.join("log", "picopose", "version_3")
        assert "resumed from step 4" in capsys.readouterr().out
        assert sorted(os.listdir(log_dir / "checkpoints")) == ["2.pt", "4.pt", "6.pt"]
        assert _lines(log_dir)[4:] == ["iter 6", "epoch 0 done at iter 6"]
    finally:
        shutil.rmtree(tmp_path / "log", ignore_errors=True)
