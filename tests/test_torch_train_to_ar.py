"""The port's closed accuracy loop (picopose_tpu_torch/train_to_ar.py) end to
end on the CPU at a tiny size: a one-object synthetic world written by
``python -m picopose_tpu_torch.synthetic_world``, two training steps of a
vit_tiny_test PicoPose through ``run_train``, the five evaluation arms
through ``run_test`` and their scores through ``score_csv``, all as
subprocesses.  The weights are barely trained, so the test holds the
loop's plumbing (every arm, every key, finite ARs in [0, 1], one CSV row
per detection), not its accuracy."""

import json
import math
import os

import pytest
import torch

from picopose_tpu_torch import train_to_ar

TINY_MODEL = ["model.vit_type=vit_tiny_test", "model.blocks_to_take=[0,1,2,3]",
              "model.compute_dtype=float32", f"model.hypothesis={train_to_ar.HYP}"]
ARMS = ("ar_random", "ar_trained", "ar_trained_int8_matching", "ar_trained_stage3_topk1",
        "ar_trained_quantize_stage3")
METRICS = ("AR_MSSD", "AR_MSPD", "AR_mssd_mspd", "AR_VSD", "AR_bop19")
TAGS = ("random", "trained", "trained_int8", "trained_topk1", "trained_quant")


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    work = tmp_path_factory.mktemp("ar")
    root = str(work / "world")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)  # the runs write log/ into the working directory
    mp.setattr(train_to_ar, "MODEL_ARGS", TINY_MODEL)
    # the runs are subprocesses: give them this process's share of the cores
    # (tests/torch_parity.py), not an OpenMP pool over all of them each
    mp.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    try:
        summary = train_to_ar.main(["--root", root, "--device", "cpu", "--steps", "2", "--bs", "2",
                                    "--train_views", "8", "--test_views", "2", "--objects", "lshape"])
    finally:
        mp.undo()
    yield root, summary
    # the train state files are large
    for d, _, names in os.walk(work / "log"):
        for n in names:
            if n.endswith(".pt"):
                os.remove(os.path.join(d, n))


def test_summary_has_every_arm_and_key(loop):
    root, summary = loop
    with open(os.path.join(root, "summary.json")) as f:
        assert json.load(f) == summary
    assert set(summary) == {"steps", *ARMS} and summary["steps"] == 2
    for arm in ARMS:
        r = summary[arm]
        assert r["n_gt"] == summary["ar_random"]["n_gt"] > 0
        for m in METRICS:
            assert math.isfinite(r[m]) and 0.0 <= r[m] <= 1.0, (arm, m, r[m])
            lo, hi = r["ci95"][m]
            assert 0.0 <= lo <= hi <= 1.0, (arm, m)
        paired = arm not in ("ar_random", "ar_trained")
        assert ("paired_delta_vs_baseline" in r) == paired, arm


def test_every_arm_writes_one_row_per_detection(loop):
    root, _ = loop
    with open(os.path.join(root, "dets", "fakeds.json")) as f:
        n_dets = len(json.load(f))
    assert n_dets > 0
    for tag in TAGS:
        with open(os.path.join(root, f"csv_{tag}.csv")) as f:
            rows = [line for line in f.read().splitlines() if line]  # no header
        assert len(rows) == n_dets, tag
        assert os.path.exists(os.path.join(root, f"records_{tag}.pkl")), tag


def test_stage_seconds_recorded(loop):
    root, _ = loop
    with open(os.path.join(root, "stage_seconds.json")) as f:
        seconds = json.load(f)
    assert {"world", "train", "train_samples_per_s"} <= set(seconds) and seconds["train_steps"] == 2
    assert all(f"eval_{t}" in seconds and f"score_{t}" in seconds for t in TAGS)
    assert all(v > 0 for v in seconds.values())
