"""The closed accuracy loop on synthetic data: world -> train -> eval -> AR.

    python -m picopose_tpu_torch.train_to_ar --root /tmp/ar_world --steps 1500 \
        --objects lshape,tex,cube --pair_frac 0.375 --scenes 4 --test_views 320

The port's counterpart of examples/train_to_ar.py, with the same flags plus
``--device`` (the card unless ``cpu`` is passed), which goes to every
training and evaluation run.  The runs read the repo's configs/base.yaml
and write under log/ in the working directory, as the port's CLIs do.  It
renders a synthetic world
(``python -m picopose_tpu_torch.synthetic_world``), trains a ViT-S PicoPose
from scratch on its training split (``python -m picopose_tpu_torch.run_train``),
evaluates the held-out test views (``python -m picopose_tpu_torch.run_test``)
five times: with random weights, trained (the faithful arm), and trained
under each serving mode (``PICOPOSE_MATCH_INT8=1``, ``model.stage3_topk=1``,
``model.quantize_stage3=true``), and scores each CSV with ``python -m
picopose_tpu_torch.score_csv --vsd --bootstrap 2000``, the serving-mode
arms paired against the faithful one.  A trained model must beat the
random weights by a wide AR margin.

Writes ``<root>/summary.json`` (the JAX example's keys), each arm's CSV,
score log and per-instance records under ``<root>``, and the seconds of
each stage to ``<root>/stage_seconds.json``; the world builder's log goes
to ``<root>_world.log`` (the builder replaces ``<root>``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "base.yaml")

HYP = 2  # also names run_test's CSV (see eval_and_score)
MODEL_ARGS = [
    "model.vit_type=dinov2_vits14",
    "model.blocks_to_take=[2,5,8,11]",
    "model.compute_dtype=float32",
    f"model.hypothesis={HYP}",
]
ARMS = (  # tag, config overrides, environment
    ("trained_int8", (), {"PICOPOSE_MATCH_INT8": "1"}),
    ("trained_topk1", ("model.stage3_topk=1",), None),
    ("trained_quant", ("model.quantize_stage3=true",), None),
)


def run(cmd, log_path, env=None) -> float:
    """Run ``cmd`` in the working directory, with the repo on the module
    path and its output in ``log_path``; returns its seconds, raises
    SystemExit with the log's tail on failure."""
    print("+", " ".join(cmd), f"(log: {log_path})", flush=True)
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    full_env = dict(os.environ, PYTHONPATH=path, **(env or {}))
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        rc = subprocess.call(cmd, stdout=f, stderr=subprocess.STDOUT, env=full_env)
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(open(log_path).read()[-4000:])
        raise SystemExit(f"command failed rc={rc}: {' '.join(cmd)}")
    return seconds


def module(name: str) -> list[str]:
    return [sys.executable, "-m", f"picopose_tpu_torch.{name}"]


def eval_and_score(args, root, version, tag, seconds, extra_set=(), env=None, paired_vs=None):
    """Evaluate ``version``'s checkpoint (random weights without one) on the
    world's BOP tree and score the CSV; returns score_csv's JSON."""
    csv_dir = os.path.join("log", "picopose", f"version_{version}", "fakeds_eval")
    seconds[f"eval_{tag}"] = run(
        [*module("run_test"), "--dataset", "fakeds", "--batch", "4", "--version_id", str(version),
         "--config", CONFIG, "--device", args.device, "--set",
         f"test_dataset.data_dir={root}/bop",
         f"test_dataset.template_dir={root}/templates",
         f"test_dataset.detection_dir={root}/dets",
         "test_dataset.n_template_view=42",
         *MODEL_ARGS, *extra_set],
        os.path.join(root, f"eval_{tag}.log"),
        env=env,
    )
    # every arm of one version writes the same CSV path: keep each arm's copy
    csv = os.path.join(root, f"csv_{tag}.csv")
    shutil.copyfile(os.path.join(csv_dir, f"picopose-stage3-{HYP}hyp_fakeds-test.csv"), csv)
    score_log = os.path.join(root, f"score_{tag}.log")
    # every arm dumps its per-GT-instance records; the serving-mode arms add
    # a paired bootstrap delta against the faithful arm (all arms score the
    # same instances)
    score_cmd = [*module("score_csv"), "--csv", csv, "--data_dir", f"{root}/bop", "--dataset", "fakeds",
                 "--vsd", "--bootstrap", "2000",
                 "--dump_records", os.path.join(root, f"records_{tag}.pkl")]
    if paired_vs is not None:
        score_cmd += ["--paired_vs", os.path.join(root, f"records_{paired_vs}.pkl")]
    seconds[f"score_{tag}"] = run(score_cmd, score_log)
    # score_csv ends with an indent=2 JSON object: parse from the last line that opens one
    text = open(score_log).read()
    starts = [i for i in range(len(text)) if text.startswith("{", i) and (i == 0 or text[i - 1] == "\n")]
    return json.loads(text[starts[-1]:])


def train(args, root, epochs) -> float:
    return run(
        [*module("run_train"), "--version_id", str(args.version), "--max_steps", str(args.steps),
         "--config", CONFIG, "--device", args.device, "--set",
         "trainer.iters_to_print=50",
         f"trainer.training_epoch={epochs}",
         # short synthetic epochs: the evaluation needs only the last checkpoint
         f"trainer.ckpt_every_epochs={max(1, epochs // 4)}",
         "trainer.n_devices=1",
         f"optimizer.lr={args.lr}",
         "optimizer.betas=[0.9,0.999]",
         f"lr_scheduler.max_iters={args.steps}",
         "lr_scheduler.warmup_iters=100",
         f"train_dataset.data_dir={root}/mp",
         "train_dataset.augment_real=false",
         f"train_dataloader.bs={args.bs}",
         "train_dataloader.num_workers=4",
         *MODEL_ARGS],
        os.path.join(root, "train.log"),
    )


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="synthetic world -> train -> eval -> AR (PyTorch port)")
    ap.add_argument("--root", default="/tmp/ar_world")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--train_views", type=int, default=128)
    ap.add_argument("--test_views", type=int, default=8)
    ap.add_argument("--objects", default="",
                    help="comma list from {lshape,tex,cube} for the world builder (empty = single lshape)")
    ap.add_argument("--pair_frac", type=float, default=0.0)
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--version", type=int, default=910)
    ap.add_argument("--skip_world", action="store_true", help="reuse an existing --root")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse --version's existing checkpoint; rerun only the eval arms + paired scoring")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the loop; returns the summary written to <root>/summary.json."""
    args = get_parser().parse_args(argv)
    root = os.path.abspath(args.root)
    seconds = {}

    if not args.skip_world:
        seconds["world"] = run(
            [*module("synthetic_world"), "--root", root, "--train", str(args.train_views),
             "--test", str(args.test_views), "--objects", args.objects,
             "--pair_frac", str(args.pair_frac), "--scenes", str(args.scenes)],
            root + "_world.log",
        )

    # 1. random-weights baseline (a version id with no checkpoints)
    os.makedirs(root, exist_ok=True)
    baseline = eval_and_score(args, root, args.version + 1, "random", seconds)
    print("random-init:", json.dumps(baseline), flush=True)

    # 2. train from scratch
    epochs = max(1, args.steps * args.bs // max(args.train_views, 1) + 1)
    if not args.skip_train:
        seconds["train"] = train(args, root, epochs)
        # the loop runs max_iters // training_epoch steps per epoch, so fewer
        # than --steps when the epochs do not divide them (as the JAX loop does)
        taken = epochs * (args.steps // epochs)
        seconds["train_steps"] = taken
        seconds["train_samples_per_s"] = taken * args.bs / seconds["train"]

    # 3. the trained checkpoint, faithful mode
    trained = eval_and_score(args, root, args.version, "trained", seconds)
    print("trained:", json.dumps(trained), flush=True)

    # 4. the serving modes on the same checkpoint, paired against the faithful arm
    arms = {}
    for tag, extra_set, env in ARMS:
        arms[tag] = eval_and_score(args, root, args.version, tag, seconds, extra_set=extra_set, env=env,
                                   paired_vs="trained")
        print(f"{tag}:", json.dumps(arms[tag]), flush=True)

    summary = {
        "steps": args.steps,
        "ar_random": baseline,
        "ar_trained": trained,
        "ar_trained_int8_matching": arms["trained_int8"],
        "ar_trained_stage3_topk1": arms["trained_topk1"],
        "ar_trained_quantize_stage3": arms["trained_quant"],
    }
    with open(os.path.join(root, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(root, "stage_seconds.json"), "w") as f:
        json.dump(seconds, f, indent=1)
    print(json.dumps(summary))
    print("stage seconds:", json.dumps(seconds), flush=True)
    return summary


if __name__ == "__main__":
    main()
