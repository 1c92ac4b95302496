"""Configuration: dataclasses loaded from YAML with dotted overrides.

The port's own copy of picopose_tpu/utils/config.py (the ``Config``
dataclasses and ``load_config`` at :140-174), with the same fields and
defaults, so configs/base.yaml and ``a.b=value`` overrides mean the same in
both packages.  The port does not depend on PyYAML: the file is read by
``parse_yaml``, which reads the subset of YAML those files use:

  * block mappings nested by indentation, ``key: value`` or ``key:``
    followed by a more indented block;
  * ``#`` comments, on their own line or after a value;
  * plain scalars resolved as PyYAML's YAML 1.1 resolver resolves them:
    null (``~``, ``null``, nothing), bools (true/false, yes/no, on/off in
    lower, title and upper case), decimal ints and floats (a float has a
    dot: ``1e-5`` stays a string, as in PyYAML), anything else a string
    (YAML 1.1's octal, hex, sexagesimal and .inf/.nan forms are not read);
  * single- and double-quoted strings (no escapes but ``''`` and ``\\"``);
  * flow lists of such scalars, ``[1, 3, 5, 7]``.

Anything else (block lists, flow mappings, anchors, multi-line strings)
raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any

_BOOLS = {v: b for b, words in ((True, "yes true on"), (False, "no false off"))
          for w in words.split() for v in (w, w.title(), w.upper())}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)([eE][-+][0-9]+)?$")


def _strip_comment(text: str) -> str:
    """Drop a ``#`` comment that starts the text or follows a space, outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def parse_scalar(text: str) -> Any:
    """One YAML scalar or flow list of scalars (module docstring)."""
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [parse_scalar(x) for x in inner.split(",")] if inner else []
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return s[1:-1].replace('\\"', '"')
    if s[:1] in ("[", "{", "&", "*", "!", "|", ">", "'", '"') or s.startswith("- "):
        raise ValueError(f"YAML beyond the supported subset: {text!r}")
    if s in _NULLS:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    return s


def parse_yaml(text: str) -> dict:
    """A YAML document of nested block mappings -> dicts (module docstring)."""
    root: dict = {}
    stack: list[tuple[int, dict]] = []  # (indent, mapping) of the open blocks
    pending = None  # (mapping, key, indent) of a ``key:`` whose block may follow
    for n, line in enumerate(text.splitlines(), 1):
        body = _strip_comment(line).rstrip()
        if not body.strip() or body.strip() == "---":
            continue
        indent = len(body) - len(body.lstrip(" "))
        key, sep, value = body.strip().partition(":")
        if "\t" in body[: indent + 1] or not sep or not key or (value and value[0] != " "):
            raise ValueError(f"line {n}: expected 'key: value' in a block mapping, got {line!r}")
        if pending is not None and indent > pending[2]:
            mapping = pending[0][pending[1]] = {}
            stack.append((indent, mapping))
        else:
            while stack and indent < stack[-1][0]:
                stack.pop()
            if not stack and not root:
                stack.append((indent, root))
            if not stack or indent != stack[-1][0]:
                raise ValueError(f"line {n}: inconsistent indentation")
            mapping = stack[-1][1]
        key = key.strip()
        mapping[key] = parse_scalar(value) if value.strip() else None
        pending = None if value.strip() else (mapping, key, indent)
    return root


@dataclass
class TrainerConfig:
    rd_seed: int = 0
    training_epoch: int = 10
    iters_to_print: int = 100
    n_devices: int = -1  # -1: all local devices (the 'data' mesh axis)
    # parameter/optimizer sharding: ddp | fsdp | tp | fsdp_tp
    # (parallel/shardings.py; the reference is ddp-only, base.yaml:5-7)
    parallel: str = "ddp"
    n_model: int = 1  # size of the 'model' mesh axis (tp modes)
    # accumulate gradients over k micro-batches before each optimizer
    # step (optax.MultiSteps; 1 = off, the reference's behavior)
    grad_accum: int = 1
    # weight warm start before training: a full PicoPose checkpoint
    # (orbax step dir or reference .ckpt) or raw torch-hub DINOv2
    # backbone weights — the reference's stage1 `pretrained: True`
    # (train/loop.py::warm_start).  None = random init.
    init_checkpoint: str | None = None
    # checkpoint every N epochs (the final epoch always saves).  1 =
    # the reference's per-epoch cadence (save_top_k=-1, keep all); a
    # short-epoch run (synthetic overfit loops) pays ~10 s of orbax
    # save wait + ~0.7 GB disk PER EPOCH at cadence 1.
    ckpt_every_epochs: int = 1


@dataclass
class OptimizerConfig:
    type: str = "AdamW"
    lr: float = 1e-5
    betas: tuple[float, float] = (0.5, 0.999)
    eps: float = 1e-6
    weight_decay: float = 5e-4


@dataclass
class LRSchedulerConfig:
    type: str = "WarmupCosineLR"
    max_iters: int = 400_000
    warmup_factor: float = 1e-3
    warmup_iters: int = 1000


@dataclass
class ModelConfig:
    hypothesis: int = 5
    vit_type: str = "dinov2_vitl14"
    blocks_to_take: tuple[int, ...] = (5, 11, 17, 23)
    num_levels: int = 3
    radius: int = 4
    compute_dtype: str = "bfloat16"
    # opt-in serving speed mode: run stage 3 + PnP only on the top-k
    # MATCHING hypotheses (None = reference-faithful: all of them).
    # Changes hypothesis-ranking semantics — see eval/pipeline.py.
    stage3_topk: int | None = None
    # rematerialize ViT blocks in the backward pass: fits a batch-32
    # ViT-L training step in one 16 GB chip (18.3 GB without) for ~1
    # extra forward of FLOPs.  No effect on inference.
    remat_vit: bool = False
    # opt-in int8-MXU stage-3 convs (dynamic symmetric quantization,
    # ops/qconv.py).  ~1% conv-output error vs the reference's float
    # convs; OFF until A/B'd on real BOP data (same policy as
    # PICOPOSE_MATCH_INT8).
    quantize_stage3: bool = False
    # fused flow+mask XHead conv stacks (identical params/math, fewer
    # passes over the shared input — models/flow.py::_fused_xheads).
    # On by default; set false to run the reference-shaped unfused stacks.
    fuse_xheads: bool = True


@dataclass
class TrainDatasetConfig:
    data_dir: str = "data/MegaPose-Training-Data"
    img_size: int = 224
    min_visib_fract: float = 0.3
    min_px_count_visib: int = 1024
    rgb_mask_flag: bool = False
    augment_real: bool = True


@dataclass
class TestDatasetConfig:
    data_dir: str = "data/BOP_Datasets"
    template_dir: str = "data/BOP_Datasets/templates"
    detection_dir: str = "data/bop23_default_detections_for_task4/cnos-fastsam"
    img_size: int = 224
    minimum_n_point: int = 8
    rgb_mask_flag: bool = False
    seg_filter_score: float = 0.0
    n_template_view: int = 162
    pts_size: int = 64


@dataclass
class DataloaderConfig:
    bs: int = 8
    num_workers: int = 10
    shuffle: bool = True
    drop_last: bool = True
    # 'threads' (in-process pool, exactly reproducible stream), 'procs'
    # (worker processes producing whole collated batches — the scaling
    # backend for GIL-bound decode/augment, mirroring the reference's
    # DataLoader num_workers processes, config/base.yaml:55), or 'auto'
    # (default): procs when the host has the cores for it (>= 8, i.e. any
    # real TPU host — v5e-8 hosts have 112 vCPU), threads on small dev
    # boxes where process spin-up outweighs GIL relief.  Measured arms in
    # docs/DATA.md (tools/loader_bench.py).
    backend: str = "auto"


@dataclass
class Config:
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train_dataset: TrainDatasetConfig = field(default_factory=TrainDatasetConfig)
    test_dataset: TestDatasetConfig = field(default_factory=TestDatasetConfig)
    train_dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    test_dataloader: DataloaderConfig = field(
        default_factory=lambda: DataloaderConfig(bs=4, shuffle=False, drop_last=False)
    )


def _merge(dc: Any, data: dict) -> Any:
    if not dataclasses.is_dataclass(dc):
        return data
    names = {f.name: f for f in dataclasses.fields(dc)}
    updates = {}
    for k, v in (data or {}).items():
        if k not in names:
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[k] = _merge(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            updates[k] = tuple(v)
        else:
            updates[k] = v
    return dataclasses.replace(dc, **updates)


def load_config(path: str | None = None, overrides: list[str] | None = None) -> Config:
    """Load a YAML config and ``a.b.c=value`` overrides (the value a YAML
    scalar or flow list)."""
    cfg = Config()
    if path:
        with open(path) as f:
            cfg = _merge(cfg, parse_yaml(f.read()))
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        parts = key.strip().split(".")
        node: dict = {}
        leaf = node
        for p in parts[:-1]:
            leaf[p] = {}
            leaf = leaf[p]
        leaf[parts[-1]] = parse_scalar(val)
        cfg = _merge(cfg, node)
    return cfg
