"""The port's configuration (utils/config.py) against the JAX package's.

``load_config("configs/base.yaml", overrides)`` gives the same ``Config``
field by field as the JAX package's (which reads YAML with PyYAML), for
the overrides the repository's own tests and docs use; the port's reader
of the YAML subset gives ``yaml.safe_load``'s result on configs/base.yaml
and on each scalar form it supports, and raises on what it does not read.
Tolerance: none (equal values and types).
"""

import dataclasses
import os

import pytest
import yaml

from picopose_tpu.utils.config import load_config as jax_load_config
from picopose_tpu_torch.utils.config import Config, load_config, parse_scalar, parse_yaml

BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "base.yaml")

OVERRIDES = {
    "none": [],
    # tests/test_integration_io.py:174-181
    "integration_io": [
        "test_dataset.data_dir=/tmp/bop", "test_dataset.template_dir=/tmp/world/templates",
        "test_dataset.detection_dir=/tmp/world/dets", "test_dataset.n_template_view=6",
        "model.vit_type=dinov2_vits14", "model.blocks_to_take=[1,3,5,7]",
        "model.compute_dtype=float32", "model.hypothesis=2",
    ],
    "mixed": [
        "model.stage3_topk=2", "model.stage3_topk=null", "model.quantize_stage3=true",
        "optimizer.betas=[0.9, 0.95]", "optimizer.lr=0.0003", "test_dataset.seg_filter_score=0.2",
        "trainer.init_checkpoint='weights/model.ckpt'", "trainer.n_devices=-1", "nonexistent.key=1",
    ],
}


def test_base_yaml_reads_as_pyyaml_reads_it():
    text = open(BASE).read()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_load_config_equals_the_jax_package(name):
    got, ref = load_config(BASE, OVERRIDES[name]), jax_load_config(BASE, OVERRIDES[name])
    assert isinstance(got, Config)
    for section in dataclasses.fields(ref):
        a, b = getattr(got, section.name), getattr(ref, section.name)
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            assert type(va) is type(vb) and va == vb, (section.name, f.name, va, vb)


@pytest.mark.parametrize("text", [
    "0.", "0.00001", "1.0e-5", "1e-5", "-3", "+4", "0", "1_000", ".5", "-.5",
    "-1.5e+3", "1.5e3", "yes", "Off", "TRUE", "false", "~", "null", "", "none",
    "abc", "/tmp/x y", "'it''s'", '"q"', "[1,3,5,7]", "[0.5, 0.999]", "[]", "[a, 'b c', 3]",
])
def test_scalars_resolve_as_pyyaml_resolves_them(text):
    got, ref = parse_scalar(text), yaml.safe_load(text)
    assert type(got) is type(ref) and got == ref


def test_nesting_and_comments():
    text = "a:\n  b:\n    c: 1   # one\n  d: 'x # y'\n# top\ne:\nf: [1, 2] # list\n"
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: 1\n   b: 2\n", "a: {x: 1}\n", "a: &x 1\n", "a: |\n  t\n"])
def test_yaml_beyond_the_subset_raises(text):
    with pytest.raises(ValueError):
        parse_yaml(text)
