"""The port's compiled inference programs (utils/graphs.py) on the CPU.

On the CPU a ``GraphCache`` calls its function (there are no graphs), so
``run_batch_graphed``, ``build_bank_graphed`` and
``preprocess_frame_graphed`` equal the eager functions bitwise from equal
generator states; these tests hold them to that, show that
``PoseEstimator`` and ``evaluate_dataset`` route through them (the
cache's call counts), that the runner takes the eager ``run_batch`` when
given ``pnp_draws``, and that the cache key separates what selects a
program.  The JAX side is reached through the eager functions, which
tests/test_torch_run_batch.py, test_torch_serve.py and
test_torch_eval_runner.py hold against the JAX package.  Capture,
replay, aliasing, bank swaps, launch counts and generator states on the
card are in tests/test_torch_kernels.py.

Small size: vit_tiny_test (4 blocks, width 128), fp32, 6 template views,
2 queries, 2 hypotheses, 8 PnP iterations.
"""

import csv

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from test_torch_serve import BLOBS, K, blob
from torch_bop_tree import write_bop_tree
from torch_parity import SMALL

from picopose_tpu_torch import serve as SV
from picopose_tpu_torch.data.bop import BOPTestDataset
from picopose_tpu_torch.eval import pipeline as P
from picopose_tpu_torch.eval import runner as R
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.ops.pnp import SAMPLE, SCORE_SUBSET, draw_samples
from picopose_tpu_torch.ops.preprocess import preprocess_frame, preprocess_frame_graphed
from picopose_tpu_torch.utils import graphs as G
from picopose_tpu_torch.utils.graphs import GraphCache, module_key
from picopose_tpu_torch.utils.precast import precast_inference_params
from picopose_tpu_torch.utils.weights import init_random_

HYP, ITERS, VIEWS = 2, 8, 6


def _bank_arrays(rng, n=VIEWS):
    eye = lambda k: np.tile(np.eye(k, dtype=np.float32), (n, 1, 1))
    pose = eye(4)
    pose[:, 2, 3] = 0.5
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(rng.normal(size=(n, 224, 224, 3))), f32(rng.random((n, 224, 224)) > 0.3),
            f32(rng.normal(size=(n, 64, 64, 3)) + [0, 0, 1]), pose, f32(eye(3) * [300, 300, 1]), eye(3))


def _batch(rng, B=2):
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    return {
        "real_rgb": torch.from_numpy(rng.normal(size=(B, 224, 224, 3)).astype(np.float32)),
        "real_mask": torch.from_numpy((rng.random((B, 224, 224)) > 0.3).astype(np.float32)),
        "real_M": torch.from_numpy(M),
        "real_K": torch.from_numpy(np.tile(K, (B, 1, 1))),
    }


@pytest.fixture(scope="module")
def world():
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    init_random_(model, 0)
    rng = np.random.default_rng(3)
    arrays = _bank_arrays(rng)
    return model, arrays, P.build_bank(model, *arrays, chunk=4), _batch(rng)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("stage3_topk", [None, 1], ids=["all", "topk1"])
def test_run_batch_graphed_equals_run_batch_on_the_cpu(world, stage3_topk):
    model, _, bank, batch = world
    graphs = GraphCache("cpu")
    args = (model, batch, bank, HYP, ITERS, stage3_topk)
    got = P._ranked_graphed(graphs, *args, torch.Generator().manual_seed(4))
    ref = P._ranked(*args, torch.Generator().manual_seed(4), None)
    _equal(got[0], ref[0])
    _equal(got[1:], ref[1:])
    assert got[1].shape == got[2].shape == (2, HYP)
    _equal(P.run_batch_graphed(graphs, *args, torch.Generator().manual_seed(4)), ref[0])
    assert dict(graphs.calls) == {"run_batch": 2} and not graphs.captures and not graphs.replays


def test_build_bank_graphed_equals_build_bank_on_the_cpu(world):
    model, arrays, bank, _ = world
    graphs = GraphCache("cpu")
    got = P.build_bank_graphed(graphs, model, *arrays, chunk=4)
    _equal(got.feats + got.dpt + got[1:6], bank.feats + bank.dpt + bank[1:6])
    assert dict(graphs.calls) == {"bank_chunk": 2}  # 6 views in chunks of 4


def test_preprocess_frame_graphed_equals_preprocess_frame_on_the_cpu():
    rng = np.random.default_rng(5)
    frame = torch.from_numpy(rng.integers(0, 256, size=(120, 160, 3), dtype=np.uint8))
    masks = torch.from_numpy(np.stack([blob(*b) for b in BLOBS]).astype(np.uint8))
    graphs = GraphCache("cpu")
    got = preprocess_frame_graphed(graphs, frame, masks, out=64, pts=16)
    ref = preprocess_frame(frame, masks, out=64, pts=16)
    assert got.keys() == ref.keys()
    _equal(got.values(), ref.values())
    assert dict(graphs.calls) == {"preprocess_frame": 1}


def _spy(monkeypatch, graphs):
    """Record the key each ``graphs.run`` call would have on the card."""
    keys = []

    def run(name, fn, args, static=(), slot=None, generator=None, module=None):
        flat_slot = None if slot is None else pytree.tree_flatten(slot)
        keys.append(G._key(name, static, pytree.tree_flatten(args), flat_slot, generator, module))
        return None, None, None

    monkeypatch.setattr(graphs, "run", run)
    return keys


VARIANTS = {
    "hyp": dict(hyp=3),
    "pnp_iters": dict(pnp_iters=ITERS + 1),
    "stage3_topk": dict(stage3_topk=1),
    "batch_size": dict(B=3),
    "dtype": dict(dtype=torch.float64),
    "match_int8": dict(env="PICOPOSE_MATCH_INT8"),
    "match_fp32": dict(env="PICOPOSE_MATCH_FP32"),
    "quantize_stage3": dict(quantize=True),
    "generator": dict(generator=torch.Generator()),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cache_key_separates_what_selects_a_program(world, monkeypatch, variant):
    """Each static argument, input shape and dtype, serving mode and the
    generator select their own program; new values of the same shapes
    replay the same one."""
    model, _, bank, _ = world
    graphs = GraphCache("cpu")
    keys = _spy(monkeypatch, graphs)
    gen = torch.Generator()
    rng = np.random.default_rng(6)
    base = dict(hyp=HYP, pnp_iters=ITERS, stage3_topk=None, generator=gen)
    P.run_batch_graphed(graphs, model, _batch(rng), bank, **base)
    P.run_batch_graphed(graphs, model, _batch(rng), bank, **base)  # other values, same shapes
    v = dict(VARIANTS[variant])
    batch = _batch(rng, v.pop("B", 2))
    if "dtype" in v:
        batch["real_rgb"] = batch["real_rgb"].to(v.pop("dtype"))
    if "env" in v:
        monkeypatch.setenv(v.pop("env"), "1")
    quantize = v.pop("quantize", False)
    monkeypatch.setattr(model.flow_decoder, "quantize", quantize)
    P.run_batch_graphed(graphs, model, batch, bank, **{**base, **v})
    assert keys[0] == keys[1] and keys[2] != keys[0]


def test_cache_key_separates_decoders_of_other_radii(world, monkeypatch):
    """A model whose flow decoder has another radius or level count gets a
    program of its own, even where its parameters would sit at the radius-4
    model's addresses (the module keys made equal here)."""
    model, _, bank, batch = world
    graphs = GraphCache("cpu")
    keys = _spy(monkeypatch, graphs)
    monkeypatch.setattr(G, "module_key", lambda module: ("same addresses",))
    for kw in ({}, {"radius": 8}, {"radius": 6, "num_levels": 3}, {"radius": 4, "num_levels": 2}):
        other = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", **kw) if kw else model
        P.run_batch_graphed(graphs, other.eval(), batch, bank, hyp=HYP, pnp_iters=ITERS)
    assert len(set(keys)) == 4


def test_cache_key_follows_the_bank_shape_not_its_values(world, monkeypatch):
    model, arrays, bank, batch = world
    graphs = GraphCache("cpu")
    keys = _spy(monkeypatch, graphs)
    other = P.build_bank(model, *(a[::-1].copy() for a in arrays), chunk=4)
    smaller = P.build_bank(model, *(a[:4] for a in arrays), chunk=4)
    for b in (bank, other, smaller):
        P.run_batch_graphed(graphs, model, batch, b, hyp=HYP, pnp_iters=ITERS)
    assert keys[0] == keys[1] != keys[2]


def test_module_key_follows_reassigned_parameters():
    """precast re-assigns the bf16-consumed weights (a new capture); an
    in-place copy into the parameters keeps the key (replays see it)."""
    model = PicoPose(**SMALL, compute_dtype=torch.bfloat16, device="cpu")
    before = module_key(model)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.ones_like(p))
    assert module_key(model) == before
    precast_inference_params(model)
    assert module_key(model) != before
    model.train()
    assert module_key(model)[0] is True


def test_graph_cache_on_the_cpu_calls_the_function():
    graphs = GraphCache("cpu")
    x, slot = torch.arange(3.0), {"w": torch.full((3,), 2.0)}
    out = graphs.run("f", lambda a, s: {"y": a * s["w"]}, (x,), static=(1,), slot=slot)
    assert torch.equal(out["y"], x * 2)
    assert graphs.run("g", lambda a: a, (x,)) is x  # no copy, no clone: the eager call itself
    assert dict(graphs.calls) == {"f": 1, "g": 1} and not graphs.captures and not graphs.replays


@pytest.fixture(scope="module")
def estimator(world):
    model, arrays, bank, _ = world
    with pytest.warns(UserWarning, match="RANDOM weights"):
        est = SV.PoseEstimator(**SMALL, compute_dtype="float32", hyp=HYP, pnp_iters=ITERS, max_batch=2,
                               device="cpu")
    est.model.load_state_dict(model.state_dict())
    est.register_bank(1, bank)
    return est


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host_crops", "device_crops"])
def test_estimate_routes_through_the_graphed_programs(world, estimator, device_preprocess):
    """One chunk of 2 detections: one run_batch program (and one
    preprocess_frame program with on-device crops), its best poses the
    eager ``run_batch``'s on the same batch from the same generator
    state."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, size=(120, 160, 3), dtype=np.uint8)
    dets = [{"obj_id": 1, "mask": blob(*BLOBS[i])} for i in range(2)]
    estimator.graphs = GraphCache("cpu")
    estimator.device_preprocess = device_preprocess
    estimator.generator = torch.Generator().manual_seed(9)
    try:
        res = estimator.estimate(frame, K, dets)
    finally:
        estimator.device_preprocess = False
    calls = {"run_batch": 1, **({"preprocess_frame": 1} if device_preprocess else {})}
    assert dict(estimator.graphs.calls) == calls
    make = estimator._device_batch if device_preprocess else estimator._host_batch
    out = P.run_batch(world[0], make(frame, K, dets, 0), estimator._banks[1], hyp=HYP, pnp_iters=ITERS,
                      generator=torch.Generator().manual_seed(9))
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r.R, out.R[i, 0].numpy())
        np.testing.assert_array_equal(r.t, out.t[i, 0].numpy())
        assert r.score == out.inlier_ratio[i, 0].item() and r.template_score == out.template_score[i, 0].item()


def test_register_object_builds_the_bank_through_the_chunk_programs(world, estimator, monkeypatch):
    model, arrays, bank, _ = world
    names = ("tem_rgb", "tem_mask", "tem_pts3d", "tem_pose", "tem_K", "tem_M")
    monkeypatch.setattr(SV, "load_template_views", lambda *a: dict(zip(names, arrays)))
    estimator.graphs = GraphCache("cpu")
    estimator.register_object(5, "unused")
    got = estimator._banks.pop(5)
    _equal(got.feats + got.dpt + got[1:6], bank.feats + bank.dpt + bank[1:6])
    assert dict(estimator.graphs.calls) == {"bank_chunk": 1}  # 6 views, chunks of 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_bop_tree(str(tmp_path_factory.mktemp("bop")), n_views=VIEWS)


@pytest.fixture(scope="module")
def template_views():
    """``load_template_views`` decoding each object's views once for the
    module's runs (the banks are still built in each run, through the
    chunk programs)."""
    real, decoded = R.load_template_views, {}

    def load(*args):
        if args not in decoded:
            decoded[args] = real(*args)
        return decoded[args]

    return load


def _evaluate(world, tree, template_views, path, monkeypatch, **kw):
    """The run's CSV rows and the ``GraphCache`` it made."""
    ds = BOPTestDataset(tree["data_dir"], "fakeds", tree["det_path"], n_template_view=VIEWS)
    made = []
    monkeypatch.setattr(R, "load_template_views", template_views)
    monkeypatch.setattr(R, "GraphCache", lambda dev: made.append(GraphCache(dev)) or made[-1])
    R.evaluate_dataset(world[0], ds, tree["template_dir"], path, hyp=HYP, batch_size=2, pnp_iters=ITERS,
                       progress=False, decode_workers=2, **kw)
    (graphs,) = made
    with open(path) as f:
        return [row[:6] for row in csv.reader(f)], graphs


def test_evaluate_dataset_routes_through_the_graphed_programs(world, tree, template_views, tmp_path, monkeypatch):
    """Every batch goes through ``run_batch_graphed`` and every bank
    through the chunk programs (their equality with the eager functions
    is shown above); the CSV holds a rotation per detection."""
    rows, graphs = _evaluate(world, tree, template_views, str(tmp_path / "graphed.csv"), monkeypatch,
                             generator=torch.Generator().manual_seed(2))
    assert graphs.calls["bank_chunk"] == 2 and graphs.calls["run_batch"] >= 2  # two objects, 6 views each
    assert len(rows) > 1
    for row in rows[1:]:
        Rm = np.array(row[4].split(), float).reshape(3, 3)
        np.testing.assert_allclose(Rm @ Rm.T, np.eye(3), atol=1e-4)


def test_runner_with_pnp_draws_takes_the_eager_route(world, tree, template_views, tmp_path, monkeypatch):
    seen = []

    def draws(valid):
        seen.append(valid.shape)
        return draw_samples(valid, ITERS, SAMPLE, SCORE_SUBSET, torch.Generator().manual_seed(1))

    rows, graphs = _evaluate(world, tree, template_views, str(tmp_path / "draws.csv"), monkeypatch,
                             pnp_draws=draws)
    assert seen and "run_batch" not in graphs.calls and graphs.calls["bank_chunk"] == 2
    assert len(rows) > 1


def test_runner_on_the_models_own_device_keeps_the_callers_generator(world, tree, template_views, tmp_path,
                                                                     monkeypatch):
    """``use_mesh=True`` over the model's own device alone is the one-device
    run: no replica, the run's one ``GraphCache``, the caller's generator,
    the same CSV."""
    made, real = [], R.replica_on

    def counted(home, device, seed):
        rep = real(home, device, seed)
        made.append(rep is not home)
        return rep

    monkeypatch.setattr(R, "replica_on", counted)
    one, _ = _evaluate(world, tree, template_views, str(tmp_path / "one.csv"), monkeypatch,
                       generator=torch.Generator().manual_seed(5))
    mesh, _ = _evaluate(world, tree, template_views, str(tmp_path / "mesh.csv"), monkeypatch,
                        generator=torch.Generator().manual_seed(5), use_mesh=True, devices=["cpu"])
    assert made == [False, False] and mesh == one and len(one) > 1


def test_a_card_named_without_its_index_is_the_models_own(world, monkeypatch):
    """A model built on ``cuda`` sits on ``cuda:<current>``: asked for that
    card under either name, ``replica_on`` and the runner's parts give the
    caller's model, graphs and generator, and copy nothing (on the card in
    tests/test_torch_kernels.py; here with the current card stubbed)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(R, "resolve_device", torch.device)
    monkeypatch.setattr(P.copy, "deepcopy", lambda *a: pytest.fail("copied the model"))
    model = type("OnTheCard", (), {"device": torch.device("cuda")})()
    home = P.Replica(model, GraphCache("cpu"), torch.Generator())
    card = torch.device("cuda", 0)
    assert P.replica_on(home, card, 0) is home and P.replica_on(home, torch.device("cuda"), 0) is home
    parts = R._parts(home, None) + R._parts(home, [card, "cuda", card])
    assert len(parts) == 4 and all(d == card and rep is home for d, rep in parts)
