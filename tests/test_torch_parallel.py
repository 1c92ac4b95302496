"""The port's parallel/ package in one process: the sharding rule table
against the JAX package's, the mesh's groups and coordinates, process-group
bring-up, the one-rank paths of BatchNorm and the losses, and the rows of
the global batch each rank trains on.

* ``leaf_spec``: every port parameter, BatchNorm statistic and AdamW
  moment gets the JAX package's partition spec for its flax path, at
  (n_data, n_model) = (8, 1), (4, 2) and (1, 2) in every mode.  The flax
  path and the axis order of each port tensor are recovered here from
  utils/weights.py itself (each flax leaf filled with its number and an
  index along one axis), independently of ``flax_leaf``;
* the mesh: rank r at (r // n_model, r % n_model), its data and model
  ranks, the 1 x 1 mesh outside a process group, a grid that does not
  cover the world raises, the groups of a one-rank gloo group;
* ``initialize``: a no-op without torchrun's variables; keyword arguments
  reach ``init_process_group`` unchanged and its errors propagate;
* BatchNorm in train mode and the losses outside ``data_parallel``, or
  inside it on one data rank, are bitwise the formulas the one-device
  step has always computed (written out here), forward and backward;
* the global batch: the port loader's batch of bs x n_data rows, cut by
  ``shard_batch`` for each rank, is the JAX loop's global batch, bitwise
  (the JAX crops on their cv2 path, as tests/test_torch_train_loop.py).
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from test_torch_train_step import _batch
from torch_bop_tree import write_megapose_tree
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.data.megapose import MegaPoseTrainingDataset as JDataset
from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.parallel.shardings import _path_str
from picopose_tpu.parallel.shardings import leaf_spec as jax_leaf_spec
from picopose_tpu.train import loop as J
from picopose_tpu.train import step as js
from picopose_tpu_torch.data.megapose import MegaPoseTrainingDataset
from picopose_tpu_torch.models.layers import BatchNorm2d
from picopose_tpu_torch.parallel import distributed as pd
from picopose_tpu_torch.parallel import leaf_spec, make_mesh, replicated, shard_batch, state_shardings
from picopose_tpu_torch.parallel.collectives import data_parallel
from picopose_tpu_torch.parallel.mesh import Mesh, batch_rows
from picopose_tpu_torch.train import loop as T
from picopose_tpu_torch.train import losses as L
from picopose_tpu_torch.train import step as ts
from picopose_tpu_torch.utils.weights import state_dict_from_flax

GRIDS = [(8, 1), (4, 2), (1, 2)]
MODES = ("ddp", "fsdp", "tp", "fsdp_tp")


# ---------------------------------------------------------------- the rule table


@pytest.fixture(scope="module")
def flax_tree():
    """The small model's flax variables and optax AdamW state (shapes)."""
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    opt_state = jax.eval_shape(js.make_optimizer().init, variables["params"])
    return variables, opt_state


@pytest.fixture(scope="module")
def port_to_flax(flax_tree):
    """port name -> (flax path, flax axis -> port axis), recovered through
    ``state_dict_from_flax``: every flax leaf is filled with its number
    times 4096 plus its index along one axis, one conversion per axis."""
    variables, _ = flax_tree
    leaves = []
    jax.tree_util.tree_map_with_path(lambda p, x: leaves.append((_path_str(p), x.shape)), variables)
    by_id = {i: leaf for i, leaf in enumerate(leaves)}
    out = {}
    for axis in range(4):
        coded = {}
        for i, (path, shape) in by_id.items():
            idx = np.indices(shape)[axis] if axis < len(shape) else np.zeros(shape)
            arr = (i * 4096 + idx).astype(np.float32)
            node = coded
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = arr
        for name, t in state_dict_from_flax(coded).items():
            leaf_id = int(t.flat[0]) // 4096
            path, shape = by_id[leaf_id]
            perm = out.setdefault(name, (path, [None] * len(shape)))[1]
            if axis < len(shape) and shape[axis] > 1:
                vary = [a for a in range(t.ndim) if t.shape[a] > 1 and np.ptp(t, axis=a).max() > 0]
                assert len(vary) == 1, (name, axis)
                perm[axis] = vary[0]
    return out


@pytest.fixture(scope="module")
def port_state():
    return ts.init_state(ts.make_optimizer(), device="cpu", **SMALL, compute_dtype=torch.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_data, n_model", GRIDS)
def test_leaf_spec_is_the_jax_rule_on_every_port_tensor(flax_tree, port_to_flax, port_state, mode, n_data, n_model):
    _, opt_state = flax_tree
    got = state_shardings(Mesh(n_data, n_model, 0, torch.device("cpu")), port_state, mode).leaves
    model = port_state.model
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    for name, t in tensors.items():
        path, perm = port_to_flax[name]
        shape = tuple(t.shape[p] if p is not None else 1 for p in perm)
        ref = tuple(jax_leaf_spec(path, shape, mode, n_data, n_model))
        leaf = got[f"model.{name}"]
        assert leaf.flax_path.split("/", 1)[1] == path.split("/", 1)[1], name
        assert leaf.flax_spec == ref, (name, leaf.flax_spec, ref)
        assert leaf.flax_spec == leaf_spec(path, shape, mode, n_data, n_model)
        port_axes = {a: perm[i] for i, a in enumerate(ref) if a is not None}
        assert (leaf.spec.data, leaf.spec.model) == (port_axes.get("data"), port_axes.get("model")), name
    flax_to_port = {path.split("/", 1)[1]: name for name, (path, _) in port_to_flax.items()}
    moments = {"mu": "exp_avg", "nu": "exp_avg_sq"}
    seen = 0

    def check(p, x):
        nonlocal seen
        pstr = _path_str(p)
        kind = next((k for k in moments if f"/.{k}/" in pstr), None)  # e.g. 0/.mu/feature_extractor/...
        if kind is None:
            return
        port = flax_to_port[pstr.split(f"/.{kind}/", 1)[1]]
        ref = tuple(jax_leaf_spec(pstr, x.shape, mode, n_data, n_model))
        assert got[f"optimizer.{moments[kind]}.{port}"].flax_spec == ref, (pstr, ref)
        seen += 1

    jax.tree_util.tree_map_with_path(check, opt_state)
    assert seen == 2 * len(dict(model.named_parameters()))
    assert not got["optimizer.count"].spec.split


def test_fsdp_splits_the_large_leaves_and_tp_the_megatron_ones(port_state):
    got = state_shardings(Mesh(4, 2, 0, torch.device("cpu")), port_state, "fsdp_tp").leaves
    qkv = got["model.feature_extractor.dinov2.blocks.0.attn.qkv.weight"]  # (out 384, in 128)
    assert qkv.flax_spec == ("data", "model") and qkv.spec == (1, 0, 3)  # by heads: q, k and v blocks
    proj_b = got["model.feature_extractor.dinov2.blocks.0.attn.proj.bias"]
    assert proj_b.flax_spec == ()
    fc1 = got["model.affine_regressor.fc1.weight"]
    assert fc1.flax_spec[-1] == "model"


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_model_parts_take_a_chunk_of_each_block_and_join_back(blocks):
    """A model rank's part of a split axis: its chunk of each of the
    axis's blocks (qkv: its heads' q, k and v); the parts of every rank,
    one after another, join back to the whole, on either axis."""
    from picopose_tpu_torch.parallel.shardings import Spec, join_model_parts, model_part

    full = torch.arange(blocks * 8 * 5, dtype=torch.float32).reshape(blocks * 8, 5)
    spec = Spec(None, 0, blocks)
    parts = [model_part(full, spec, 4, r) for r in range(4)]
    assert all(p.shape == (blocks * 2, 5) for p in parts)
    assert torch.equal(parts[1][:2], full[2:4]) and torch.equal(parts[1][-2:], full[-6:-4])
    assert torch.equal(join_model_parts(torch.cat(parts), spec, 4), full)
    spec1 = Spec(None, 1, blocks)
    parts = [model_part(full.T, spec1, 2, r) for r in range(2)]
    assert torch.equal(join_model_parts(torch.cat(parts, dim=1), spec1, 2), full.T)


# ---------------------------------------------------------------- the mesh and the process group


def test_mesh_coordinates_and_ranks():
    m = Mesh(4, 2, 5, torch.device("cpu"))
    assert (m.data_index, m.model_index, m.shape) == (2, 1, {"data": 4, "model": 2})
    assert batch_rows(8, m) == slice(4, 6)
    rows = shard_batch({"a": np.arange(8), "b": [torch.arange(16).reshape(8, 2)]}, m)
    assert rows["a"].tolist() == [4, 5] and rows["b"][0].tolist() == [[8, 9], [10, 11]]
    placed = replicated({"x": np.ones(2), "y": (np.zeros(1),)}, m)
    assert all(t.device == m.device for t in (placed["x"], *placed["y"]))
    with pytest.raises(ValueError, match="does not split"):
        batch_rows(7, m)


def test_make_mesh_outside_a_process_group():
    assert not pd.is_initialized() and pd.process_info() == (0, 1)
    m = make_mesh(device="cpu")
    assert (m.n_data, m.n_model, m.data_group, m.model_group, m.backend) == (1, 1, None, None, None)
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_model=2, n_data=1)


def test_make_mesh_runs_on_the_card_unless_the_cpu_is_passed():
    """No device means the rank's card, as every entry point: without one
    it raises rather than placing the rank's tensors on the CPU."""
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_groups_of_a_one_rank_gloo_group():
    pd.initialize(backend="gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        assert pd.is_initialized() and pd.process_info() == (0, 1) and pd.backend() == "gloo"
        m = make_mesh(device="cpu")
        assert (m.n_data, m.n_model, m.backend) == (1, 1, "gloo")
        assert dist.get_process_group_ranks(m.data_group) == [0] == dist.get_process_group_ranks(m.model_group)
        assert pd.broadcast_host_data({"a": 1}) == {"a": 1}
        pd.all_hosts_barrier()
    finally:
        pd.shutdown()
    assert not pd.is_initialized()


def test_initialize_without_torchrun_is_a_no_op(monkeypatch):
    for k in pd.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    pd.initialize()
    pd.initialize(backend="gloo")
    assert calls == [] and pd.torchrun_env() is None


def test_initialize_passes_keywords_and_reads_torchrun(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    pd.initialize(backend="gloo", init_method="tcp://localhost:1", world_size=3, rank=2)
    assert calls == [dict(backend="gloo", init_method="tcp://localhost:1", world_size=3, rank=2)]
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost").items():
        monkeypatch.setenv(k, v)
    pd.initialize(backend="gloo")
    assert calls[1] == dict(backend="gloo", init_method="env://")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):  # no card for an nccl rank
        pd.initialize()


def test_initialize_errors_propagate():
    with pytest.raises((ValueError, RuntimeError), match="nowhere"):
        pd.initialize(backend="gloo", init_method="nowhere://x", world_size=1, rank=0)
    assert not pd.is_initialized()


# ---------------------------------------------------------------- one rank: the code as it was


def _bn_reference(bn, x):
    """BatchNorm2d.forward in train mode as the one-device step computes it."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
        bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)
    c = (slice(None), None, None)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean[c]) * mul[c] + bn.bias[c]).to(x.dtype)


@pytest.mark.parametrize("mesh", [None, Mesh(1, 1, 0, torch.device("cpu"))], ids=["no mesh", "one rank"])
def test_batchnorm_on_one_rank_is_the_one_device_code(rng, mesh):
    x0 = torch.from_numpy(rng.normal(size=(3, 8, 5, 4)).astype(np.float32))
    bns = [BatchNorm2d(8).train() for _ in range(2)]
    for bn in bns:
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for bn, fn in zip(bns, (lambda bn, x: bn(x), _bn_reference)):
        x = x0.clone().requires_grad_()
        with data_parallel(mesh):
            y = fn(bn, x)
        (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
        outs.append(y.detach())
        grads.append((x.grad, bn.weight.grad, bn.bias.grad))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert torch.equal(bns[0].running_mean, bns[1].running_mean)
    assert torch.equal(bns[0].running_var, bns[1].running_var)


@pytest.mark.parametrize("mesh", [None, Mesh(1, 1, 0, torch.device("cpu"))], ids=["no mesh", "one rank"])
def test_losses_on_one_rank_are_the_one_device_code(rng, mesh):
    B, h, G, C = 2, 4, 16, 8
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
    src, tar = f(B, h, h, C), f(B, h, h, C)
    sp = torch.from_numpy(rng.uniform(0, G, (B, G, G, 2)).astype(np.float32))
    tp = torch.from_numpy(rng.uniform(0, G, (B, G, G, 2)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(B, G, G)) > 0.3)
    flow, cert = f(B, 8, 8, 2), f(B, 8, 8, 1)
    pt, ps, pi = f(B, 2), f(B), f(B, 2)
    gt, gs, ga = torch.randn(B, 2), torch.rand(B) + 0.5, torch.randn(B)

    def ours():
        with data_parallel(mesh):
            terms = [L.info_nce_loss(src, tar, sp, tp, valid), *L.flow_level_loss(flow, cert, tp, valid),
                     *L.stage2_loss(pt, ps, pi, gt, gs, ga)]
        return terms

    def reference():  # the formulas of the one-device step
        stride = G // h
        s_, t_ = sp[:, ::stride, ::stride] * (h / G), tp[:, ::stride, ::stride] * (h / G)
        m = valid[:, ::stride, ::stride].reshape(-1)

        def gather(feat, pts):
            xi = torch.clamp(pts[..., 0].to(torch.int64), 0, h - 1)
            yi = torch.clamp(pts[..., 1].to(torch.int64), 0, h - 1)
            idx = (yi * h + xi).reshape(B, h * h) + h * h * torch.arange(B)[:, None]
            return L.index_select(feat.reshape(B * h * h, C), 0, idx.reshape(-1)).reshape(B, h * h, C)

        q = L.l2_normalize(gather(src, s_).float()).reshape(-1, C)
        r = L.l2_normalize(gather(tar, t_).float()).reshape(-1, C)
        logits = torch.where(m[None, :], torch.matmul(q, r.T) / 0.1, -torch.inf)
        diag = torch.diagonal(F.log_softmax(logits, dim=1))
        info = -torch.where(m, diag, 0.0).sum() / torch.clamp(m.sum(), min=1)
        H = 8
        st = G // H
        gc = valid[:, ::st, ::st]
        gflow = tp[:, ::st, ::st] * (H / G) * gc[..., None] - L.pixel_coords_grid(H, H)
        z, y = cert[..., 0], gc.float()
        bce = torch.maximum(z, torch.zeros_like(z)) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
        wt = ((y >= 0.5) & (torch.sqrt((gflow ** 2).sum(-1)) < 400.0)).float()
        l1 = torch.abs(flow - gflow).sum(-1)
        lt = torch.abs(pt - gt / 14.0).mean()
        ls = torch.mean((torch.log(torch.clamp(ps, min=5e-3)) - torch.log(gs)) ** 2)
        dot = torch.clamp((pi * L.cos_sin(ga)).sum(-1), -1 + 1e-6, 1 - 1e-6)
        return [info, 0.1 * (wt * l1).sum() / (wt.sum() + 1e-10), 1.0 * bce.mean(), lt, ls, torch.arccos(dot).mean()]

    results = []
    for fn in (ours, reference):
        terms = fn()
        grads = torch.autograd.grad(sum(terms), [src, tar, flow, cert, pt, ps, pi])
        results.append(([t.detach() for t in terms], grads))
    assert all(torch.equal(a, b) for a, b in zip(results[0][0], results[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


# ---------------------------------------------------------------- the global batch


def test_each_rank_holds_its_rows_of_the_jax_loops_global_batch(tmp_path, monkeypatch):
    """The loop over 2 data ranks loads bs x 2 rows per step and each rank
    keeps its bs of them: the JAX loop's global batch, split on axis 0."""
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")
    tree = write_megapose_tree(str(tmp_path / "mp"))
    kw = dict(data_dir=tree, min_px_count_visib=100)
    bs, n_data, steps = 1, 2, 2
    ref = list(J.prefetch_batches(JDataset(seed=3, **kw), bs * n_data, steps=steps, workers=1))
    got = list(T.prefetch_batches(MegaPoseTrainingDataset(seed=3, **kw), bs * n_data, steps=steps, workers=1))
    for r in range(n_data):
        mesh = Mesh(n_data, 1, r, torch.device("cpu"))
        for g, b in zip(got, ref):
            rows = shard_batch(g, mesh)
            assert rows.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(rows[k], np.asarray(b[k])[r * bs:(r + 1) * bs], err_msg=k)
