"""The compiled training step (train/step.py::make_train_step) and the
optimizer written out on device tensors (train/step.py::Optimizer) on the
CPU, where ``GraphCache`` calls the step's program eagerly; the card's
replays are held against the eager step in tests/test_torch_kernels.py.

Tolerances:
* an update of the written-out AdamW, Adam or SGD within 1e-6 of optax's
  (atol + rtol, test_torch_train_optim.py's ``TOL``), parameters and
  moments, under every schedule, over five updates, with ``grad_accum`` 1
  and 2 (the port sums and divides, optax keeps a running mean);
* ``make_train_step`` against the JAX ``make_train_step`` over three steps
  at ``vit_tiny_test`` width with ``grad_accum`` 2 (one update, at the
  second step), test_torch_train_step.py's tolerances: each loss within
  1e-4 relative; the BatchNorm statistics of the two steps before the
  update within 1e-5;
  after the update the change of the state (parameters and statistics)
  within 1e-2 relative RMS per parameter group and every parameter within
  2 lr of the JAX one (an update moves a parameter by about +-lr);
* a train state saved in the ``torch.optim`` layout in the middle of an
  accumulation restores in place: bitwise, every tensor at its address,
  and the next compiled step bitwise the next eager one.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_losses import jax_affine_noise
from test_torch_train_optim import TOL
from test_torch_train_step import OPT, _batch, _rel_rms_by_group
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.train import step as js
from picopose_tpu_torch.train import step as ts
from picopose_tpu_torch.utils import checkpoint as ckpt
from picopose_tpu_torch.utils.weights import load_flax_variables, state_dict_from_flax

B = 2
ACCUM = 2
MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace"}


# ---------------------------------------------------------------- the update


def _tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("opt_type", ["AdamW", "Adam", "SGD"])
@pytest.mark.parametrize("schedule_type", ["WarmupCosineLR", "PolyLR", "StepLR"])
def test_written_out_updates_match_optax(rng, opt_type, schedule_type, grad_accum):
    """Five updates (``grad_accum`` steps each, a fresh gradient summed into
    the static ``.grad`` by each): parameters and moments as optax's,
    ``count`` an int32 and ``lr`` an fp32 tensor on the parameters' device
    holding the update count and the schedule at the count before the last
    update; the gradients keep their tensors and are zero after each."""
    kw = dict(base_lr=0.05, max_iters=6, warmup_iters=2, warmup_factor=0.1, opt_type=opt_type,
              schedule_type=schedule_type, weight_decay=0.05, grad_accum=grad_accum)
    tx = js.make_optimizer(**kw)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ts.make_optimizer(**kw).init(tp.values())
    static = [p.grad for p in tp.values()]
    sched = ts.make_optimizer(**kw).schedule
    for update in range(1, 6):
        for micro in range(grad_accum):
            g = _tree(rng)
            upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in tp.items():
                p.grad += torch.from_numpy(g[k])  # as backward() sums into the static gradient
            assert opt.step() == (micro == grad_accum - 1)
        assert [p.grad for p in tp.values()] == static and not any(bool(g.any()) for g in static)
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
        for name, tensors in opt.moments.items():
            ref = optax.tree_utils.tree_get(state, MOMENTS[name])
            for k, t in zip(tp, tensors):
                np.testing.assert_allclose(t.numpy(), np.asarray(ref[k]), err_msg=f"{name} {k}", **TOL)
        assert opt.count.dtype == torch.int32 and opt.count.device == tp["w"].device
        assert int(opt.count) == opt.updates == update and opt.mini_step == 0
        assert opt.lr.dtype == torch.float32 and opt.lr.device == tp["w"].device
        assert float(opt.lr) == sched(update - 1)


# ---------------------------------------------------------------- the compiled step against JAX's


def _port_state(variables, grad_accum=ACCUM, seed=0):
    state = ts.init_state(ts.make_optimizer(**OPT, grad_accum=grad_accum), seed, device="cpu", **SMALL,
                          compute_dtype=torch.float32)
    if variables is not None:
        load_flax_variables(state.model, variables)
    return state


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX ``make_train_step``'s three steps with ``grad_accum`` 2 from
    seeded flax variables: the loss dict and the state after each, and the
    affine noise each drew."""
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = js.make_optimizer(**OPT, grad_accum=ACCUM)
    step = js.make_train_step(jmodel, tx)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = js.TrainState(jnp.zeros((), jnp.int32), params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          tx.init(params))
    out = []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        state, losses = step(state, jb, key)
        out.append(dict(
            losses={k: float(v) for k, v in losses.items()},
            state=state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats}),
            noise=jax_affine_noise(jax.random.split(key)[0], B),
        ))
    return variables, batch, out


def test_compiled_step_matches_jax_make_train_step(jax_steps):
    """Three calls of the port's compiled step: the first accumulates, the
    second updates on the mean of the two gradients, the third accumulates
    from the updated parameters; losses, statistics and parameters follow
    the JAX program's."""
    variables, batch, ref = jax_steps
    state = _port_state(variables)
    step = ts.make_train_step(state)
    before = state_dict_from_flax(variables)
    params = {n for n, _ in state.model.named_parameters()}
    for i, r in enumerate(ref):
        losses = step(state, batch, r["noise"])
        assert sorted(losses) == sorted(r["losses"])
        for k, v in losses.items():
            np.testing.assert_allclose(float(v), r["losses"][k], rtol=1e-4, err_msg=f"step {i + 1} {k}")
        after = {k: v.numpy() for k, v in state.model.state_dict().items()}
        if i == 0:  # accumulated only: the parameters stay
            assert all(np.array_equal(after[k], before[k]) for k in params)
        if i < 2:  # statistics of forwards through the first parameters
            for k in after:
                if "running" in k:
                    np.testing.assert_allclose(after[k], r["state"][k], atol=1e-5, rtol=1e-5, err_msg=k)
        if i > 0:
            delta = lambda sd: {k: sd[k] - before[k] for k in r["state"]}
            rel = _rel_rms_by_group(delta(after), delta(r["state"]))
            assert max(rel.values()) <= 1e-2, (i, rel)
            for k in params:
                np.testing.assert_allclose(after[k], r["state"][k], atol=2 * OPT["base_lr"], rtol=0, err_msg=k)
        if i == 1:
            updated = {k: after[k] for k in params}
    assert all(np.array_equal(after[k], updated[k]) for k in params)  # the third call did not update
    opt = state.optimizer
    assert state.step == 3 and opt.updates == int(opt.count) == 1 and opt.mini_step == 1
    assert step.graphs.calls["train_step"] == 3


def test_the_step_pins_cudnn_and_tf32_and_restores_the_callers_flags(jax_steps, monkeypatch):
    """The step's forward and backward run with cuDNN's deterministic
    algorithms and without TF32 whatever the caller set (device.py), and
    the caller's flags come back after it."""
    batch = {k: v[:1] for k, v in jax_steps[1].items()}
    state = _port_state(None)
    flags = lambda: (torch.backends.cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    seen = []
    forward = ts.forward_train

    def recording(*args):
        losses = forward(*args)
        seen.append(flags())
        losses["loss"].register_hook(lambda g: seen.append(flags()))
        return losses

    monkeypatch.setattr(ts, "forward_train", recording)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ts.make_train_step(state)(state, batch, torch.Generator().manual_seed(0))
    assert seen == [(True, False, False)] * 2  # the forward's end, the backward
    assert flags() == (False, True, True)


# ---------------------------------------------------------------- restore in place


def _legacy_payload(state, epoch: int = 0) -> dict:
    """A train state as the port saved it before its update was written
    out: ``torch.optim.AdamW``'s and ``LambdaLR``'s own state dicts, built by
    them from this state's moments and update count."""
    opt, s = state.optimizer, state.optimizer.spec
    params = [p.detach().clone().requires_grad_() for p in opt.params]
    inner = torch.optim.AdamW(params, s.base_lr, s.betas, s.eps, s.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(inner, lambda i: s.schedule(i) / s.base_lr)
    for i, p in enumerate(params):
        inner.state[p] = {"step": torch.tensor(float(opt.updates)),
                          **{k: m[i].clone() for k, m in opt.moments.items()}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # stepping the schedule without optimizer.step()
        for _ in range(opt.updates):
            scheduler.step()
    return {"model": state.model.state_dict(), "optimizer": inner.state_dict(), "scheduler": scheduler.state_dict(),
            "mini_step": opt.mini_step, "grads": [p.grad.clone() for p in opt.params] if opt.mini_step else None,
            "step": state.step, "epoch": epoch}


def _addresses(state) -> list[int]:
    opt = state.optimizer
    return [t.data_ptr() for t in (*state.model.parameters(), *state.model.buffers(), *opt.tensors())]


def _assert_equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer, b.optimizer
    assert (a.step, oa.updates, oa.mini_step) == (b.step, ob.updates, ob.mini_step)
    assert torch.equal(oa.count, ob.count)
    for x, y in zip(oa.tensors()[:-1], ob.tensors()[:-1]):  # all but lr, which each update fills
        assert torch.equal(x, y)


def test_legacy_checkpoint_restores_in_place_mid_accumulation(tmp_path):
    """A state three steps in (grad_accum 2: one update, then one step's
    gradient summed) saved in the ``torch.optim`` layout, restored into a
    state whose compiled step has already run: every parameter, statistic,
    moment and gradient keeps its address and equals the saved one; the
    next compiled step equals the next eager step of the saved state
    (batch 1)."""
    batch = {k: v[:1] for k, v in _batch().items()}
    noise = lambda seed: torch.Generator().manual_seed(seed)
    a = _port_state(None, seed=0)
    step_a = ts.make_train_step(a)
    for i in range(3):
        step_a(a, batch, noise(i))
    assert a.optimizer.mini_step == 1 and a.optimizer.updates == 1
    path = ckpt.checkpoint_path(str(tmp_path), a.step)
    os.makedirs(os.path.dirname(path))
    torch.save(_legacy_payload(a), path)

    b = _port_state(None, seed=1)  # other weights, already stepped through its compiled step
    step_b = ts.make_train_step(b)
    step_b(b, batch, noise(10))
    addresses = _addresses(b)
    assert ckpt.restore(str(tmp_path), None, b) is b
    assert _addresses(b) == addresses
    assert all(p.grad is g for p, g in zip(b.optimizer.params, b.optimizer.grads))
    _assert_equal_states(a, b)

    la, lb = ts.train_step(a, batch, noise(9)), step_b(b, batch, noise(9))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    _assert_equal_states(a, b)
    assert b.optimizer.updates == 2 and b.optimizer.mini_step == 0
    os.remove(path)
