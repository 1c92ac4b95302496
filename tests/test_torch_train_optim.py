"""The port's schedules and optimizers (train/step.py) against the JAX
package's optax ones.

Tolerances: the schedules compute in fp32 on both sides, within 1e-7 at
base lr 1 (a few fp32 roundings); an update of AdamW, Adam or SGD within
1e-6 of optax's (atol + rtol: parameters O(1), the same formulas in
another operation order); gradient accumulation's mean within 1e-6 (the
port sums and divides, optax keeps a running mean).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from picopose_tpu.train import step as js
from picopose_tpu_torch.train import step as ts

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name,args,steps", [
    ("warmup_cosine_schedule", (1.0, 1000, 100, 0.001), (0, 1, 50, 100, 101, 500, 999, 1000, 1200)),
    ("warmup_cosine_schedule", (1.0, 400_000, 1000, 0.001), (0, 999, 1000, 200_000, 399_999, 400_000)),
    ("poly_schedule", (1.0, 1000), (0, 1, 500, 999, 1000, 1500)),
    ("step_schedule", (1.0, 333), (0, 332, 333, 665, 666, 1000)),
])
def test_schedules_match_optax(name, args, steps):
    got = getattr(ts, name)(*args)
    ref = getattr(js, name)(*args)
    for i in steps:
        assert abs(got(i) - float(ref(i))) <= 1e-7, (name, i, got(i), float(ref(i)))


def _tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("opt_type", ["AdamW", "Adam", "SGD"])
@pytest.mark.parametrize("schedule_type", ["WarmupCosineLR", "PolyLR", "StepLR"])
def test_updates_match_optax(rng, opt_type, schedule_type):
    """Three updates with fresh gradients each: the schedule is read at the
    count before each update, AdamW decays every parameter."""
    kw = dict(base_lr=0.05, max_iters=6, warmup_iters=2, warmup_factor=0.1, opt_type=opt_type,
              schedule_type=schedule_type, weight_decay=0.05)
    tx = js.make_optimizer(**kw)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ts.make_optimizer(**kw).init(tp.values())
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        assert opt.step()
        for k in params:
            assert tp[k].grad is None
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), err_msg=k, **TOL)


def test_grad_accum_steps_once_on_the_mean(rng):
    """grad_accum=3: the parameters stay put on calls 1-2, then move by one
    AdamW update on the mean of the three gradients, as optax.MultiSteps."""
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ts.make_optimizer(max_iters=100, grad_accum=3).init(tp.values())
    acc = js.make_optimizer(max_iters=100, grad_accum=3)
    s = acc.init(jax.tree.map(jnp.asarray, params))
    for i, g in enumerate(grads):
        for k, p in tp.items():  # .grad sums the micro-batches' gradients, as backward() does
            p.grad = torch.from_numpy(g[k].copy()) if p.grad is None else p.grad + torch.from_numpy(g[k])
        upd, s = acc.update(jax.tree.map(jnp.asarray, g), s, jax.tree.map(jnp.asarray, params))
        assert opt.step() == (i == 2)
        if i < 2:
            assert all(np.all(np.asarray(u) == 0.0) for u in jax.tree.leaves(upd))
            for k in params:
                np.testing.assert_array_equal(tp[k].detach().numpy(), params[k])
    ref = optax.apply_updates(jax.tree.map(jnp.asarray, params), upd)
    mean = jax.tree.map(lambda *a: sum(a) / 3.0, *[jax.tree.map(jnp.asarray, g) for g in grads])
    one = js.make_optimizer(max_iters=100)
    direct, _ = one.update(mean, one.init(jax.tree.map(jnp.asarray, params)), jax.tree.map(jnp.asarray, params))
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(ref[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(np.asarray(ref[k]), np.asarray(optax.apply_updates(
            jax.tree.map(jnp.asarray, params), direct)[k]), err_msg=k, **TOL)
    assert opt.scheduler.last_epoch == 1 and opt.mini_step == 0


def test_unused_parameters_are_decayed_as_optax_does(rng):
    """A parameter autograd gave no gradient gets optax's zero gradient:
    AdamW still decays it."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = ts.make_optimizer(base_lr=0.1, warmup_factor=1.0, weight_decay=0.5).init([p])
    assert opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.full(3, 1 - 0.1 * 0.5), rtol=1e-6)  # p -= lr(0) wd p


def test_unknown_types_raise():
    with pytest.raises(ValueError, match="optimizer type"):
        ts.make_optimizer(opt_type="Lion")
    with pytest.raises(ValueError, match="lr_scheduler"):
        ts.make_optimizer(schedule_type="OneCycle")
