"""The port's training step (train/step.py) against the JAX package's at
``vit_tiny_test`` width: fp32, batch 2 of synthetic sphere pairs at 224^2
(the 16 / 32 / 64 flow grids), the same flax variables carried across by
``load_flax_variables`` and the JAX package's affine-noise draws injected.

Tolerances (measured largest errors in brackets):
* the loss dict within 1e-4 relative [8.3e-7]: fp32 on both sides, sums
  in other orders through four ViT blocks, the DPT head and three decoder
  levels;
* the BatchNorm running statistics after the step within 1e-5 [3.8e-6];
  after two steps they follow the parameters, as those do;
* gradients per parameter group (ViT, affine head, DPT head, flow
  decoder) within 1e-3 relative RMS [1.3e-4, DPT head];
* parameters after two AdamW steps at lr 1e-3: their change (BatchNorm
  statistics included) within 1e-2 relative RMS per group [8.7e-4, ViT],
  and every parameter within 4e-3 [2.2e-3] (2 lr per step:
  AdamW's first steps move a parameter by about +-lr whatever the size of
  its gradient, so a gradient near zero may take the other sign on the
  other side).
The port against itself: two identical steps bitwise (losses, gradients,
parameters, statistics); ViT remat on and off give the same losses
bitwise and gradients within 1e-6 [bitwise equal].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_losses import jax_affine_noise
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.data.synthetic import make_pose, make_view
from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.train import step as js
from picopose_tpu_torch.eval.pipeline import build_bank
from picopose_tpu_torch.train import step as ts
from picopose_tpu_torch.utils.precast import precast_inference_params
from picopose_tpu_torch.utils.weights import load_flax_variables, state_dict_from_flax

B = 2
OPT = dict(base_lr=1e-3, max_iters=10_000, warmup_factor=1.0)
GROUPS = ("feature_extractor", "affine_regressor", "dpt_head", "flow_decoder")


def _batch():
    pairs = [((0.3, 0.4, 0.45), (0.45, 0.52, 0.6)), ((1.0, -0.2, 0.5), (1.2, -0.1, 0.55))]
    batch = {}
    for side, idx in (("tem", 0), ("real", 1)):
        views = [make_view(make_pose(*p[idx]), 0.05) for p in pairs]
        for key in ("rgb", "mask", "M", "K", "pose", "full_depth"):
            batch[f"{side}_{key}"] = np.stack([getattr(v, key) for v in views])
    return batch


@pytest.fixture(scope="module")
def reference():
    """The JAX package's two steps: loss dicts, gradients and batch stats
    of each, and the parameters after each AdamW update."""
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    tx = js.make_optimizer(**OPT)

    @jax.jit
    def step(params, stats, opt_state):
        def loss_fn(p):
            losses, new_stats = js.forward_train(jmodel, p, stats, jb, key)
            return losses["loss"], (losses, new_stats)
        grads, (losses, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        upd, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), new_stats, opt_state, grads, losses

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    steps = []
    for _ in range(2):
        params, stats, opt_state, grads, losses = step(params, stats, opt_state)
        steps.append(dict(
            losses={k: float(v) for k, v in losses.items()},
            grads=state_dict_from_flax({"params": grads, "batch_stats": stats}),
            state=state_dict_from_flax({"params": params, "batch_stats": stats}),
        ))
    noise = jax_affine_noise(jax.random.split(key)[0], B)
    return dict(variables=variables, batch=batch, noise=noise, steps=steps)


def _state(reference, **kw):
    state = ts.init_state(ts.make_optimizer(**OPT), device="cpu", **SMALL, compute_dtype=torch.float32, **kw)
    load_flax_variables(state.model, reference["variables"])
    return state


def _step(reference, **kw):
    """A fresh state from the reference's variables and one train_step:
    (state, loss dict, the gradients the update used, the state dict after
    the step, cloned)."""
    state = _state(reference, **kw)
    grads = {}

    def record(optimizer, args, kwargs):
        grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})

    hook = state.optimizer.inner.register_step_pre_hook(record)
    losses = ts.train_step(state, reference["batch"], reference["noise"])
    hook.remove()
    return state, losses, grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.fixture(scope="module")
def first_step(reference):
    """The port's first step; ``test_two_adamw_steps_match_jax`` takes the
    state on by a second step (the other tests read the cloned values)."""
    return _step(reference)


def _rel_rms_by_group(got: dict, ref: dict, keys=None) -> dict:
    out = {}
    for g in GROUPS:
        ks = [k for k in ref if k.startswith(g) and (keys is None or k in keys)]
        a = np.concatenate([np.ravel(got[k]) for k in ks])
        b = np.concatenate([np.ravel(ref[k]) for k in ks])
        out[g] = np.linalg.norm(a - b) / np.linalg.norm(b)
    return out


def test_forward_train_matches_jax(reference, first_step):
    """Loss dict, gradients by group and the BatchNorm statistics after the
    step (train mode: each shared BatchNorm updated twice)."""
    _, losses, grads, sd = first_step
    ref = reference["steps"][0]
    assert sorted(losses) == sorted(ref["losses"])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), ref["losses"][k], rtol=1e-4, err_msg=k)
    rel = _rel_rms_by_group({k: v.numpy() for k, v in grads.items()}, ref["grads"], keys=grads)
    assert max(rel.values()) <= 1e-3, rel
    stats = [k for k in sd if "running" in k]
    assert len(stats) == 2 * (2 * 5 + 3)  # DPT: 5 residual units x 2 BNs; flow: 3 proj_bn
    before = state_dict_from_flax(reference["variables"])
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), ref["state"][k], atol=1e-5, rtol=1e-5, err_msg=k)
        assert not np.array_equal(sd[k].numpy(), before[k]), k


def test_two_adamw_steps_match_jax(reference, first_step):
    """Parameters after two AdamW steps (their change by group, and each
    within 2 lr per step), the BatchNorm statistics' change by group."""
    state = first_step[0]
    losses = ts.train_step(state, reference["batch"], reference["noise"])
    np.testing.assert_allclose(float(losses["loss"]), reference["steps"][1]["losses"]["loss"], rtol=1e-4)
    assert state.step == 2 and state.optimizer.scheduler.last_epoch == 2
    before = state_dict_from_flax(reference["variables"])
    after = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = reference["steps"][1]["state"]
    delta = lambda sd: {k: sd[k] - before[k] for k in ref}
    rel = _rel_rms_by_group(delta(after), delta(ref))
    assert max(rel.values()) <= 1e-2, rel
    for k in ref:
        if "running" not in k:
            np.testing.assert_allclose(after[k], ref[k], atol=4 * OPT["base_lr"], rtol=0, err_msg=k)


def test_two_identical_steps_are_bitwise_equal(reference, first_step):
    _, l0, g0, s0 = first_step
    _, l1, g1, s1 = _step(reference)
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_remat_changes_no_loss_and_no_gradient(reference, first_step):
    """ViT blocks under torch.utils.checkpoint: the same forward, and the
    recomputed backward gives the gradients within 1e-6."""
    _, l_plain, g_plain, _ = first_step
    state, l_remat, g_remat, _ = _step(reference, remat_vit=True)
    assert state.model.feature_extractor.dinov2.remat
    assert all(torch.equal(l_plain[k], l_remat[k]) for k in l_plain)
    for n, a in g_plain.items():
        torch.testing.assert_close(g_remat[n], a, atol=1e-6 * a.abs().max().item(), rtol=1e-6, msg=n)


def test_eval_mode_after_training_uses_running_statistics(reference):
    """After a train-mode forward, ``.eval()`` serves from the running
    statistics (which an eval forward leaves alone); the pipeline refuses
    a model still in train mode."""
    model = _state(reference).model
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, 16, 16, 128, generator=g) for _ in range(4)]
    with torch.no_grad():
        ts.forward_train(model, reference["batch"], reference["noise"])
        train_out = model.dpt(feats)
        model.eval()
        stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        eval_out = model.dpt(feats)
        assert all(torch.equal(stats[k], model.state_dict()[k]) for k in stats)
        assert all(torch.equal(a, b) for a, b in zip(eval_out, model.dpt(feats)))
        assert not torch.equal(train_out[-1], eval_out[-1])
    rgb = torch.from_numpy(reference["batch"]["tem_rgb"])
    bank_args = (rgb, torch.ones(2, 224, 224), torch.zeros(2, 64, 64, 3), torch.eye(4).expand(2, 4, 4),
                 torch.eye(3).expand(2, 3, 3), torch.eye(3).expand(2, 3, 3))
    assert build_bank(model, *bank_args).dpt is not None
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        build_bank(model, *bank_args)


def test_train_step_refuses_precast_weights(reference):
    state = _state(reference)
    precast_inference_params(state.model)
    with pytest.raises(ValueError, match="fp32 parameters"):
        ts.train_step(state, reference["batch"], reference["noise"])
    assert state.step == 0
