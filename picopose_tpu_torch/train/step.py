"""The training step: the three stages, their losses and one optimizer update.

Counterpart of picopose_tpu/train/step.py:40-283 on one device.  The JAX
package compiles forward, losses, gradients and the optax update into one
program; here they run eagerly on the module:

  * ``TrainState``: the step count, the model (its parameters and the
    BatchNorm running statistics) and the ``Optimizer``;
  * ``make_optimizer``: AdamW, Adam or SGD (``torch.optim``) with a
    WarmupCosineLR, PolyLR or StepLR schedule (``LambdaLR``), and
    ``grad_accum`` with ``optax.MultiSteps`` semantics;
  * ``forward_train``: GT keypoints, stages 1-3 in train mode and the losses;
  * ``train_step``: one step, gradients by autograd through the kernels'
    Functions (ops/vjp.py).

The update is optax's, which ``torch.optim`` computes once set up as
optax is: ``optax.adamw`` decays every parameter (biases, norms,
``pos_embed`` and ``cls_token`` too), decoupled, p -= lr (m^ / (sqrt(v^) +
eps) + wd p) with eps outside the square root, and the schedule is read at
the update count before the update, so the first update uses lr(0).
Parameters stay fp32 and are cast per op to the compute dtype; gradients
come back in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from picopose_tpu_torch.device import full_fp32
from picopose_tpu_torch.geom.affine import gt_translation_scale_inplane, mmul, relative_affine
from picopose_tpu_torch.models.correspondence import init_correspondences
from picopose_tpu_torch.models.picopose import PicoPose
from picopose_tpu_torch.train.augment import AffineNoise, perturb_affine
from picopose_tpu_torch.train.keypoints import sample_keypoints
from picopose_tpu_torch.train.losses import flow_level_loss, info_nce_loss, stage2_loss, total_loss
from picopose_tpu_torch.utils.weights import init_random_

Schedule = Callable[[int], float]


def _f32(i: int) -> torch.Tensor:
    return torch.tensor(float(i), dtype=torch.float32)


# The schedules compute in fp32, as the optax schedules do.
def warmup_cosine_schedule(
    base_lr: float, max_iters: int, warmup_iters: int = 1000, warmup_factor: float = 1e-3
) -> Schedule:
    """lr(i) = base * wf(i) * 0.5 (1 + cos(pi i / max_iters)), wf rising
    linearly from ``warmup_factor`` to 1 over ``warmup_iters`` (the cosine
    starts at 0, not after the warmup)."""

    def schedule(i: int) -> float:
        i = _f32(i)
        alpha = torch.clamp(i / warmup_iters, 0.0, 1.0)
        wf = warmup_factor * (1.0 - alpha) + alpha
        return float(base_lr * wf * (0.5 * (1.0 + torch.cos(math.pi * i / max_iters))))

    return schedule


def poly_schedule(base_lr: float, max_iters: int, power: float = 0.9) -> Schedule:
    """PolyLR: base * (1 - i / max_iters) ** power."""
    return lambda i: float(base_lr * (1.0 - torch.clamp(_f32(i) / max_iters, 0.0, 1.0)) ** power)


def step_schedule(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """StepLR: base * gamma ** floor(i / step_size)."""
    return lambda i: float(base_lr * gamma ** torch.floor(_f32(i) / step_size))


@dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` returns: the optimizer before it has
    parameters (the counterpart of an optax ``GradientTransformation``);
    ``init`` binds it to them."""

    opt_type: str
    base_lr: float
    schedule: Schedule
    betas: tuple[float, float]
    eps: float
    weight_decay: float
    grad_accum: int

    def init(self, params) -> "Optimizer":
        return Optimizer(self, params)


class Optimizer:
    """A ``torch.optim`` optimizer, its ``LambdaLR`` schedule and gradient
    accumulation.  ``step`` consumes the gradients summed in each
    parameter's ``.grad`` since the last update: on every ``grad_accum``-th
    call it applies one update on their mean and advances the schedule once
    (``optax.MultiSteps``); on the others the parameters do not move."""

    def __init__(self, spec: OptimizerSpec, params):
        self.params = [p for p in params if p.requires_grad]
        s = spec
        if s.opt_type == "AdamW":
            self.inner = torch.optim.AdamW(self.params, s.base_lr, s.betas, s.eps, s.weight_decay)
        elif s.opt_type == "Adam":
            self.inner = torch.optim.Adam(self.params, s.base_lr, s.betas, s.eps, weight_decay=0.0)
        elif s.opt_type == "SGD":
            self.inner = torch.optim.SGD(self.params, s.base_lr, momentum=s.betas[0])
        else:
            raise ValueError(f"unknown optimizer type {s.opt_type}")
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.inner, lambda i: s.schedule(i) / s.base_lr)
        self.grad_accum = s.grad_accum
        self.mini_step = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Returns whether the parameters moved."""
        for p in self.params:
            if p.grad is None:  # optax gives an unused parameter a zero gradient (and decays it)
                p.grad = torch.zeros_like(p)
        self.mini_step += 1
        if self.mini_step < self.grad_accum:
            return False
        if self.grad_accum > 1:
            torch._foreach_div_([p.grad for p in self.params], float(self.grad_accum))
        self.inner.step()
        self.scheduler.step()
        self.inner.zero_grad(set_to_none=True)
        self.mini_step = 0
        return True


def make_optimizer(
    base_lr: float = 1e-5,
    max_iters: int = 400_000,
    warmup_iters: int = 1000,
    warmup_factor: float = 1e-3,
    betas: tuple[float, float] = (0.5, 0.999),
    eps: float = 1e-6,
    weight_decay: float = 5e-4,
    opt_type: str = "AdamW",
    schedule_type: str = "WarmupCosineLR",
    grad_accum: int = 1,
) -> OptimizerSpec:
    """The optimizer of configs/base.yaml and its alternatives.
    ``max_iters`` counts optimizer updates (one per ``grad_accum`` steps)."""
    if schedule_type == "WarmupCosineLR":
        lr = warmup_cosine_schedule(base_lr, max_iters, warmup_iters, warmup_factor)
    elif schedule_type == "PolyLR":
        lr = poly_schedule(base_lr, max_iters)
    elif schedule_type == "StepLR":
        lr = step_schedule(base_lr, max_iters // 3)
    else:
        raise ValueError(f"unknown lr_scheduler type {schedule_type}")
    if opt_type not in ("AdamW", "Adam", "SGD"):
        raise ValueError(f"unknown optimizer type {opt_type}")
    return OptimizerSpec(opt_type, base_lr, lr, tuple(betas), eps, weight_decay, grad_accum)


@dataclass
class TrainState:
    step: int
    model: PicoPose
    optimizer: Optimizer


def init_state(tx: OptimizerSpec, seed: int = 0, device=None, **model_kwargs) -> TrainState:
    """A fresh state: ``PicoPose(**model_kwargs)`` on ``device`` (CUDA
    unless "cpu" is passed; raises if no card is present) with weights drawn
    from ``seed``, in train mode, and ``tx`` bound to its parameters."""
    model = PicoPose(**model_kwargs, device=device)
    init_random_(model, seed)
    model.train()
    return TrainState(0, model, tx.init(model.parameters()))


@full_fp32()
def forward_train(model: PicoPose, batch: dict, noise: AffineNoise | torch.Generator) -> dict:
    """All three stages and their losses on a training batch, in the
    module's mode (``.train()``: BatchNorm on batch statistics, running
    statistics updated in call order: the DPT head on the template stack,
    then on the query stack; each level's ``proj_bn`` on the template
    maps, then the query maps).

    batch (numpy arrays or tensors, moved to the model's device): real_rgb
    (B, S, S, 3), real_mask (B, S, S), real_M, real_K (B, 3, 3), real_pose
    (B, 4, 4), real_full_depth (B, H0, W0) and the tem_* counterparts.
    ``noise``: the stage-3 affine noise, or the generator it is drawn from.
    Returns the loss dict: loss_info, loss_2d_trans, loss_scale,
    loss_inplane, loss_flow{l} and loss_certainty{l} per level, and loss.
    """
    b = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    # GT correspondences: src = template, tar = query
    kp = sample_keypoints(
        b["tem_mask"], b["tem_M"], b["tem_K"], b["tem_full_depth"],
        b["real_mask"], b["real_M"], b["real_K"], mmul(b["real_pose"], torch.linalg.inv(b["tem_pose"])),
        tar_depth=b["real_full_depth"], crop=b["tem_mask"].shape[1],
    )
    feats_real = model.features(b["real_rgb"])
    feats_tem = model.features(b["tem_rgb"])
    losses = {"loss_info": info_nce_loss(feats_tem[-1], feats_real[-1], kp.src_pts, kp.tar_pts, kp.valid)}

    poses = (b["tem_K"], b["real_K"], b["tem_pose"], b["real_pose"], b["tem_M"], b["real_M"])
    translation, scale, inplane = model.stage2(feats_tem[-1], feats_real[-1], b["tem_mask"])
    l_t, l_s, l_i = stage2_loss(translation, scale, inplane, *gt_translation_scale_inplane(*poses))
    losses.update(loss_2d_trans=l_t, loss_scale=l_s, loss_inplane=l_i)

    # stage 3 from the noisy GT affine
    noisy = perturb_affine(relative_affine(*poses), noise)
    init_flow, init_cert = init_correspondences(noisy, b["tem_mask"], grid=feats_tem[-1].shape[1])
    flows, certs = model.stage3(feats_tem, feats_real, init_flow, init_cert)
    for lvl, (f, c) in enumerate(zip(flows, certs)):
        losses[f"loss_flow{lvl}"], losses[f"loss_certainty{lvl}"] = flow_level_loss(f, c, kp.tar_pts, kp.valid)
    losses["loss"] = total_loss(losses)
    return losses


def train_step(state: TrainState, batch: dict, noise: AffineNoise | torch.Generator) -> dict:
    """One step: ``forward_train`` in train mode, the gradient of the total
    loss, and ``state.optimizer.step()`` (an update on every
    ``grad_accum``-th step).  Updates ``state`` in place and returns the
    loss dict, detached."""
    model = state.model
    stored = {p.dtype for p in model.parameters()}
    if stored != {torch.float32}:
        raise ValueError(
            f"train_step takes fp32 parameters, not {sorted(map(str, stored))}: "
            "utils/precast.py stores bf16 weights for serving only"
        )
    model.train()
    losses = forward_train(model, batch, noise)
    losses["loss"].backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in losses.items()}


def make_train_step(state_shardings=None, mesh=None):
    """The step function for one device, ``train_step``.  The sharded form
    (``state_shardings``, ``mesh``) is not ported."""
    if state_shardings is not None or mesh is not None:
        raise NotImplementedError("the sharded train step is not ported; it runs on one device")
    return train_step
