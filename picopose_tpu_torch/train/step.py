"""The training step: the three stages, their losses and one optimizer update.

Counterpart of picopose_tpu/train/step.py:40-283 on one device.  The JAX
package compiles forward, losses, gradients and the optax update into one
program; so does ``make_train_step`` here, as a CUDA graph:

  * ``TrainState``: the step count, the model (its parameters and the
    BatchNorm running statistics) and the ``Optimizer``;
  * ``make_optimizer``: AdamW, Adam or SGD with a WarmupCosineLR, PolyLR
    or StepLR schedule, and ``grad_accum`` with ``optax.MultiSteps``
    semantics;
  * ``forward_train``: GT keypoints, stages 1-3 in train mode and the losses;
  * ``train_step``: one step, eagerly, gradients by autograd through the
    kernels' Functions (ops/vjp.py);
  * ``make_train_step``: the same step as captured programs.

The update is optax's, written out on device tensors (``Optimizer``):
``optax.adamw`` decays every parameter (biases, norms, ``pos_embed`` and
``cls_token`` too), decoupled, p -= lr (m^ / (sqrt(v^) + eps) + wd p) with
eps outside the square root and the bias correction at the device
``count``; the schedule is read at the update count before the update, so
the first update uses lr(0).  Parameters stay fp32 and are cast per op to
the compute dtype; gradients come back in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from picopose_tpu_torch.device import deterministic_cudnn, full_fp32
from picopose_tpu_torch.geom.affine import gt_translation_scale_inplane, mmul, relative_affine
from picopose_tpu_torch.models.correspondence import init_correspondences
from picopose_tpu_torch.models.picopose import PicoPose
from picopose_tpu_torch.train.augment import AffineNoise, perturb_affine
from picopose_tpu_torch.train.keypoints import sample_keypoints
from picopose_tpu_torch.train.losses import flow_level_loss, info_nce_loss, stage2_loss, total_loss
from picopose_tpu_torch.utils.graphs import GraphCache
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
    """optax's AdamW, Adam or SGD written out in ``torch._foreach_*`` ops on
    tensors that live on the parameters' device, with the schedule and
    gradient accumulation (``optax.MultiSteps``).

    Device state, the only state an update reads or writes, so that a CUDA
    graph can hold it (``make_train_step``):
      * ``grads``: one static gradient per parameter, attached as its
        ``.grad``; backward sums into it in place, an update zeroes it;
      * ``moments``: optax's ``mu`` and ``nu`` (Adam, AdamW) or ``trace``
        (SGD), one tensor per parameter each, named as ``torch.optim``
        names them (``exp_avg``, ``exp_avg_sq``, ``momentum_buffer``);
      * ``count``: int32, the updates applied (optax's ``count``);
      * ``lr``: fp32, the next update's learning rate.
    Host state: ``mini_step``, the steps summed into ``grads`` since the
    last update, and ``updates``, the host's copy of ``count``, from which
    it reads the schedule without a sync.

    A step is ``prepare`` (host: does this step update? if so, fill ``lr``
    with ``schedule(updates)``), the backward, ``apply`` on an updating
    step (device: the mean of the summed gradients, the update, zeroed
    gradients) and ``advance`` (host counters).  ``step`` runs the three
    after a backward.
    """

    def __init__(self, spec: OptimizerSpec, params):
        if spec.opt_type not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"unknown optimizer type {spec.opt_type}")
        self.spec = spec
        self.params = [p for p in params if p.requires_grad]
        device = self.params[0].device
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params]
        self.grads = zeros()
        self.moments = {"momentum_buffer": zeros()} if spec.opt_type == "SGD" else {
            "exp_avg": zeros(), "exp_avg_sq": zeros()}
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.grad_accum = spec.grad_accum
        self.mini_step = 0
        self.updates = 0
        self.adopt_grads()

    def tensors(self) -> list[torch.Tensor]:
        """Every device tensor of the optimizer."""
        return [*self.grads, *(t for m in self.moments.values() for t in m), self.count, self.lr]

    @torch.no_grad()
    def adopt_grads(self) -> None:
        """Attach the static gradients.  A ``.grad`` set outside the
        optimizer (or a ``zero_grad(set_to_none=True)``) is copied in
        first; None is optax's zero gradient, which AdamW still decays."""
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                if p.grad is None:
                    g.zero_()
                else:
                    g.copy_(p.grad)
                p.grad = g

    def prepare(self) -> bool:
        """Whether this step updates; if it does, ``lr`` is set from the
        schedule at the update count before the update."""
        update = self.mini_step + 1 >= self.grad_accum
        if update:
            self.lr.fill_(self.spec.schedule(self.updates))
        return update

    @torch.no_grad()
    def apply(self) -> None:
        """One update from the gradients summed in ``grads`` (device ops
        only, no host sync): their mean, optax's update, ``count`` + 1, the
        gradients zeroed."""
        s, g, p = self.spec, self.grads, self.params
        if self.grad_accum > 1:
            torch._foreach_div_(g, float(self.grad_accum))
        self.count.add_(1)
        if s.opt_type == "SGD":  # optax.trace: t = g + b1 t
            (t,) = self.moments.values()
            torch._foreach_mul_(t, s.betas[0])
            torch._foreach_add_(t, g)
            u = torch._foreach_mul(t, self.lr)
        else:  # optax.scale_by_adam, then AdamW's decayed weights
            mu, nu = self.moments.values()
            b1, b2 = s.betas
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            c = self.count.float()
            u = torch._foreach_div(mu, 1.0 - torch.pow(b1, c))
            den = torch._foreach_div(nu, 1.0 - torch.pow(b2, c))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, s.eps)
            torch._foreach_div_(u, den)
            del den
            if s.opt_type == "AdamW":
                torch._foreach_add_(u, p, alpha=s.weight_decay)
            torch._foreach_mul_(u, self.lr)
        torch._foreach_sub_(p, u)
        torch._foreach_zero_(g)

    def advance(self, updated: bool) -> None:
        self.mini_step = 0 if updated else self.mini_step + 1
        self.updates += updated

    def step(self) -> bool:
        """Consume the gradients summed in each parameter's ``.grad`` since
        the last update: on every ``grad_accum``-th call one update on their
        mean, which advances the schedule once; on the others the parameters
        do not move.  Returns whether they moved."""
        self.adopt_grads()
        update = self.prepare()
        if update:
            self.apply()
        self.advance(update)
        return update

    def state_dict(self) -> dict:
        """The optimizer's part of a train state, in the layout of the
        ``torch.optim`` and ``LambdaLR`` state dicts the port saved before
        the update was written out: moments by parameter index under
        ``optimizer``, the update count as ``scheduler``'s ``last_epoch``,
        ``mini_step`` and, in the middle of an accumulation, the summed
        gradients."""
        n = len(self.params)
        return {
            "optimizer": {"state": {i: {k: m[i] for k, m in self.moments.items()} for i in range(n)}},
            "scheduler": {"last_epoch": self.updates},
            "mini_step": self.mini_step,
            "grads": list(self.grads) if self.mini_step else None,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (``state_dict``'s layout) into the optimizer's
        tensors in place: each keeps its address, so a captured program
        reads what was loaded.  A parameter with no saved moment (a save
        before the first update) gets zeros."""
        n = len(self.params)
        moments, grads = state["optimizer"]["state"], state["grads"] or [None] * n
        if len(grads) != n or any(int(i) >= n for i in moments):
            raise ValueError(f"optimizer state for {max(len(grads), len(moments))} parameters, not {n}")
        for i in range(n):
            for k, m in self.moments.items():
                _copy_or_zero(m[i], moments.get(i, {}).get(k), f"{k} of parameter {i}")
            _copy_or_zero(self.grads[i], grads[i], f"gradient of parameter {i}")
        self.updates = int(state["scheduler"]["last_epoch"])
        self.count.fill_(self.updates)
        self.mini_step = int(state["mini_step"])
        self.adopt_grads()


def _copy_or_zero(dst: torch.Tensor, src: torch.Tensor | None, what: str) -> None:
    if src is None:
        dst.zero_()
    elif src.shape != dst.shape:
        raise ValueError(f"{what}: saved shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
    else:
        dst.copy_(src)


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
        b["real_mask"], b["real_M"], b["real_K"], mmul(b["real_pose"], torch.linalg.inv_ex(b["tem_pose"]).inverse),
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


@full_fp32()
@deterministic_cudnn()
def _step_program(model: PicoPose, optimizer: Optimizer, batch: dict, noise, update: bool) -> dict:
    """The device work of one step: ``forward_train``, the backward into the
    static gradients and, when ``update``, ``optimizer.apply()``.  Returns
    the loss dict, detached.  The backward and the update run under
    ``full_fp32`` too, so a program captured under the caller's TF32 flags
    computes what the eager step does; cuDNN takes deterministic
    algorithms, so two identical steps, and a captured step and its eager
    step, are bitwise equal."""
    losses = forward_train(model, batch, noise)
    losses["loss"].backward()
    if update:
        optimizer.apply()
    return {k: v.detach() for k, v in losses.items()}


def _host_step(state: TrainState, device_work: Callable[[bool], dict]) -> dict:
    """A step's host part around ``device_work(update)``: the checks, train
    mode, the static gradients attached, ``lr`` filled before an update,
    then the counters."""
    model, opt = state.model, state.optimizer
    stored = {p.dtype for p in model.parameters()}
    if stored != {torch.float32}:
        raise ValueError(
            f"train_step takes fp32 parameters, not {sorted(map(str, stored))}: "
            "utils/precast.py stores bf16 weights for serving only"
        )
    model.train()
    opt.adopt_grads()
    update = opt.prepare()
    losses = device_work(update)
    opt.advance(update)
    state.step += 1
    return losses


def train_step(state: TrainState, batch: dict, noise: AffineNoise | torch.Generator) -> dict:
    """One step, eagerly: ``forward_train`` in train mode, the gradient of
    the total loss, and an update on every ``grad_accum``-th step.  Updates
    ``state`` in place and returns the loss dict, detached.  The CPU's form
    of ``make_train_step``'s program, and its oracle on the card."""
    return _host_step(state, lambda update: _step_program(state.model, state.optimizer, batch, noise, update))


def make_train_step(state: TrainState, state_shardings=None, mesh=None):
    """The compiled step for one device, as the JAX ``make_train_step``
    returns the jitted ``_step``: ``step(state, batch, noise) -> losses``,
    exactly one ``train_step``.

    On CUDA the device work of a step (``_step_program``) is a CUDA graph
    (utils/graphs.py): two programs, the step that only accumulates and the
    step that updates, each captured at its first call (a warm-up, whose
    changes to the state are undone, then the capture) and replayed after,
    with the batch copied into static buffers and a ``noise`` generator
    registered with the graph (an ``AffineNoise`` is an input like the
    batch); the ViT's ``remat`` switch selects a program too.  The host
    keeps the counters and fills ``lr`` before an update.  A state whose
    tensors were replaced (not copied into) is captured anew;
    ``utils/checkpoint.py::restore`` copies in place.  On the CPU
    ``GraphCache`` calls the program: the step is ``train_step``.

    ``step.graphs`` is the ``GraphCache``; the loop holds its ``lock``
    around its uploader's CUDA calls.  The sharded form (``state_shardings``,
    ``mesh``) is not ported."""
    if state_shardings is not None or mesh is not None:
        raise NotImplementedError("the sharded train step is not ported; it runs on one device")
    graphs = GraphCache(state.model.device)

    def step(state: TrainState, batch: dict, noise: AffineNoise | torch.Generator) -> dict:
        model, opt = state.model, state.optimizer

        def device_work(update: bool) -> dict:
            b = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
            gen = noise if isinstance(noise, torch.Generator) else None
            program = lambda b, n=noise: _step_program(model, opt, b, n, update)
            return graphs.run(
                "train_step", program, (b,) if gen is not None else (b, noise),
                static=(update, model.feature_extractor.dinov2.remat), generator=gen, module=model,
                writes=[*model.parameters(), *model.buffers(), *opt.tensors()],
            )

        return _host_step(state, device_work)

    step.graphs = graphs
    return step
