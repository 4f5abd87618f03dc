"""The training step, port of ``stereoscene_tpu/engine/train.py``.

- ``compute_losses`` (train.py:203-367): the active recipe, voxel CE +
  sem_scal + geo_scal on the logits upsampled trilinearly to the label grid
  (ref: occhead.py:291-343), plus the BCE depth loss. The terms the recipe
  leaves off (ohem, lovasz, dice, lga, kld, imgseg, CRP, point, streaming)
  are not ported and raise.
- ``create_train_state`` (:122-168): AdamW (lr 1e-4, wd 0.01) after a
  global-norm clip at 5, the step LR of ``step_lr_schedule`` (:65-84) with
  optional linear warmup, frozen parameters (``efficientnet_frozen_predicate``)
  and gradient accumulation (``accumulate_steps``, optax ``MultiSteps``:
  the mean of k gradients makes one update).
- ``make_train_step`` (:370-430): value and gradient, then the update. The
  bf16 policy keeps fp32 master parameters and runs the forward and
  backward on bf16 copies, so gradients land on the masters in fp32;
  losses, norms and softmaxes stay fp32. The copies stand in the modules
  until the backward is done (``torch.func.functional_call`` would take
  them out when the forward returns, and a checkpointed block's recompute
  would then meet the fp32 masters).

State is mutable here: the master parameters are the model's, its
BatchNorm buffers are the batch statistics, and a step updates both in
place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..losses import (
    bce_depth_loss,
    ce_ssc_loss,
    class_weights_from_frequencies,
    geo_scal_loss,
    sem_scal_loss,
)
from ..ops.resize import resize_trilinear


def step_lr_schedule(
        base_lr: float, steps_per_epoch: int, milestones=(20, 25),
        gamma: float = 0.1, warmup_steps: int = 0,
        warmup_ratio: float = 1.0 / 3.0) -> Callable[[int], float]:
    """LR at update ``count``: ``base_lr`` times ``gamma`` for every
    milestone epoch reached (optax ``piecewise_constant_schedule``), times
    the mmcv linear warmup ``1 - (1 - count / warmup_steps)(1 - ratio)``
    over the first ``warmup_steps`` updates."""
    boundaries = sorted(m * steps_per_epoch for m in milestones)

    def schedule(count: int) -> float:
        lr = base_lr * gamma ** sum(count >= b for b in boundaries)
        if warmup_steps > 0:
            frac = min(count / warmup_steps, 1.0)
            lr *= 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        return lr

    return schedule


def efficientnet_frozen_predicate(
        frozen_stages: int,
        backbone_name: str = "img_backbone") -> Callable[[str], bool]:
    """True for the port's parameter names that the reference's backbone
    ``frozen_stages`` freezes: ``layers[:frozen_stages]``, where layer 0 is
    the stem and layer k the k-th block stage; the head conv never."""

    def predicate(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != backbone_name or parts[1] != "layers":
            return False
        index = int(parts[2])
        is_block = parts[3].isdigit()
        if index > 0 and not is_block:  # the head conv
            return False
        return index < frozen_stages

    return predicate


@dataclasses.dataclass
class TrainState:
    """``model`` holds the fp32 master parameters and, as BatchNorm
    buffers, the batch statistics. ``step`` counts train steps,
    ``updates`` the optimizer updates (the schedule's count)."""

    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    trainable: List[Tuple[str, torch.nn.Parameter]]
    grad_clip: float
    accumulate_steps: int = 1
    step: int = 0
    updates: int = 0
    grad_sum: Optional[List[torch.Tensor]] = None


def create_train_state(
    model: torch.nn.Module,
    lr: float = 1e-4,
    weight_decay: float = 0.01,
    grad_clip: float = 5.0,
    steps_per_epoch: int = 1,
    milestones=(20, 25),
    frozen_predicate: Optional[Callable[[str], bool]] = None,
    warmup_steps: int = 0,
    warmup_ratio: float = 1.0 / 3.0,
    accumulate_steps: int = 1,
    device=None,
) -> TrainState:
    """Move ``model`` to ``device`` (by default the CUDA card; the CPU only
    when asked for), put it in training mode, and make its optimizer.
    Parameters that ``frozen_predicate`` names get no update and take no
    part in the clip's norm (optax ``multi_transform`` with
    ``set_to_zero``); their BatchNorm statistics still update."""
    model.to(torch.device("cuda") if device is None else device)
    model.train()
    frozen = frozen_predicate or (lambda name: False)
    trainable = [(n, p) for n, p in model.named_parameters()
                 if not frozen(n)]
    schedule = step_lr_schedule(lr, steps_per_epoch, milestones,
                                warmup_steps=warmup_steps,
                                warmup_ratio=warmup_ratio)
    optimizer = torch.optim.AdamW(
        [p for _, p in trainable], lr=schedule(0), betas=(0.9, 0.999),
        eps=1e-8, weight_decay=weight_decay)
    return TrainState(model, optimizer, schedule, trainable, grad_clip,
                      accumulate_steps)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The weights of semkitti_loss_weight_cfg (stereoscene.py:115-122);
    the same fields and defaults as the JAX package's ``LossConfig``."""

    voxel_ce: float = 1.0
    voxel_sem_scal: float = 1.0
    voxel_geo_scal: float = 1.0
    voxel_ohem: float = 0.0
    voxel_lovasz: float = 0.0
    voxel_dice: float = 0.0
    voxel_lga: float = 0.0
    loss_depth_weight: float = 1.0
    loss_depth_type: str = "bce"
    loss_seg_weight: float = 0.0
    loss_crp_weight: float = 0.0
    loss_point_ce_weight: float = 0.0
    loss_point_lovasz_weight: float = 0.0
    ohem_topk: float = 0.25
    downsample: int = 8
    dbound: Tuple[float, float, float] = (2.0, 58.0, 0.5)
    stream_voxel_chunks: int = 0


_NOT_PORTED = ("voxel_ohem", "voxel_lovasz", "voxel_dice", "voxel_lga",
               "loss_seg_weight", "loss_crp_weight", "loss_point_ce_weight",
               "loss_point_lovasz_weight", "stream_voxel_chunks")


def compute_losses(outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """All loss terms of one batch, named as the JAX package names them.
    ``outputs['output_voxels']`` is the logits [B, X, Y, Z, C] (the single
    level ``0``); ``batch['gt_occ']`` is [B, X', Y', Z'] with 255 = ignore,
    ``batch['gt_depth']`` [B, N, H, W] sparse LiDAR depth."""
    off = [f for f in _NOT_PORTED if getattr(cfg, f)]
    if off or cfg.loss_depth_type != "bce":
        raise NotImplementedError(
            f"stereoscene_torch ports the active recipe only; set "
            f"{off or ['loss_depth_type']} to its default")
    losses = {}
    gt = batch["gt_occ"]
    logits = outputs["output_voxels"]
    if logits.shape[1:4] != gt.shape[1:4]:
        logits = resize_trilinear(logits.float(), tuple(gt.shape[1:4]))
    if cfg.voxel_ce > 0:
        losses["loss_voxel_ce_0"] = cfg.voxel_ce * ce_ssc_loss(
            logits, gt, class_weights_from_frequencies())
    if cfg.voxel_sem_scal > 0:
        losses["loss_voxel_sem_scal_0"] = (
            cfg.voxel_sem_scal * sem_scal_loss(logits, gt))
    if cfg.voxel_geo_scal > 0:
        losses["loss_voxel_geo_scal_0"] = (
            cfg.voxel_geo_scal * geo_scal_loss(logits, gt))
    if cfg.loss_depth_weight > 0 and "gt_depth" in batch:
        dp = outputs["depth_prob"].permute(0, 2, 3, 1)  # [B, fH, fW, D]
        losses["loss_depth"] = cfg.loss_depth_weight * bce_depth_loss(
            batch["gt_depth"][:, :1], dp, cfg.downsample, cfg.dbound)
    return losses


@contextlib.contextmanager
def bf16_params(model: torch.nn.Module):
    """Within the block every fp32 parameter of ``model`` is replaced by a
    bf16 copy made from it by autograd, so a backward run within the block
    sends the gradients to the fp32 masters."""
    masters = []
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is not None and p.dtype == torch.float32:
                masters.append((module, name, p))
                module._parameters[name] = p.bfloat16()
    try:
        yield
    finally:
        for module, name, p in masters:
            module._parameters[name] = p


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   loss_cfg: LossConfig, bf16: bool = False,
                   use_kernel=None, generator=None):
    """One training forward and backward: (total loss, loss terms, the
    fp32 gradients of ``state.trainable`` in its order). The model runs in
    training mode (the JAX step's ``train=True``, also after an eval put it
    in eval mode) and updates the BatchNorm statistics in place."""
    model = state.model
    model.train()
    params = [p for _, p in state.trainable]
    with bf16_params(model) if bf16 else contextlib.nullcontext():
        inputs = dict(batch, imgs=batch["imgs"].bfloat16()) if bf16 \
            else batch
        outputs = model(inputs, use_kernel=use_kernel, generator=generator)
        losses = compute_losses(outputs, batch, loss_cfg)
        total = sum(losses.values())
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return total.detach(), {k: v.detach() for k, v in losses.items()}, grads


def apply_gradients(state: TrainState, grads: List[torch.Tensor]) -> None:
    """Accumulate (``accumulate_steps``) or clip and take one AdamW update
    at the schedule's LR."""
    state.step += 1
    k = state.accumulate_steps
    if k > 1:
        if state.grad_sum is None:
            state.grad_sum = [g.clone() for g in grads]
        else:
            torch._foreach_add_(state.grad_sum, grads)
        if state.step % k:
            return
        grads = [g / k for g in state.grad_sum]
        state.grad_sum = None
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    # optax clip_by_global_norm: g * clip / norm where norm >= clip
    scale = torch.where(norm < state.grad_clip, torch.ones_like(norm),
                        state.grad_clip / norm)
    for (_, p), g in zip(state.trainable, grads):
        p.grad = g * scale
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.updates)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.updates += 1


def make_train_step(loss_cfg: LossConfig, bf16: bool = False,
                    use_kernel=None) -> Callable:
    """``train_step(state, batch, generator=None) -> (state, logs)``:
    the loss terms and ``loss_total`` as detached tensors. ``generator``
    seeds DropPath and dropout."""

    def train_step(state: TrainState, batch, generator=None):
        total, losses, grads = loss_and_grads(
            state, batch, loss_cfg, bf16, use_kernel, generator)
        apply_gradients(state, grads)
        return state, dict(losses, loss_total=total)

    return train_step
