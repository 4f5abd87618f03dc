"""The training step, port of ``stereoscene_tpu/engine/train.py``.

- ``compute_losses`` (train.py:203-367): every term of the JAX package,
  under its names: voxel CE + sem_scal + geo_scal on the logits upsampled
  trilinearly to the label grid (ref: occhead.py:291-343), or their
  streaming evaluation (``stream_voxel_chunks``), the optional OHEM,
  Lovasz, dice and LGA voxel terms, the BCE or KL depth loss, the imgseg
  CE, the CRP relation loss and the point CE and Lovasz losses.
- ``create_train_state`` (:122-168): AdamW (lr 1e-4, wd 0.01) after a
  global-norm clip at 5, the step LR of ``step_lr_schedule`` (:65-84) with
  optional linear warmup, frozen parameters (``efficientnet_frozen_predicate``)
  and gradient accumulation (``accumulate_steps``, optax ``MultiSteps``:
  the mean of k gradients makes one update).
- ``make_train_step`` (:370-430): value and gradient, then the update
  (``debug_grads`` logs the gradient norm and its nonfinite entries). The
  bf16 policy keeps fp32 master parameters and runs the forward and
  backward on bf16 copies, so gradients land on the masters in fp32;
  losses, norms and softmaxes stay fp32. The copies stand in the modules
  until the backward is done (``torch.func.functional_call`` would take
  them out when the forward returns, and a checkpointed block's recompute
  would then meet the fp32 masters).

State is mutable here: the master parameters are the model's, its
BatchNorm buffers are the batch statistics, and a step updates both in
place.

Data parallel (``parallel``): each rank runs the step on its shard of the
global batch. The losses and BatchNorm statistics pool over the ranks, so
every rank computes the global batch's loss; ``reduce_gradients`` then
averages the ranks' gradients into the gradient of that loss (each rank's
is W times its share, the ``all_sum`` backward summing W equal loss
gradients), which the clip sees, as XLA's all-reduce in the JAX step.
DDP's module wrapper does not fit: ``torch.autograd.grad`` never fires its
reducer hooks, and ``bf16_params`` swaps the parameters inside the step.

Spatial sharding (``parallel.spatial``): the logits are this rank's X slab
and ``compute_losses`` takes the matching slab of the labels; the voxel
terms pool over every rank, the terms that every space rank computes
whole (depth, imgseg, the CRP relation loss, the point losses) over the
data group, and ``reduce_gradients``' mean over all ranks is then the
global gradient (see there). OHEM picks its voxels from the sample's
losses gathered over the space group, dice pools its three sums, and LGA
reads its neighbours' labels through a 1-plane halo. The voxel Lovasz
term is refused on a sharded grid: its sort runs over every voxel of the
batch, which the port does not distribute, and the JAX step cannot give
the term at all (a local import makes ``voxel_lovasz > 0`` raise there).
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
    klv_depth_loss,
    lovasz_softmax,
    ohem_ce_ssc_loss,
    position_aware_loss,
    sem_scal_loss,
    soft_dice_loss,
)
from ..losses.streaming import streaming_voxel_losses
from ..models.crp3d import crp_relation_loss
from ..ops.resize import resize_trilinear
from ..parallel import all_sum, data_group, reduce_gradients, spatial


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


def check_sharding(cfg: LossConfig) -> None:
    """Raise, by name, where the grid is sharded and ``cfg`` weights the
    voxel Lovasz term, whose sort over every voxel of the batch is not
    distributed (and which the JAX step cannot give: its local import
    makes ``voxel_lovasz > 0`` raise)."""
    if spatial.active() and cfg.voxel_lovasz > 0:
        raise ValueError(
            "spatial sharding does not cover the loss term voxel_lovasz "
            "(a sort over every voxel of the batch); set it to 0 or run "
            "unsharded")


def compute_losses(outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """All loss terms of one batch, named as the JAX package names them.
    ``outputs['output_voxels']`` is the logits [B, X, Y, Z, C] (the single
    level ``0``); ``batch['gt_occ']`` is [B, X', Y', Z'] with 255 = ignore,
    ``batch['gt_depth']`` [B, N, H, W] sparse LiDAR depth. Each term that
    divides by a count divides by the global batch's over the ranks."""
    losses = {}
    class_weights = class_weights_from_frequencies()
    gt = batch["gt_occ"]
    logits = outputs["output_voxels"]
    if spatial.active():
        check_sharding(cfg)
        gt = spatial.shard_voxels(gt, dim=1)
    if cfg.stream_voxel_chunks > 0:
        if any((cfg.voxel_ohem, cfg.voxel_lovasz, cfg.voxel_dice,
                cfg.voxel_lga)):
            raise ValueError(
                "stream_voxel_chunks only covers ce/sem_scal/geo_scal; "
                "disable ohem/lovasz/dice/lga or the streaming path")
        terms = streaming_voxel_losses(logits, gt, class_weights,
                                       cfg.stream_voxel_chunks)
        for name in ("ce", "sem_scal", "geo_scal"):
            weight = getattr(cfg, f"voxel_{name}")
            if weight > 0:
                losses[f"loss_voxel_{name}_0"] = weight * terms[name]
    else:
        if logits.shape[1:4] != gt.shape[1:4]:
            logits = _upsample(logits, tuple(gt.shape[1:4]))
        if cfg.voxel_ce > 0:
            losses["loss_voxel_ce_0"] = cfg.voxel_ce * ce_ssc_loss(
                logits, gt, class_weights)
        if cfg.voxel_sem_scal > 0:
            losses["loss_voxel_sem_scal_0"] = (
                cfg.voxel_sem_scal * sem_scal_loss(logits, gt))
        if cfg.voxel_geo_scal > 0:
            losses["loss_voxel_geo_scal_0"] = (
                cfg.voxel_geo_scal * geo_scal_loss(logits, gt))
        if cfg.voxel_ohem > 0:
            losses["loss_voxel_ohem_0"] = cfg.voxel_ohem * ohem_ce_ssc_loss(
                logits, gt, class_weights, cfg.ohem_topk)
        if cfg.voxel_lovasz > 0 or cfg.voxel_dice > 0:
            probs = torch.softmax(logits.float(), dim=-1)
            if cfg.voxel_lovasz > 0:
                losses["loss_voxel_lovasz_0"] = cfg.voxel_lovasz * (
                    lovasz_softmax(probs, gt, ignore=255))
            if cfg.voxel_dice > 0:
                losses["loss_voxel_dice_0"] = cfg.voxel_dice * (
                    soft_dice_loss(1.0 - probs[..., 0], gt))
        if cfg.voxel_lga > 0:
            losses["loss_voxel_lga_0"] = cfg.voxel_lga * (
                position_aware_loss(logits, gt, class_weights))

    if cfg.loss_depth_weight > 0 and "gt_depth" in batch:
        dp = outputs["depth_prob"].permute(0, 2, 3, 1)  # [B, fH, fW, D]
        depth_loss = (klv_depth_loss if cfg.loss_depth_type == "kld"
                      else bce_depth_loss)
        losses["loss_depth"] = cfg.loss_depth_weight * depth_loss(
            batch["gt_depth"][:, :1], dp, cfg.downsample, cfg.dbound)

    if (cfg.loss_seg_weight > 0
            and outputs.get("imgseg_logits") is not None
            and "img_seg" in batch):
        losses["loss_imgseg"] = cfg.loss_seg_weight * _imgseg_loss(
            outputs["imgseg_logits"], batch["img_seg"][:, 0], class_weights)

    if (cfg.loss_crp_weight > 0 and outputs.get("crp_logits") is not None
            and "cp_mega_matrix" in batch):
        losses["loss_rel_ce"] = cfg.loss_crp_weight * crp_relation_loss(
            outputs["crp_logits"], batch["cp_mega_matrix"])

    if ((cfg.loss_point_ce_weight > 0 or cfg.loss_point_lovasz_weight > 0)
            and outputs.get("output_points") is not None
            and "points_occ" in batch):
        losses.update(_point_losses(outputs["output_points"], batch, cfg))
    return losses


def _upsample(logits, out_xyz):
    """fp32 ``logits`` [B, X, Y, Z, C] resized trilinearly to ``out_xyz``;
    on a sharded grid an X slab, resized with one halo plane a side (the
    edge plane repeated at the grid's ends, as the whole resize clamps)
    and cropped to its own planes."""
    logits = logits.float()
    if not spatial.active():
        return resize_trilinear(logits, out_xyz)
    f = out_xyz[0] // logits.shape[1]
    padded = spatial.halo(logits, 1, 1, dim=1, edge="replicate")
    out = resize_trilinear(padded, (out_xyz[0] + 2 * f,) + out_xyz[1:])
    return out[:, f:f + out_xyz[0]]


def _imgseg_loss(seg_logits, seg_gt, class_weights):
    """Image-view seg CE (ref :418-430): the left camera's labels
    nearest-downsampled to the feature grid, class-frequency weighted,
    label 0 ignored. seg_logits [B, fH, fW, C], seg_gt [B, H, W]."""
    seg_logits = seg_logits.float()
    fh, fw = seg_logits.shape[1:3]
    gh, gw = seg_gt.shape[1:]
    dev = seg_logits.device
    ys = (torch.arange(fh, device=dev) * gh) // fh
    xs = (torch.arange(fw, device=dev) * gw) // fw
    seg_gt = seg_gt[:, ys][:, :, xs].long()
    valid = seg_gt != 0
    safe = torch.where(valid, seg_gt, 0)
    nll = -torch.log_softmax(seg_logits, dim=-1).gather(
        -1, safe[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=dev)[safe]
    w = torch.where(valid, w, torch.zeros_like(w))
    num, den = all_sum(torch.stack([(nll * w).sum(), w.sum()]), data_group())
    return num / den.clamp_min(1e-12)


def _point_losses(point_logits, batch, cfg):
    """Point supervision (ref occhead.py:363-399): the labels column of
    points_occ is the target, label 0 ignored (the reference's
    CrossEntropyLoss(ignore_index=0) / lovasz ignore=0), slots past
    points_count masked out. Every space rank holds the whole point
    logits, so the terms pool over the data group."""
    out = {}
    logits = point_logits.float()  # [B, P, C]
    target = batch["points_occ"][..., -1].long()  # [B, P]
    p = target.shape[1]
    if "points_count" in batch:
        in_count = (torch.arange(p, device=target.device)[None, :]
                    < batch["points_count"].reshape(-1, 1))
    else:
        in_count = torch.ones_like(target, dtype=torch.bool)
    valid = in_count & (target != 0)
    if cfg.loss_point_ce_weight > 0:
        safe = torch.where(valid, target, 0)
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, safe[..., None])[..., 0]
        validf = valid.float()
        num, den = all_sum(torch.stack([(nll * validf).sum(),
                                        validf.sum()]), data_group())
        out["loss_point_ce"] = cfg.loss_point_ce_weight * (
            num / den.clamp_min(1.0))
    if cfg.loss_point_lovasz_weight > 0:
        # fold the padding into the ignore label (0)
        labels = torch.where(in_count, target, 0)
        out["loss_point_lovasz"] = cfg.loss_point_lovasz_weight * (
            lovasz_softmax(torch.softmax(logits, dim=-1), labels, ignore=0,
                           group=data_group()))
    return out


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


def grad_diagnostics(grads: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``grad_norm`` (the global L2 norm, fp32) and ``grad_nonfinite``
    (the count of NaN or infinite entries, as fp32): the JAX step's
    ``debug_grads`` logs (ref: models/hooks/hooks.py GradChecker)."""
    grads = [g.float() for g in grads]
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    nonfinite = torch.stack([(~torch.isfinite(g)).sum() for g in grads])
    return {"grad_norm": norm, "grad_nonfinite": nonfinite.sum().float()}


def make_train_step(loss_cfg: LossConfig, bf16: bool = False,
                    use_kernel=None, debug_grads: bool = False) -> Callable:
    """``train_step(state, batch, generator=None) -> (state, logs)``:
    the loss terms and ``loss_total`` as detached tensors (the global
    batch's, equal on every rank), with ``debug_grads`` also
    ``grad_diagnostics`` of the step's gradient (the ranks' mean, before
    the clip). ``generator`` seeds DropPath and dropout."""

    def train_step(state: TrainState, batch, generator=None):
        total, losses, grads = loss_and_grads(
            state, batch, loss_cfg, bf16, use_kernel, generator)
        grads = reduce_gradients(grads)
        logs = dict(losses, loss_total=total)
        if debug_grads:
            logs.update(grad_diagnostics(grads))
        apply_gradients(state, grads)
        return state, logs

    return train_step
