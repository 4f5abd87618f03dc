"""The StereoScene family: the program's stereo ``BEVDepthOccupancy``
(``stereoscene_torch/models/detector.py``) against the plain reference of
``reference/model.py``.

Seeded weights: the image backbone's residual branches enter at 0.3 of
their scale (the scale and shift of each MBConv block's last BatchNorm),
as EfficientNet's training starts them near zero. With every branch at
full scale the 55 blocks of b7 are chaotic under random weights: the
activations grow to 1e6 and bfloat16 rounding grows with them until the
image features differ from float32 by most of their size, so no
comparison could tell a sound bfloat16 run from a broken one. For the
same reason the three convolutions that feed a softmax over the 112 depth
bins start at 0.3 of their scale: at full scale some seeds gave the MIE's
fused depth distribution a mean peak of 0.58 with nearly tied bins, where
bfloat16 rounding moves a pixel's depth and with it the voxel features it
lifts (the fused distribution 5.7% off float32 where the inputs were 1.3%
off), so a sound run read as far from the reference as float8 does.

Serving numbers (per sampled frame, the worst over the sample):

- ``depth_gap``: the total variation distance between the program's
  fused depth distribution and the reference's, averaged over the
  pixels (half the summed absolute gap over the depth bins);
- ``logit_gap``: the root-mean-square gap between the program's voxel
  logits and the reference's, over the reference logits' root mean
  square;
- ``class_gap``: at each voxel of the served class map, how far the
  reference's logit for the served class (the reference's logits
  upsampled to the label grid) lies below its best, over the reference's
  largest logit magnitude; the widest such gap. A flip between two
  near-equal logits reads about the logits' rounding; a wrong answer
  reads the logits' spread.

The first two are means, not widest gaps: a few pixels whose depth
softmax is nearly tied move by most of a probability under any rounding,
so the widest gap of a sound bfloat16 run reached what float8 reads.

Training compares the first step's image backbone stage 2 (its first
feature map, stride 8; ``stage2_gap``) and voxel logits (``logit1_gap``)
beside the numbers every family has (``check.py``), and judges two stages
of that step alone, each from what the program fed it (``STAGE_NUMBERS``):

- ``bev_gap``: the reference's voxel side (encoder, neck, head) run on the
  voxel features the program's voxel side was fed, against the program's
  logits (relative RMS gap): the voxel side's own precision, which the
  end-to-end ``logit1_gap`` mixes with every stage upstream;
- ``loss_outputs_gap``: the reference's loss terms on the program's
  logits and fused depth distribution and the step's labels, against the
  program's first loss (relative gap): the streaming loss's slabs and
  sums.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..check import rms
from ..reference import model as reference
from ..reference.losses import losses

# the last norm of each MBConv residual branch, and the three convolutions
# whose outputs a softmax over the depth bins turns into a distribution
# (DepthNet's depth head, the stereo volume's head, the MIE's last conv)
DAMPED = ("linear_conv.bn.weight", "linear_conv.bn.bias",
          "depth_net.depth_conv.5.weight", "depth_net.depth_conv.5.bias",
          "classif3_2.0.weight", "volume_interaction.redir2.weight",
          "volume_interaction.redir2.bias")

# what the serving hooks keep: the view transformer's fused depth
# distribution and the head's voxel logits
SERVE_OUTPUTS = {"depth_prob": ("img_view_transformer", lambda out: out[1]),
                 "logits": ("pts_bbox_head", lambda out: out)}
STAGES = (("images", "img_backbone"), ("view", "img_view_transformer"),
          ("bev", "img_bev_encoder_backbone"))
SERVE_NUMBERS = ("depth_gap", "logit_gap", "class_gap")
# the outputs of the first training step that the comparison reads: the
# image backbone's stage 2 (its first feature map, stride 8) and the logits
FIRST_OUTPUTS = {"stage2": "img_backbone.layers.2", "logit1": "pts_bbox_head"}
STAGE_NUMBERS = ("bev_gap", "loss_outputs_gap")


def build_program(config: Dict, device):
    """The program's detector for ``config`` on ``device`` (float32)."""
    from stereoscene_torch.models.detector import (BEVDepthOccupancy,
                                                   DetectorConfig)

    det = DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in config["model"].items()})
    with torch.device(device):
        model = BEVDepthOccupancy(det, device=device,
                                  label_shape=tuple(config["label_shape"]))
    return model


build_reference = reference.build


def num_classes(config: Dict) -> int:
    return config["model"]["out_channel"]


def classes_of(outputs: Dict[str, torch.Tensor], label_shape):
    return reference.upsample(outputs["logits"], label_shape).argmax(1)


@torch.no_grad()
def serve_frame(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                classes: torch.Tensor, label_shape) -> Dict[str, float]:
    """Gaps of one frame: ``prog`` holds the program's ``logits`` [1, C, X,
    Y, Z] and ``depth_prob``, ``ref`` the reference's, ``classes`` the
    served class map [1, *label_shape] (any device)."""
    scale = float(ref["logits"].abs().max())
    up = reference.upsample(ref["logits"], label_shape)[0]  # [C, ...]
    cls = classes.to(up.device).long()[0]
    num = up.shape[0]
    if tuple(cls.shape) != tuple(label_shape) or int(cls.min()) < 0 \
            or int(cls.max()) >= num:
        return dict.fromkeys(SERVE_NUMBERS, float("inf"))
    served = up.gather(0, cls[None])[0]
    dp, dr = prog["depth_prob"].float(), ref["depth_prob"]
    lp, lr = prog["logits"].float(), ref["logits"]
    return {"depth_gap": float(0.5 * (dp - dr).abs().sum(1).mean()),
            "logit_gap": float(rms(lp - lr) / rms(lr)),
            "class_gap": float((up.amax(0) - served).max()) / scale}


def loss_config(cfg: Dict):
    from stereoscene_torch.engine.train import LossConfig

    w, m = cfg["loss_weights"], cfg["model"]
    return LossConfig(voxel_ce=w["voxel_ce"],
                      voxel_sem_scal=w["voxel_sem_scal"],
                      voxel_geo_scal=w["voxel_geo_scal"],
                      loss_depth_weight=w["depth"], loss_depth_type="bce",
                      stream_voxel_chunks=w.get("stream_voxel_chunks", 0),
                      downsample=m["downsample"], dbound=tuple(m["dbound"]))


def train_program(model, config: Dict, device):
    """The program's train state and step (``engine.train``) in the
    configuration's precision policy."""
    from stereoscene_torch.engine.train import (create_train_state,
                                                make_train_step)

    opt = config["optimizer"]
    state = create_train_state(model, lr=opt["lr"],
                               weight_decay=opt["weight_decay"],
                               grad_clip=opt["grad_clip"], device=device)
    step = make_train_step(loss_config(config), bf16=config["precision"]
                           == "bfloat16")
    return state, step


def reference_losses(outputs, batch, config: Dict):
    m = config["model"]
    return losses(outputs, batch, config["loss_weights"], m["downsample"],
                  m["dbound"])


class FirstStage:
    """Hooks that keep, from a model's first training forward, the voxel
    features its voxel side was fed and its fused depth distribution,
    each moved to the host."""

    def __init__(self, model):
        self.out: Dict[str, torch.Tensor] = {}
        enc = model.get_submodule("img_bev_encoder_backbone.input_proj")
        view = model.get_submodule("img_view_transformer")
        self.handles = [
            enc.register_forward_pre_hook(
                lambda _m, args: self._keep("vox", args[0])),
            view.register_forward_hook(
                lambda _m, _i, out: self._keep("depth_prob", out[1]))]

    def _keep(self, key, t):
        if key not in self.out:  # a recompute comes later
            self.out[key] = t.detach().to("cpu", copy=True)

    def remove(self) -> Dict[str, torch.Tensor]:
        for h in self.handles:
            h.remove()
        return self.out


@torch.no_grad()
def stage_gaps(ref, first: Dict, batch, config: Dict) -> Dict[str, float]:
    """``first`` holds a ``FirstStage``'s tensors, the first step's
    ``logit1`` and its total loss ``loss1``; ``ref`` is the reference at
    the step's weights and ``batch`` the step's batch."""
    dev = next(ref.parameters()).device
    want = ref.pts_bbox_head(ref.img_bev_encoder_neck(
        ref.img_bev_encoder_backbone(first["vox"].to(dev).float())))
    logits = first["logit1"].to(dev)
    bev = float(rms(logits - want) / rms(want)) \
        if logits.shape == want.shape else float("inf")
    del want
    if logits.shape[0] != batch["gt_occ"].shape[0]:
        return {"bev_gap": bev, "loss_outputs_gap": float("inf")}
    terms = reference_losses({"logits": logits, "depth_prob":
                              first["depth_prob"].to(dev).float()},
                             batch, config)
    total = float(sum(terms.values()))
    return {"bev_gap": bev,
            "loss_outputs_gap": abs(first["loss1"] - total)
            / max(abs(total), 1e-30)}


def flop_inputs(net, model_cfg: Dict, batch: int):
    """An eval forward of ``batch`` frames, the voxel ranks of the frustum
    (a function of the calibration alone, which the program builds once
    on the host) made outside the count."""
    h, w = model_cfg["input_size"]
    inputs = {"imgs": torch.empty(batch, 2, h, w, 3),
              "rots": torch.empty(batch, 2, 3, 3),
              "trans": torch.empty(batch, 2, 3),
              "intrins": torch.empty(batch, 2, 3, 4),
              "post_rots": torch.empty(batch, 2, 3, 3),
              "post_trans": torch.empty(batch, 2, 3),
              "bda": torch.empty(batch, 3, 3),
              "calib": torch.empty(batch)}
    return (inputs,), {"ranks": net.ranks(inputs)}
