"""The StereoScene trunk with OccFormer's Mask2Former occupancy head: the
program's ``BEVDepthOccupancy`` with ``head_type`` ``Mask2FormerOccHead``
(``stereoscene_torch/models/detector.py``, ``models/mask2former_occ.py``)
against the plain reference of ``reference/stereoscene_m2f.py``. It
serves only: the program does not train this head yet.

Seeded weights: the trunk's are damped as the StereoScene family damps
them (``stereoscene.DAMPED``, which says why). The pixel decoder's
sampling offsets and attention weights, which the program starts at zero,
take the He-uniform scale of every linear layer (``weights.make``):
offsets of about 1.7 voxels' standard deviation at each level and
attention logits of about the same, so the comparison reads samples away
from the reference points and their weights, not one voxel under equal
weights. The head damps two groups (``HEAD_DAMPED``):

- the query decoder's residual branches (the attention values and output
  projections, the FFNs' second layer): undamped, the attention output,
  common to every query, outweighs the learned queries at He scale, and
  after the first post-norm layer the 100 queries are one, with one mask;
- the mask MLP (``mask_head0``-``2``): undamped, the mask logits run to
  tens, every sigmoid is 0 or 1 and ``semantic_inference`` reads only
  their signs.

The query decoder is judged on what the program fed it, as training's
stage numbers judge a stage. Its attention mask is a threshold at 0, and
a query with a few voxels unmasked is ill-conditioned: a rounding that
moves one voxel across changes that query's attention by most of its
size, and self-attention passes that on to every query, so a
free-running reference can part from a sound program by more than a
float8 one does. So the reference's decoder (``Head.decode``) runs on the
program's memories and mask features, each layer given the attention
mask that the program's layer was given, and the masks themselves are
held apart: each against the one the reference's rule gives from that
run's own last prediction. The pixel decoder and the trunk are judged
free-running, by ``feature_gap``.

Serving numbers (per sampled frame, the worst over the sample):

- ``depth_gap``: the StereoScene family's: the mean total variation
  distance of the fused depth distribution;
- ``feature_gap``: the root-mean-square gap of the pixel decoder's mask
  features [X, Y, Z, C] over the reference's root mean square: the
  trunk, the 3D encoder, the deformable encoder and the FPN fuse;
- ``mask_gap``: the same of the last mask logits [Q, X, Y, Z], against
  the reference's decoder on what the program fed its own;
- ``sem_gap``: the same of the ``semantic_inference`` probabilities on
  the head's grid, which weigh each mask by its query's class softmax;
- ``class_gap``: at each voxel of the served class map, how far the
  reference's score for the served class (its mask logits upsampled to
  the label grid, then ``semantic_inference``) lies below its best, over
  the reference's largest score; the widest such gap;
- ``attn_mask_gap``: the share of the attention-mask entries (query,
  voxel, layer) that the program gave its layers and the reference's
  rule, from the same run's predictions, sets otherwise.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..check import rms
from ..reference import stereoscene_m2f as reference
from . import stereoscene

HEAD_DAMPED = tuple(
    f"{module}.{tensor}"
    for module in ("cross_attn.v_proj", "cross_attn.out_proj",
                   "self_attn.value", "self_attn.out", "ffn.fc2",
                   "mask_head0", "mask_head1", "mask_head2")
    for tensor in ("weight", "bias"))
DAMPED = stereoscene.DAMPED + HEAD_DAMPED

# what the serving hooks keep: the fused depth distribution, the pixel
# decoder's mask features and its first three outputs (the query
# decoder's memories, coarsest first, where it attends three levels), the
# head's last prediction and the attention mask each decoder layer was
# given
SERVE_OUTPUTS = {
    "depth_prob": ("img_view_transformer", lambda out: out[1]),
    "mask_features": ("pts_bbox_head.pixel_decoder", lambda out: out[0]),
    **{f"memory{i}": ("pts_bbox_head.pixel_decoder",
                      lambda out, i=i: out[1][i]) for i in range(3)},
    "cls_logits": ("pts_bbox_head", lambda out: out["cls_logits"]),
    "mask_logits": ("pts_bbox_head", lambda out: out["mask_logits"]),
    "attn_masks": ("pts_bbox_head",
                   lambda out: torch.cat(out["attn_masks"], -1))}
STAGES = stereoscene.STAGES
SERVE_NUMBERS = ("depth_gap", "feature_gap", "mask_gap", "sem_gap",
                 "class_gap", "attn_mask_gap")

build_program = stereoscene.build_program
num_classes = stereoscene.num_classes
flop_inputs = stereoscene.flop_inputs

# the float32 reference that ``build_reference`` made last on a device
# that computes (the meta device's, built for shapes, aside):
# ``serve_frame`` runs its decoder on the masks a run gave its own
_FLOAT32: Dict[str, reference.M2FDetector] = {}


def build_reference(model_cfg: Dict, device, quantizer=None,
                    checkpoint_blocks: bool = False):
    ref = reference.build(model_cfg, device, quantizer, checkpoint_blocks)
    if quantizer is None and torch.device(device).type != "meta":
        _FLOAT32["model"] = ref
    return ref


def classes_of(outputs: Dict[str, torch.Tensor], label_shape):
    return reference.scores(outputs, label_shape).argmax(1)


@torch.no_grad()
def serve_frame(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                classes: torch.Tensor, label_shape) -> Dict[str, float]:
    """Gaps of one frame: ``prog`` holds the program's ``depth_prob``,
    ``mask_features`` [1, X, Y, Z, C], the memories ``memory<i>`` [1, X,
    Y, Z, C], ``cls_logits`` [1, Q, classes + 1], ``mask_logits`` [1, Q,
    X, Y, Z] and ``attn_masks`` [1, Q, V1 + ... + Vn], ``ref`` the outputs
    of the float32 reference that ``build_reference`` made last,
    ``classes`` the served class map [1, *label_shape] (any device)."""
    if "model" not in _FLOAT32:
        raise RuntimeError("no float32 reference built: build_reference "
                           "first")
    head = _FLOAT32["model"].pts_bbox_head
    dev = ref["mask_logits"].device
    given = prog["attn_masks"].to(dev)
    forced = head.decode(
        prog["mask_features"].to(dev, torch.float32).movedim(-1, 1),
        [prog[f"memory{i}"].to(dev, torch.float32).movedim(-1, 1)
         for i in range(head.levels)], given)
    up = reference.scores(forced, label_shape)[0]  # [C, ...]
    cls = classes.to(up.device).long()[0]
    if tuple(cls.shape) != tuple(label_shape) or int(cls.min()) < 0 \
            or int(cls.max()) >= up.shape[0]:
        return dict.fromkeys(SERVE_NUMBERS, float("inf"))
    best = up.amax(0)
    class_gap = float((best - up.gather(0, cls[None])[0]).max()
                      / best.max())
    del up, best
    fp, fr = prog["mask_features"].float(), ref["mask_features"]
    mp, mr = prog["mask_logits"].float(), forced["mask_logits"]
    sp = reference.semantic(prog["cls_logits"].float(), mp)
    sr = reference.semantic(forced["cls_logits"], mr)
    dp, dr = prog["depth_prob"].float(), ref["depth_prob"]
    return {"depth_gap": float(0.5 * (dp - dr).abs().sum(1).mean()),
            "feature_gap": float(rms(fp - fr) / rms(fr)),
            "mask_gap": float(rms(mp - mr) / rms(mr)),
            "sem_gap": float(rms(sp - sr) / rms(sr)),
            "class_gap": class_gap,
            "attn_mask_gap": float((given != forced["own_masks"])
                                   .float().mean())}
