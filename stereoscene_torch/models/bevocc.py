"""BEVOcc: the camera-only BEVFormer-style occupancy detector, port of
``stereoscene_tpu/models/bevocc.py`` (ref: occupancy/detectors/bevocc.py,
bevocc_kitti.py, dense_heads/bevocc_head.py).

- ``LearnedPositionalEncoding``: learned column and row tables, each cell
  the concat (column, row) (ref: bevocc_head.py:1048-1080).
- ``BEVOccupancyHead``: ``fpn_level`` planes of learned BEV queries, level
  i at ``bev_shape * 2^i`` (coarsest first, the JAX package's order; the
  reference indexes them the other way), each refined by an
  ``OccupancyEncoder`` over the camera features, lifted channel-to-height
  by a Linear into a 3D grid, fused coarse to fine by stride-2
  ConvTranspose3d, GroupNorm and ReLU before the skip add, and decoded by a
  3x3x3 conv per level.
- ``BEVOcc`` (alias ``BEVOcc_kitti``): EfficientNet (``out_indices=(5,)``),
  a Linear neck, then the head. KITTI feeds one camera, the left eye.
- ``mode_pool`` / ``bevocc_loss``: ground truth majority-pooled to each
  scale (ignore is its own bucket, ties go to the lowest class), weighted
  CE (class 0 weight 0.1, ignore 255) or BCE with pos_weight 10 for the
  binary variant, scale k weighted 0.5^k from the finest.

Voxel tensors at the interface are channels-last as in the JAX package:
``occ_preds`` holds [B, X_i, Y_i, Z_i, C] coarsest first. Parameter keys
follow the JAX module paths (``pts_bbox_head.transformer0.layer1.
cross_attn.deform.value_proj.weight``), the image backbone keeps the
reference's ``img_backbone.layers.N`` keys; ``utils.weights`` maps both.
Models are built on the CUDA card unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .bevformer import OccupancyEncoder
from .efficientnet import CustomEfficientNet, scaled_stage_settings
from .layers import Conv3d, GroupNorm


class LearnedPositionalEncoding(nn.Module):
    """Row / column learned position embeddings -> [h * w, 2 F]."""

    def __init__(self, num_feats: int, row_num_embed: int,
                 col_num_embed: int):
        super().__init__()
        self.num_feats = num_feats
        self.row_embed = nn.Parameter(torch.rand(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.rand(col_num_embed, num_feats))

    def forward(self, h: int, w: int) -> torch.Tensor:
        f = self.num_feats
        pos = torch.cat([self.col_embed[None, :w].expand(h, w, f),
                         self.row_embed[:h, None].expand(h, w, f)], dim=-1)
        return pos.reshape(h * w, 2 * f)


class BEVOccupancyHead(nn.Module):
    """Multi-scale BEV-query occupancy head (ref: bevocc_head.py:39-698).
    ``in_channels`` is the width of the camera features."""

    def __init__(self, in_channels: int, embed_dim: int = 128,
                 fpn_level: int = 2, bev_shape: Tuple[int, int] = (16, 16),
                 num_z: int = 2, out_channel: int = 20,
                 use_semantic: bool = True, pred_ground: bool = False,
                 num_encoder_layers: int = 2, norm_groups: int = 8,
                 pc_range: Sequence[float] = (0.0, -25.6, -2.0, 51.2, 25.6,
                                              4.4)):
        super().__init__()
        self.embed_dim = embed_dim
        self.fpn_level = fpn_level
        self.bev_shape = tuple(bev_shape)
        self.num_z = num_z
        self.pred_ground = pred_ground
        h0, w0 = self.bev_shape
        c_occ = out_channel if use_semantic else 1
        for i in range(fpn_level):
            s = 2 ** i
            h, w = h0 * s, w0 * s
            setattr(self, f"transfer_conv{i}",
                    nn.Linear(in_channels, embed_dim))
            setattr(self, f"positional_encoding{i}",
                    LearnedPositionalEncoding(embed_dim // 2, h, w))
            setattr(self, f"transformer{i}", OccupancyEncoder(
                embed_dim=embed_dim, num_layers=num_encoder_layers,
                bev_shape=(h, w), num_z=num_z * s, pc_range=pc_range))
            setattr(self, f"lift{i}",
                    nn.Linear(embed_dim, num_z * s * embed_dim))
            setattr(self, f"occ{i}", Conv3d(embed_dim, c_occ, 3, padding=1))
            if pred_ground:
                setattr(self, f"ground{i}", Conv3d(embed_dim, 1, 3,
                                                   padding=1))
        for k in range(1, fpn_level):
            setattr(self, f"deblock{k}_deconv", nn.ConvTranspose3d(
                embed_dim, embed_dim, 2, stride=2, bias=False))
            setattr(self, f"deblock{k}_gn", GroupNorm(norm_groups, embed_dim))

    def forward(self, img_feats, spatial_shapes, lidar2img, img_size,
                prev_bev=None) -> Dict[str, Any]:
        """img_feats [B, N_cam, sum(HW), C_in] -> ``occ_preds`` (coarsest
        first, [B, X_i, Y_i, Z_i, C_occ]), ``bev_embed`` (the finest lifted
        grid, [B, X, Y, Z, embed]) and, with ``pred_ground``,
        ``ground_preds``."""
        b = img_feats.shape[0]
        h0, w0 = self.bev_shape
        levels = []
        for i in range(self.fpn_level):
            s = 2 ** i
            h, w, z = h0 * s, w0 * s, self.num_z * s
            feats = getattr(self, f"transfer_conv{i}")(img_feats)
            pos = getattr(self, f"positional_encoding{i}")(h, w)
            bev = getattr(self, f"transformer{i}")(
                feats, spatial_shapes, lidar2img, img_size,
                prev_bev=prev_bev, query_pos=pos)
            vol = getattr(self, f"lift{i}")(bev)
            levels.append(vol.reshape(b, h, w, z, self.embed_dim))
        # coarse-to-fine deblock fusion (ref: bevocc_head.py:640-658)
        outputs = [levels[0].permute(0, 4, 1, 2, 3)]
        result = outputs[0]
        for k in range(1, self.fpn_level):
            result = getattr(self, f"deblock{k}_deconv")(result)
            result = F.relu(getattr(self, f"deblock{k}_gn")(result))
            result = result + levels[k].permute(0, 4, 1, 2, 3)
            outputs.append(result)
        res = {"occ_preds": [getattr(self, f"occ{i}")(out).permute(
                   0, 2, 3, 4, 1) for i, out in enumerate(outputs)],
               "bev_embed": levels[-1]}
        if self.pred_ground:
            res["ground_preds"] = [
                getattr(self, f"ground{i}")(out).permute(0, 2, 3, 4, 1)
                for i, out in enumerate(outputs)]
        return res


class BEVOcc(nn.Module):
    """Camera-to-occupancy detector (ref: bevocc.py:25-587). ``head`` holds
    ``BEVOccupancyHead``'s keyword arguments less ``in_channels``."""

    def __init__(self, head: Dict[str, Any], backbone: str = "efficientnet-b0",
                 neck_out: int = 64, device=None):
        super().__init__()
        if not backbone.startswith("efficientnet-"):
            raise ValueError(backbone)
        self.head = dict(head)
        self.backbone = backbone
        arch = backbone.split("-")[1]
        self.img_backbone = CustomEfficientNet(arch, out_indices=(5,))
        c5 = scaled_stage_settings(arch)[1][4][-1][1]
        self.img_neck = nn.Linear(c5, neck_out)
        self.pts_bbox_head = BEVOccupancyHead(neck_out, **head)
        self.to(torch.device("cuda") if device is None else device)
        self.eval()

    def forward(self, imgs: torch.Tensor,
                lidar2img: torch.Tensor) -> Dict[str, Any]:
        """imgs [B, N_cam, H, W, 3] (channels-last); lidar2img
        [B, N_cam, 3, 4]. Training mode takes BatchNorm's batch
        statistics, as the JAX package's ``train=True``."""
        b, n = imgs.shape[:2]
        flat = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
        feats = self.img_backbone(flat)[-1].permute(0, 2, 3, 1)
        feats = self.img_neck(feats)
        fh, fw = feats.shape[1:3]
        img_feats = feats.reshape(b, n, fh * fw, feats.shape[-1])
        return self.pts_bbox_head(img_feats, ((fh, fw),), lidar2img,
                                  (imgs.shape[2], imgs.shape[3]))


BEVOcc_kitti = BEVOcc  # the KITTI wiring: one camera (bevocc_kitti.py:25)


def bevocc_from_config(cfg: Dict[str, Any], device=None) -> BEVOcc:
    """A BEVOcc from a reference-style config (configs/bevocc_kitti.py;
    the head keys are the reference BEVOccHead's, bevocc_head.py:51-105),
    built on ``device`` (the CUDA card by default)."""
    model = cfg["model"]
    h = model["pts_bbox_head"]
    head = dict(
        embed_dim=h.get("embed_dims", 128),
        fpn_level=h.get("fpn_level", 2),
        bev_shape=(h["bev_h"], h["bev_w"]),
        num_z=h.get("bev_z", 4),
        out_channel=h["out_channel"],
        use_semantic=h.get("use_semantic", True),
        pred_ground=h.get("pred_ground", False),
        num_encoder_layers=h.get("encoder_layers", 2),
        norm_groups=h.get("norm_groups", 8),
        pc_range=tuple(h["point_cloud_range"]),
    )
    return BEVOcc(head=head,
                  backbone=f"efficientnet-{model['img_backbone']['arch']}",
                  neck_out=model.get("img_neck_out_channels", 64),
                  device=device)


def mode_pool(gt: torch.Tensor, ratio: int, num_classes: int,
              ignore: int = 255) -> torch.Tensor:
    """Majority label of each ratio^3 block of gt [B, X, Y, Z]; ignore
    counts as its own bucket (a fully ignored block stays ignored) and a
    tie goes to the lowest class (ref: bevocc_head.py:825-829)."""
    if ratio == 1:
        return gt
    b, x, y, z = gt.shape
    r = ratio
    blocks = gt.reshape(b, x // r, r, y // r, r, z // r, r).permute(
        0, 1, 3, 5, 2, 4, 6).reshape(b, x // r, y // r, z // r, r ** 3)
    capped = torch.where(blocks == ignore, num_classes, blocks.long())
    buckets = torch.arange(num_classes + 1, device=gt.device)
    counts = (capped[..., None] == buckets).sum(dim=-2)
    mode = counts.argmax(dim=-1)  # the first maximum: the lowest class
    return torch.where(mode == num_classes, ignore, mode).to(gt.dtype)


def bevocc_loss(occ_preds: List[torch.Tensor], gt_occ: torch.Tensor,
                use_semantic: bool = True, num_classes: int = 20,
                iou_loss: bool = False, no_decay: bool = False,
                ignore: int = 255) -> Dict[str, torch.Tensor]:
    """Multi-scale occupancy supervision (ref: bevocc_head.py:705-1045):
    ``loss_occ_i`` for each scale of ``occ_preds`` (coarsest first), and
    ``loss_iou`` with ``iou_loss``; ``gt_occ`` [B, X, Y, Z] at the finest
    scale."""
    n = len(occ_preds)
    losses: Dict[str, torch.Tensor] = {}
    loss_iou = 0.0
    for i, pred in enumerate(occ_preds):
        decay = 1.0 if no_decay else 0.5 ** (n - 1 - i)
        gt = mode_pool(gt_occ, 2 ** (n - 1 - i), num_classes, ignore)
        valid = gt != ignore
        validf = valid.float()
        if use_semantic:
            logits = pred.float()
            gt_safe = torch.where(valid, gt, 0).long()
            weights = torch.ones(num_classes, device=pred.device)
            weights[0] = 0.1
            nll = -torch.log_softmax(logits, dim=-1).gather(
                -1, gt_safe[..., None])[..., 0]
            w = weights[gt_safe] * validf
            losses[f"loss_occ_{i}"] = (
                (nll * w).sum() / torch.clamp(w.sum(), min=1.0) * decay)
            if iou_loss:
                prob = torch.softmax(logits, dim=-1)
                li = 0.0
                for j in range(1, num_classes):
                    gj = (gt_safe == j).float() * validf
                    pj = prob[..., j] * validf
                    inter = (pj * gj).sum()
                    li = li + 1.0 - (2 * inter + 1e-7) / (
                        pj.sum() + gj.sum() + 1e-7)
                loss_iou = loss_iou + li / (num_classes - 1)
        else:
            logits = pred[..., 0].float()
            occ = ((gt >= 1) & valid).float()
            ce = 10.0 * occ * F.softplus(-logits) \
                + (1.0 - occ) * F.softplus(logits)
            losses[f"loss_occ_{i}"] = (
                (ce * validf).sum() / torch.clamp(validf.sum(), min=1.0)
                * decay)
            if iou_loss:
                prob = torch.sigmoid(logits) * validf
                inter = (prob * occ).sum()
                loss_iou = loss_iou + 3.0 * (
                    1.0 - (2 * inter + 1e-7)
                    / (prob.sum() + occ.sum() + 1e-7))
    if iou_loss:
        losses["loss_iou"] = torch.as_tensor(loss_iou, dtype=torch.float32)
    return losses
