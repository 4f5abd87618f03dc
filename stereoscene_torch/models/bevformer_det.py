"""BEVFormer detection stack, port of ``stereoscene_tpu/models/
bevformer_det.py`` (ref: bevformer/dense_heads/bevformer_head.py:29-560,
bevformer/modules/decoder.py:52-130, bevformer/detectors/bevformer.py).

- ``DetectionDecoderLayer``: self-attention over the object queries,
  deformable cross-attention into the BEV memory (``bevformer.
  DeformableAttention``, plain gathers), FFN; post-norm.
- ``BEVFormerHead``: learned queries decoded layer by layer; with
  ``with_box_refine`` each layer has its own branches and the reference
  points move to the layer's prediction, detached (decoder.py:115).
- ``BEVFormerDetector``: image features -> ``bevformer.OccupancyEncoder``
  (``prev_bev``, ``can_bus``) -> head; ``only_bev`` runs the encoder alone.
- ``obtain_history_bev`` / ``PrevFrameInfo``: the temporal state in
  training (a no-grad queue of past frames) and at test time.
- The loss (sigmoid focal + L1, Hungarian-matched per layer on the host)
  and ``bevformer_get_bboxes`` (the NMS-free coder).

The head emits boxes in the reference layout (cx, cy, logw, logl, cz,
logh, sin, cos, vx, vy); ``core.bbox3d.normalize_bbox`` puts cz at index 2.
The loss and ``bevformer_get_bboxes`` reorder between them as JAX does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox3d import decode_nms_free, normalize_bbox
from .bevformer import DeformableAttention, LayerNorm32, OccupancyEncoder
from .mask2former_occ import hungarian_match
from .vit import Attention


def inverse_sigmoid(x, eps: float = 1e-5):
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


class DetectionDecoderLayer(nn.Module):
    """mmcv's ('self_attn', 'norm', 'cross_attn', 'norm', 'ffn', 'norm')
    over the object queries (ref decoder.py:131-260)."""

    def __init__(self, embed_dim: int, num_heads: int = 8,
                 num_points: int = 4, ffn_ratio: int = 2):
        super().__init__()
        self.self_attn = Attention(embed_dim, num_heads)
        self.norm1 = LayerNorm32(embed_dim)
        self.cross_attn = DeformableAttention(embed_dim, num_heads,
                                              num_points, num_levels=1)
        self.norm2 = LayerNorm32(embed_dim)
        self.ffn1 = nn.Linear(embed_dim, embed_dim * ffn_ratio)
        self.ffn2 = nn.Linear(embed_dim * ffn_ratio, embed_dim)
        self.norm3 = LayerNorm32(embed_dim)

    def forward(self, query, query_pos, bev_memory, bev_shape, ref_2d):
        """query [B, Q, C]; bev_memory [B, H*W, C]; ref_2d [B, Q, 2]."""
        q = query + query_pos
        query = self.norm1(query + self.self_attn(q, q, query))
        cross = self.cross_attn(query + query_pos, bev_memory, [bev_shape],
                                ref_2d[:, :, None, :])
        query = self.norm2(query + cross)
        return self.norm3(query + self.ffn2(F.relu(self.ffn1(query))))


class BEVFormerHead(nn.Module):
    """Object queries decoded against the BEV memory with iterative
    reference-point refinement (ref bevformer_head.py:130-225).

    Returns ``all_cls_scores`` [L, B, Q, num_classes] and
    ``all_bbox_preds`` [L, B, Q, code_size]: (cx, cy) and cz in metres
    inside ``pc_range``, log sizes, (sin, cos), velocity."""

    def __init__(self, num_classes: int = 10, num_query: int = 100,
                 embed_dim: int = 128, num_decoder_layers: int = 3,
                 num_heads: int = 8, code_size: int = 10,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 with_box_refine: bool = True):
        super().__init__()
        c = embed_dim
        self.embed_dim = embed_dim
        self.num_decoder_layers = num_decoder_layers
        self.with_box_refine = with_box_refine
        self.pc_range = tuple(float(v) for v in pc_range)
        self.query_embedding = nn.Parameter(torch.randn(num_query, 2 * c))
        self.reference_points = nn.Linear(c, 3)
        # per-layer branches when refining, one shared set otherwise
        for i in range(num_decoder_layers if with_box_refine else 1):
            for j in range(2):
                setattr(self, f"cls{i}_fc{j}", nn.Linear(c, c))
                setattr(self, f"cls{i}_ln{j}", LayerNorm32(c))
                setattr(self, f"reg{i}_fc{j}", nn.Linear(c, c))
            cls_out = nn.Linear(c, num_classes)
            nn.init.constant_(cls_out.bias, -2.0)
            setattr(self, f"cls{i}_out", cls_out)
            setattr(self, f"reg{i}_out", nn.Linear(c, code_size))
        for i in range(num_decoder_layers):
            setattr(self, f"layer{i}", DetectionDecoderLayer(c, num_heads))

    def forward(self, bev_memory, bev_shape: Tuple[int, int]):
        b = bev_memory.shape[0]
        c = self.embed_dim
        qe = self.query_embedding[None].expand(b, -1, -1).to(
            bev_memory.dtype)
        query_pos, query = qe[..., :c], qe[..., c:]
        ref = torch.sigmoid(self.reference_points(query_pos).float())
        pc = self.pc_range
        all_cls, all_bbox = [], []
        for i in range(self.num_decoder_layers):
            bi = i if self.with_box_refine else 0
            query = getattr(self, f"layer{i}")(query, query_pos, bev_memory,
                                               bev_shape, ref[..., :2])
            y = query
            for j in range(2):
                ln = getattr(self, f"cls{bi}_ln{j}")
                y = F.relu(ln(getattr(self, f"cls{bi}_fc{j}")(y)).to(y.dtype))
            cls_logits = getattr(self, f"cls{bi}_out")(y)
            y = query
            for j in range(2):
                y = F.relu(getattr(self, f"reg{bi}_fc{j}")(y))
            tmp = getattr(self, f"reg{bi}_out")(y).float()

            # decode around the current reference (bevformer_head.py:194-216)
            ref_inv = inverse_sigmoid(ref)
            cx_cy = torch.sigmoid(tmp[..., 0:2] + ref_inv[..., 0:2])
            cz = torch.sigmoid(tmp[..., 4:5] + ref_inv[..., 2:3])
            all_cls.append(cls_logits)
            all_bbox.append(torch.cat([
                cx_cy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
                cx_cy[..., 1:2] * (pc[4] - pc[1]) + pc[1],
                tmp[..., 2:4],
                cz * (pc[5] - pc[2]) + pc[2],
                tmp[..., 5:]], dim=-1))
            if self.with_box_refine:
                # the next layer samples around this prediction, detached
                # (decoder.py:105-117)
                ref = torch.cat([cx_cy, cz], dim=-1).detach()
        return {"all_cls_scores": torch.stack(all_cls),
                "all_bbox_preds": torch.stack(all_bbox)}


class BEVFormerDetector(nn.Module):
    """Camera-only BEV detector: image features -> BEV encoder ->
    ``BEVFormerHead`` (ref bevformer/detectors/bevformer.py:BEVFormer).

    ``in_channels`` is the image features' width; ``can_bus=True`` builds
    the encoder's can_bus MLP, which JAX creates only when its ``init``
    saw can_bus signals; ``num_levels`` the image feature levels. Built
    on the CUDA card unless ``device`` says otherwise."""

    def __init__(self, in_channels: int, num_classes: int = 10,
                 num_query: int = 100, embed_dim: int = 128,
                 bev_shape: Tuple[int, int] = (32, 32),
                 num_encoder_layers: int = 2, num_decoder_layers: int = 3,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 can_bus: bool = False, num_levels: int = 1, device=None):
        super().__init__()
        self.bev_shape = tuple(bev_shape)
        self.input_proj = nn.Linear(in_channels, embed_dim)
        self.bev_encoder = OccupancyEncoder(
            embed_dim=embed_dim, num_layers=num_encoder_layers,
            bev_shape=bev_shape, pc_range=pc_range, can_bus=can_bus,
            num_levels=num_levels)
        self.pts_bbox_head = BEVFormerHead(
            num_classes=num_classes, num_query=num_query,
            embed_dim=embed_dim, num_decoder_layers=num_decoder_layers,
            pc_range=pc_range)
        self.to(torch.device("cuda") if device is None else device)

    def forward(self, img_feats, spatial_shapes, lidar2img, img_size,
                prev_bev=None, can_bus=None, only_bev: bool = False):
        """img_feats [B, N_cam, sum(HW), C_in]; lidar2img [B, N_cam, 3, 4];
        can_bus optional [B, 18] (ref transformer.py:121-161). Returns the
        BEV memory [B, H*W, C] with ``only_bev``, else the head's outputs
        plus ``bev_embed``."""
        bev = self.bev_encoder(self.input_proj(img_feats), spatial_shapes,
                               lidar2img, img_size, prev_bev=prev_bev,
                               can_bus=can_bus)
        if only_bev:
            return bev
        out = self.pts_bbox_head(bev, self.bev_shape)
        out["bev_embed"] = bev
        return out


@torch.no_grad()
def obtain_history_bev(model: BEVFormerDetector, feats_queue, spatial_shapes,
                       lidar2img_queue, img_size, can_bus_queue=None,
                       prev_bev_exists=None):
    """The history BEV of a queue of past frames (ref bevformer.py:163-181):
    each frame runs encoder-only, without gradients, against the previous
    frame's BEV; ``prev_bev_exists[t]`` False (a scene boundary) restarts
    the chain at frame t.

    feats_queue [B, T, N_cam, sum(HW), C]; lidar2img_queue
    [B, T, N_cam, 3, 4]; can_bus_queue optional [B, T, 18];
    prev_bev_exists optional [T] bools. Returns [B, H*W, C]."""
    prev_bev = None
    for t in range(feats_queue.shape[1]):
        if prev_bev_exists is not None and not bool(prev_bev_exists[t]):
            prev_bev = None
        prev_bev = model(
            feats_queue[:, t], spatial_shapes, lidar2img_queue[:, t],
            img_size, prev_bev=prev_bev,
            can_bus=None if can_bus_queue is None else can_bus_queue[:, t],
            only_bev=True)
    return prev_bev


class PrevFrameInfo:
    """Test-time temporal state across frames (host side; ref
    bevformer/detectors/bevformer.py:60-66, 245-275): the history BEV
    resets at scene boundaries, and can_bus position and angle become
    frame-to-frame deltas (zero on a scene's first frame)."""

    def __init__(self, video_test_mode: bool = True):
        self.video_test_mode = video_test_mode
        self.prev_bev = None
        self.scene_token = None
        self.prev_pos = None
        self.prev_angle = None

    def step(self, scene_token, can_bus):
        """(prev_bev, delta can_bus as float32 numpy) for this frame; call
        ``update`` with the new BEV afterwards."""
        can_bus = np.array(can_bus, dtype=np.float32, copy=True)
        if scene_token != self.scene_token or not self.video_test_mode:
            self.prev_bev = None
        self.scene_token = scene_token
        tmp_pos = can_bus[:3].copy()
        tmp_angle = float(can_bus[-1])
        if self.prev_bev is not None:
            can_bus[:3] -= self.prev_pos
            can_bus[-1] -= self.prev_angle
        else:
            can_bus[:3] = 0
            can_bus[-1] = 0
        self.prev_pos = tmp_pos
        self.prev_angle = tmp_angle
        return self.prev_bev, can_bus

    def update(self, new_bev):
        if self.video_test_mode:
            self.prev_bev = new_bev


def sigmoid_focal_loss(logits, targets_onehot, alpha=0.25, gamma=2.0):
    """mmdet's sigmoid FocalLoss, elementwise [..., C]."""
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * targets_onehot
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def bevformer_detection_loss(outputs, gt_bboxes, gt_labels, gt_valid,
                             num_classes: int = 10, cls_weight: float = 2.0,
                             bbox_weight: float = 0.25,
                             code_weights: Sequence[float] = (
                                 1, 1, 1, 1, 1, 1, 1, 1, 0.2, 0.2)):
    """Per-decoder-layer Hungarian-matched focal + L1 loss (ref
    bevformer_head.py:338-495). gt_bboxes [B, T, 9] (cx, cy, cz, w, l, h,
    rot, vx, vy) in metres; gt_labels, gt_valid [B, T]. The last layer's
    terms are ``loss_cls`` / ``loss_bbox``, layer i's ``.d{i}``."""
    gt_norm = normalize_bbox(gt_bboxes.float())
    # to the head's layout: cz from index 2 to index 4
    gt_norm = torch.cat([gt_norm[..., 0:2], gt_norm[..., 3:5],
                         gt_norm[..., 2:3], gt_norm[..., 5:]], dim=-1)
    cw = torch.tensor(code_weights, dtype=torch.float32,
                      device=gt_norm.device)
    valid = gt_valid.bool()
    labels = gt_labels.long()
    n_layers = outputs["all_cls_scores"].shape[0]
    losses = {}
    for lvl in range(n_layers):
        cls_logits = outputs["all_cls_scores"][lvl].float()
        bbox_preds = outputs["all_bbox_preds"][lvl].float()
        b, qn, _ = cls_logits.shape
        t = labels.shape[1]
        # the class cost with sigmoid heads: -log sigmoid of the gt class
        cost_cls = -torch.gather(F.logsigmoid(cls_logits), 2,
                                 labels[:, None, :].expand(b, qn, t))
        cost_reg = (bbox_preds[:, :, None, :8]
                    - gt_norm[:, None, :, :8]).abs().sum(-1)
        cost = (cost_cls + bbox_weight * cost_reg
                + 1e4 * (~valid)[:, None].float())
        assign = hungarian_match(cost)
        safe = assign.clamp_min(0)
        matched_valid = (assign >= 0) & torch.gather(valid, 1, safe)
        matched_cls = torch.gather(labels, 1, safe)
        onehot = F.one_hot(
            torch.where(matched_valid, matched_cls,
                        torch.full_like(matched_cls, num_classes)),
            num_classes + 1)[..., :num_classes].float()
        focal = sigmoid_focal_loss(cls_logits, onehot).sum(-1)
        num_pos = torch.clamp(matched_valid.sum().float(), min=1.0)
        loss_cls = cls_weight * focal.sum() / num_pos

        matched_boxes = torch.gather(
            gt_norm, 1, safe[..., None].expand(b, qn, gt_norm.shape[-1]))
        l1 = (bbox_preds - matched_boxes).abs() * cw
        # the reference's isnan filtering
        l1 = torch.where(torch.isfinite(l1), l1, 0.0)
        loss_bbox = bbox_weight * (l1 * matched_valid[..., None]).sum() \
            / num_pos
        suffix = "" if lvl == n_layers - 1 else f".d{lvl}"
        losses[f"loss_cls{suffix}"] = loss_cls
        losses[f"loss_bbox{suffix}"] = loss_bbox
    return losses


def bevformer_get_bboxes(outputs, max_num: int = 100,
                         post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2,
                                            10.0)):
    """Decode the last decoder layer with the NMS-free coder (ref
    bevformer_head.py:496-529). The head's (cx, cy) and cz are metric
    already; its cz moves to index 2 for ``decode_nms_free``."""
    cls = outputs["all_cls_scores"][-1]
    bbox = outputs["all_bbox_preds"][-1]
    reordered = torch.cat([bbox[..., 0:2], bbox[..., 4:5], bbox[..., 2:4],
                           bbox[..., 5:]], dim=-1)
    return decode_nms_free(cls, reordered, max_num=max_num,
                           post_center_range=post_center_range)
