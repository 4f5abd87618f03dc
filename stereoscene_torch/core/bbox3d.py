"""DETR3D-style 3D box core, port of ``stereoscene_tpu/core/bbox3d.py``
(ref: projects/mmdet3d_plugin/core/: ``HungarianAssigner3D``,
``NMSFreeCoder``, ``BBox3DL1Cost``, the bbox normalisation utils).

The assignment is ``models.mask2former_occ.hungarian_match`` (scipy on the
host). Ties are broken as the JAX package breaks them: ``batched_nms``
orders by a stable sort of the scores and ``decode_nms_free`` takes its
top k by a stable descending sort, so an equal score keeps the lower
index first (``jax.lax.top_k``'s order) on every device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..models.mask2former_occ import hungarian_match


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """[..., 7+] (cx, cy, cz, w, l, h, rot[, vx, vy]) -> regression space
    with log sizes and (sin, cos) rotation (the DETR3D convention)."""
    sizes = torch.log(torch.clamp(bboxes[..., 3:6], min=1e-6))
    rot = bboxes[..., 6]
    out = [bboxes[..., 0], bboxes[..., 1], bboxes[..., 2], sizes[..., 0],
           sizes[..., 1], sizes[..., 2], torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        out.extend([bboxes[..., 7], bboxes[..., 8]])
    return torch.stack(out, dim=-1)


def denormalize_bbox(normed: torch.Tensor) -> torch.Tensor:
    rot = torch.atan2(normed[..., 6], normed[..., 7])
    out = [normed[..., 0], normed[..., 1], normed[..., 2],
           torch.exp(normed[..., 3]), torch.exp(normed[..., 4]),
           torch.exp(normed[..., 5]), rot]
    if normed.shape[-1] > 8:
        out.extend([normed[..., 8], normed[..., 9]])
    return torch.stack(out, dim=-1)


def bbox3d_l1_cost(pred: torch.Tensor, target: torch.Tensor,
                   weight: float = 1.0) -> torch.Tensor:
    """Pairwise L1 cost in normalised space: [B, Q, D] x [B, T, D] ->
    [B, Q, T] (ref BBox3DL1Cost)."""
    return weight * (pred[:, :, None] - target[:, None, :]).abs().sum(-1)


class HungarianAssigner3D:
    """Class + box-L1 cost assignment (ref HungarianAssigner3D)."""

    def __init__(self, cls_weight: float = 1.0, reg_weight: float = 0.25):
        self.cls_weight = cls_weight
        self.reg_weight = reg_weight

    def assign(self, cls_logits, bbox_preds, gt_labels, gt_bboxes,
               gt_valid) -> torch.Tensor:
        """cls_logits [B, Q, C]; bbox_preds [B, Q, D] and gt_bboxes
        [B, T, D] normalised; gt_labels, gt_valid [B, T]. Returns the
        assignment [B, Q] (target index or -1)."""
        logp = torch.log_softmax(cls_logits.float(), dim=-1)
        b, q, _ = logp.shape
        t = gt_labels.shape[1]
        cost_cls = -torch.gather(
            logp, 2, gt_labels.long()[:, None, :].expand(b, q, t))
        cost_reg = bbox3d_l1_cost(bbox_preds.float(), gt_bboxes.float())
        cost = self.cls_weight * cost_cls + self.reg_weight * cost_reg
        cost = cost + 1e4 * (~gt_valid.bool())[:, None].float()
        return hungarian_match(cost)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_threshold: float = 0.5,
                max_out: int = 100) -> torch.Tensor:
    """Axis-aligned 2D NMS, class-aware (mmcv ``batched_nms``), greedy in
    score order on the tensors' device.

    boxes [N, 4] (x1, y1, x2, y2); scores [N]; labels [N]. Returns the
    keep mask [N]: the top-scoring boxes no kept box suppressed, at most
    ``max_out``."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    c = labels[order]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter,
                              min=1e-6)
    ar = torch.arange(n, device=boxes.device)
    # column i: the later boxes that box i suppresses when it is kept
    suppress = ((iou > iou_threshold) & (c[:, None] == c[None, :])
                & (ar[:, None] > ar[None, :]))
    keep_sorted = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep_sorted &= ~(suppress[:, i] & keep_sorted[i])
    rank = torch.cumsum(keep_sorted.int(), dim=0) - 1
    keep_sorted &= rank < max_out
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def decode_nms_free(cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
                    max_num: int = 100, score_threshold: float = 0.0,
                    post_center_range: Sequence[float] = (
                        -61.2, -61.2, -10, 61.2, 61.2, 10),
                    ) -> Dict[str, torch.Tensor]:
    """NMS-free decoding (ref NMSFreeCoder): the top ``max_num`` (query,
    class) sigmoid scores, their boxes denormalised, boxes outside
    ``post_center_range`` scored 0. Returns [B, max_num] ``boxes`` /
    ``scores`` / ``labels`` / ``valid``."""
    scores = torch.sigmoid(cls_logits.float())  # [B, Q, C]
    b, qn, c = scores.shape
    top_scores, top_idx = torch.sort(scores.reshape(b, qn * c), dim=-1,
                                     descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :max_num], top_idx[:, :max_num]
    query_idx = torch.div(top_idx, c, rounding_mode="floor")
    labels = top_idx % c
    boxes = denormalize_bbox(bbox_preds.float())
    boxes = torch.gather(boxes, 1, query_idx[..., None].expand(
        b, max_num, boxes.shape[-1]))
    lo = torch.tensor(post_center_range[:3], dtype=torch.float32,
                      device=boxes.device)
    hi = torch.tensor(post_center_range[3:], dtype=torch.float32,
                      device=boxes.device)
    in_range = ((boxes[..., :3] >= lo) & (boxes[..., :3] <= hi)).all(-1)
    keep = in_range & (top_scores > score_threshold)
    return {"boxes": boxes,
            "scores": torch.where(keep, top_scores, 0.0),
            "labels": labels,
            "valid": keep}
