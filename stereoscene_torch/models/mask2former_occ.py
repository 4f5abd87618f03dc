"""Mask2Former-style occupancy head, port of
``stereoscene_tpu/models/mask2former_occ.py`` (ref: occupancy/maskformer/
mask2former_occ.py:22-449, pixel_decoders/occupancy_pixel_decoder.py).

- ``OccPixelDecoder3D``: the lowest-resolution levels are projected, given
  3D sine + level positional encodings and refined by 3D multi-scale
  deformable self-attention layers (``ops.msdeform_attn_3d``, plain
  gathers as in JAX); the remaining high-res levels are fused FPN-style.
- ``Mask2FormerOccHead``: learned queries decoded against the multi-scale
  memories round-robin, with masked cross-attention (the previous layer's
  mask logits resampled to the level, ``< 0`` masked, detached; a fully
  masked query attends everywhere), then self-attention and FFN, post-norm.
- ``hungarian_match`` on the host (scipy), ``mask_match_cost`` and the
  Hungarian-matched mask-classification loss over every decoder layer.

The head opens ``stereoscene.head.encoder`` around the pixel decoder and
``stereoscene.head.decoder`` around the query decoder while a profiler
runs (``utils.spans``).

Tensors are channels-last as in JAX ([B, X, Y, Z, C] volumes, [B, Q, C]
queries). Every norm is flax's: LayerNorm and GroupNorm with eps 1e-6 in
fp32 (``LayerNorm32``, ``GroupNorm32``), not the package's default eps
1e-5 of ``layers.GroupNorm``; self-attention is flax's
``MultiHeadDotProductAttention`` (``vit.Attention``). Submodules carry the
JAX scope names, so ``utils.weights.module_rules`` carries the weights.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.msdeform_attn import msdeform_attn_3d
from ..ops.resize import resize_trilinear
from ..utils.spans import span
from . import layers
from .bevformer import LayerNorm32
from .vit import Attention

# wall time of ``hungarian_match``: the copy of the cost to the host (which
# waits for the work queued before it) and the scipy solves
MATCH_STATS = {"calls": 0, "copy_s": 0.0, "solve_s": 0.0}


def sine_pos_embed_3d(shape, channels: int, temperature: float = 10000.0,
                      device=None) -> torch.Tensor:
    """3D sine positional encoding [X, Y, Z, channels] in fp32: normalised
    positions (i + 1) / n * 2 pi, channels split across the three axes."""
    x_len, y_len, z_len = shape
    per = channels // 3
    per_last = channels - 2 * per

    def axis_embed(n, nfeat):
        nf = nfeat + (nfeat % 2)  # even working width, sliced at the end
        pos = ((torch.arange(n, dtype=torch.float32, device=device) + 1.0)
               / n * (2 * math.pi))
        dim_t = temperature ** (
            2 * torch.div(torch.arange(nf, dtype=torch.float32,
                                       device=device), 2,
                          rounding_mode="floor") / max(nf, 1))
        ang = pos[:, None] / dim_t[None]
        emb = torch.stack([torch.sin(ang[:, 0::2]), torch.cos(ang[:, 1::2])],
                          dim=-1).reshape(n, -1)
        return emb[:, :nfeat]

    ex = axis_embed(x_len, per)[:, None, None, :]
    ey = axis_embed(y_len, per)[None, :, None, :]
    ez = axis_embed(z_len, per_last)[None, None, :, :]
    return torch.cat([ex.expand(x_len, y_len, z_len, per),
                      ey.expand(x_len, y_len, z_len, per),
                      ez.expand(x_len, y_len, z_len, per_last)], dim=-1)


class GroupNorm32(layers.GroupNorm):
    """flax ``nn.GroupNorm(dtype=float32)`` on channels-last [B, ..., C]:
    ``layers.GroupNorm`` (fp32) with flax's eps 1e-6."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x):
        return super().forward(x.movedim(-1, 1)).movedim(1, -1)


class FFN(nn.Module):
    def __init__(self, embed_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, embed_dim)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


class DeformableEncoderLayer3D(nn.Module):
    """One 3D deformable self-attention encoder layer (post-norm). The
    offset and weight layers start at zero, as in JAX."""

    def __init__(self, embed_dim: int, num_heads: int = 8,
                 num_points: int = 4, num_levels: int = 2,
                 ffn_ratio: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.num_points = num_points
        self.num_levels = num_levels
        n_total = num_heads * num_levels * num_points
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.sampling_offsets = nn.Linear(embed_dim, n_total * 3)
        nn.init.zeros_(self.sampling_offsets.weight)
        nn.init.zeros_(self.sampling_offsets.bias)
        self.attention_weights = nn.Linear(embed_dim, n_total)
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        self.output_proj = nn.Linear(embed_dim, embed_dim)
        self.norm1 = LayerNorm32(embed_dim)
        self.norm2 = LayerNorm32(embed_dim)
        self.ffn = FFN(embed_dim, embed_dim * ffn_ratio)

    def forward(self, tokens, pos, ref_points, spatial_shapes):
        """tokens [B, V, C]; pos [V, C]; ref_points [V, 3] in [0, 1];
        spatial_shapes the static (X, Y, Z) of each level."""
        b, v, _ = tokens.shape
        h, p, lv = self.num_heads, self.num_points, self.num_levels
        q = tokens + pos[None].to(tokens.dtype)
        value = self.value_proj(tokens)
        offsets = self.sampling_offsets(q).reshape(b, v, h, lv, p, 3)
        weights = torch.softmax(
            self.attention_weights(q).reshape(b, v, h, lv * p).float(),
            dim=-1).to(tokens.dtype).reshape(b, v, h, lv, p)
        norm = torch.tensor([list(s) for s in spatial_shapes],
                            dtype=torch.float32, device=tokens.device)
        loc = (ref_points.float()[None, :, None, None, None, :]
               + offsets.float() / norm[None, None, None, :, None, :])
        out = self.output_proj(
            msdeform_attn_3d(value, spatial_shapes, loc, weights, h))
        tokens = self.norm1(tokens + out)
        return self.norm2(self.ffn(tokens))


class OccPixelDecoder3D(nn.Module):
    """Multi-scale 3D pixel decoder (deformable encoder + FPN).

    ``in_channels``: the channels of each input level, high-res first.
    forward(feats [B, Xi, Yi, Zi, Ci], high-res first) -> (mask_feature
    [B, X0, Y0, Z0, out_channels], memories low-res first, one per level).
    """

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 64,
                 out_channels: int = 64, num_encoder_levels: int = 2,
                 num_encoder_layers: int = 2, num_heads: int = 8,
                 num_points: int = 4):
        super().__init__()
        n_levels = len(in_channels)
        self.n_levels = n_levels
        self.n_enc = n_enc = min(num_encoder_levels, n_levels)
        self.num_encoder_layers = num_encoder_layers
        c = feat_channels
        groups = min(32, c)
        self.level_embed = nn.Parameter(torch.randn(n_enc, c))
        for i in range(n_enc):
            setattr(self, f"input_proj{i}",
                    nn.Linear(in_channels[n_levels - 1 - i], c))
            setattr(self, f"input_gn{i}", GroupNorm32(groups, c))
        for li in range(num_encoder_layers):
            setattr(self, f"encoder{li}", DeformableEncoderLayer3D(
                c, num_heads, num_points, n_enc))
        for i in range(n_levels - n_enc):
            setattr(self, f"lateral{i}", nn.Linear(in_channels[i], c))
            setattr(self, f"lateral_gn{i}", GroupNorm32(groups, c))
            setattr(self, f"output_conv{i}",
                    nn.Conv3d(c, c, 3, padding=1, bias=False))
            setattr(self, f"output_gn{i}", GroupNorm32(groups, c))
        self.mask_feature = nn.Linear(c, out_channels)

    def forward(self, feats):
        n_levels, n_enc = self.n_levels, self.n_enc
        if len(feats) != n_levels:
            raise ValueError(f"{len(feats)} levels, built for {n_levels}")
        c = self.level_embed.shape[1]
        dev = feats[0].device
        tokens, poss, refs, shapes = [], [], [], []
        for i in range(n_enc):
            f = feats[n_levels - 1 - i]  # from the lowest resolution up
            b, x, y, z, _ = f.shape
            proj = getattr(self, f"input_gn{i}")(
                getattr(self, f"input_proj{i}")(f))
            pos = sine_pos_embed_3d((x, y, z), c, device=dev) \
                + self.level_embed[i]
            gx, gy, gz = torch.meshgrid(
                *((torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
                  for n in (x, y, z)), indexing="ij")
            tokens.append(proj.reshape(b, -1, c))
            poss.append(pos.reshape(-1, c))
            refs.append(torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3))
            shapes.append((x, y, z))
        tok = torch.cat(tokens, dim=1)
        pos = torch.cat(poss, dim=0)
        ref = torch.cat(refs, dim=0)
        for li in range(self.num_encoder_layers):
            tok = getattr(self, f"encoder{li}")(tok, pos, ref, shapes)

        outs = []
        offset = 0
        for x, y, z in shapes:
            v = x * y * z
            outs.append(tok[:, offset:offset + v].reshape(-1, x, y, z, c))
            offset += v

        for i in range(n_levels - n_enc - 1, -1, -1):
            lateral = getattr(self, f"lateral_gn{i}")(
                getattr(self, f"lateral{i}")(feats[i]))
            up = resize_trilinear(outs[-1], feats[i].shape[1:4])
            y = (lateral + up).permute(0, 4, 1, 2, 3)
            y = getattr(self, f"output_conv{i}")(y).permute(0, 2, 3, 4, 1)
            outs.append(F.relu(getattr(self, f"output_gn{i}")(y)))
        return self.mask_feature(outs[-1]), outs


class MaskedCrossAttention(nn.Module):
    """Multi-head cross-attention with an additive -1e9 bias inside the
    softmax where ``attn_mask`` is True (ref mask2former_occ.py:344-356);
    a query masked everywhere attends everywhere (ref :424-425)."""

    dense_general = {"q_proj": "in", "k_proj": "in", "v_proj": "in"}

    def __init__(self, embed_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, queries, query_pos, feats, feat_pos, attn_mask):
        """queries [B, Q, C]; feats [B, V, C]; attn_mask [B, Q, V] bool
        (True = do not attend)."""
        b, nq, c = queries.shape
        h = self.num_heads
        dh = c // h
        q = self.q_proj(queries + query_pos).reshape(b, nq, h, dh)
        k = self.k_proj(feats + feat_pos).reshape(b, -1, h, dh)
        v = self.v_proj(feats).reshape(b, -1, h, dh)
        energy = torch.einsum("bqhd,bvhd->bhqv", q.float(),
                              k.float()) / np.sqrt(dh)
        mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
        energy = energy.masked_fill(mask[:, None], -1e9)
        attn = torch.softmax(energy, dim=-1).to(v.dtype)
        out = torch.einsum("bhqv,bvhd->bqhd", attn, v).reshape(b, nq, c)
        return self.out_proj(out)


class DecoderLayer(nn.Module):
    """Masked cross-attn -> self-attn -> FFN, post-norm (mmcv's
    ('cross_attn', 'norm', 'self_attn', 'norm', 'ffn', 'norm')); the FFN's
    hidden width ``ffn_dim``, 4x ``embed_dim`` where None."""

    def __init__(self, embed_dim: int, num_heads: int = 8,
                 ffn_dim: Optional[int] = None):
        super().__init__()
        self.cross_attn = MaskedCrossAttention(embed_dim, num_heads)
        self.norm1 = LayerNorm32(embed_dim)
        self.self_attn = Attention(embed_dim, num_heads)
        self.norm2 = LayerNorm32(embed_dim)
        self.ffn = FFN(embed_dim, ffn_dim or embed_dim * 4)
        self.norm3 = LayerNorm32(embed_dim)

    def forward(self, queries, query_pos, feats, feat_pos, attn_mask):
        y = self.cross_attn(queries, query_pos, feats, feat_pos, attn_mask)
        queries = self.norm1(queries + y)
        q = queries + query_pos
        queries = self.norm2(queries + self.self_attn(q, q, queries))
        return self.norm3(self.ffn(queries))


class Mask2FormerOccHead(nn.Module):
    """Query-based occupancy head over multi-scale voxel features.

    ``in_channels`` an int: forward takes one volume [B, X, Y, Z, C] and
    derives ``num_feat_levels`` levels by stride-2 average pooling (a
    level whose smallest side is below 2 repeats the one before). A
    sequence: forward takes that many volumes, high-res first (the
    backbone pyramid), with those channels. ``num_heads`` is the deformable
    pixel decoder's, ``decoder_heads`` the query decoder's (``num_heads``
    where None); ``ffn_dim``: the decoder layers' FFN width (4x
    ``embed_dim`` where None). Built on the CUDA card unless ``device``
    says otherwise.

    The forward gives ``cls_logits``, ``mask_logits``, ``aux`` (the earlier
    predictions) and ``attn_masks``: the attention mask [B, Q, V] that each
    decoder layer was given (True = not attended).
    """

    def __init__(self, in_channels: Union[int, Sequence[int]],
                 num_queries: int = 50, embed_dim: int = 64,
                 num_layers: int = 3, num_classes: int = 20,
                 num_heads: int = 8, num_feat_levels: int = 2,
                 num_encoder_layers: int = 2,
                 ffn_dim: Optional[int] = None,
                 decoder_heads: Optional[int] = None, device=None):
        super().__init__()
        self.single = isinstance(in_channels, int)
        levels = ([in_channels] * num_feat_levels if self.single
                  else list(in_channels))
        self.num_queries = num_queries
        self.num_layers = num_layers
        self.num_feat_levels = num_feat_levels
        self.pixel_decoder = OccPixelDecoder3D(
            levels, embed_dim, embed_dim,
            num_encoder_levels=min(num_feat_levels, len(levels)),
            num_encoder_layers=num_encoder_layers, num_heads=num_heads)
        self.level_embed = nn.Parameter(torch.randn(num_feat_levels,
                                                    embed_dim))
        self.queries = nn.Parameter(torch.randn(num_queries, embed_dim)
                                    * 0.02)
        self.query_pos = nn.Parameter(torch.randn(num_queries, embed_dim)
                                      * 0.02)
        self.cls_head = nn.Linear(embed_dim, num_classes + 1)
        for i in range(3):
            setattr(self, f"mask_head{i}", nn.Linear(embed_dim, embed_dim))
        self.decoder_norm = LayerNorm32(embed_dim)
        for i in range(num_layers):
            setattr(self, f"layer{i}", DecoderLayer(
                embed_dim, decoder_heads or num_heads, ffn_dim))
        self.to(torch.device("cuda") if device is None else device)

    def pyramid(self, voxel_feats):
        if isinstance(voxel_feats, (list, tuple)):
            if self.single:
                raise ValueError("built for one volume, given a list")
            return list(voxel_feats)
        if not self.single:
            raise ValueError("built for a list of levels, given one volume")
        feats = [voxel_feats]
        for _ in range(self.num_feat_levels - 1):
            f = feats[-1]
            if min(f.shape[1:4]) >= 2:
                f = F.avg_pool3d(f.permute(0, 4, 1, 2, 3), 2).permute(
                    0, 2, 3, 4, 1)
            feats.append(f)
        return feats

    def predict(self, q, mask_feats, target_shape):
        """(class logits, mask logits [B, Q, X, Y, Z] fp32, the detached
        attention mask [B, Q, V] of the next layer's level)."""
        dec = self.decoder_norm(q)
        cls_logits = self.cls_head(dec)
        e = dec
        for i in range(3):
            e = getattr(self, f"mask_head{i}")(e)
            if i < 2:
                e = F.relu(e)
        mask_logits = torch.einsum("bqc,bxyzc->bqxyz", e.float(),
                                   mask_feats.float())
        with torch.no_grad():
            m = resize_trilinear(mask_logits[..., None], target_shape)[..., 0]
            attn_mask = (m < 0.0).reshape(q.shape[0], self.num_queries, -1)
        return cls_logits, mask_logits, attn_mask

    def forward(self, voxel_feats):
        feats = self.pyramid(voxel_feats)
        with span("stereoscene.head.encoder"):
            mask_feats, memories = self.pixel_decoder(feats)
        with span("stereoscene.head.decoder"):
            return self.decode(mask_feats, memories)

    def decode(self, mask_feats, memories):
        """The query decoder over the pixel decoder's outputs: the first
        prediction, then each layer and its prediction."""
        b, c = mask_feats.shape[0], mask_feats.shape[-1]
        levels = memories[:self.num_feat_levels]
        dec_feats, dec_pos, level_shapes = [], [], []
        for i, m in enumerate(levels):
            shape = tuple(m.shape[1:4])
            dec_feats.append(m.reshape(b, -1, c)
                             + self.level_embed[i].to(m.dtype))
            dec_pos.append(sine_pos_embed_3d(shape, c, device=m.device)
                           .reshape(-1, c)[None])
            level_shapes.append(shape)
        dtype = mask_feats.dtype
        q = self.queries[None].expand(b, -1, -1).to(dtype)
        qp = self.query_pos[None].expand(b, -1, -1).to(dtype)

        cls_logits, mask_logits, attn_mask = self.predict(q, mask_feats,
                                                          level_shapes[0])
        aux = [(cls_logits, mask_logits.reshape(b, self.num_queries, -1))]
        attn_masks = []
        for i in range(self.num_layers):
            lvl = i % self.num_feat_levels
            attn_masks.append(attn_mask)
            q = getattr(self, f"layer{i}")(q, qp, dec_feats[lvl],
                                           dec_pos[lvl].to(dtype), attn_mask)
            cls_logits, mask_logits, attn_mask = self.predict(
                q, mask_feats, level_shapes[(i + 1) % self.num_feat_levels])
            aux.append((cls_logits,
                        mask_logits.reshape(b, self.num_queries, -1)))
        return {"cls_logits": cls_logits,        # [B, Q, num_classes + 1]
                "mask_logits": mask_logits,      # [B, Q, X, Y, Z]
                "aux": aux[:-1],
                "attn_masks": attn_masks}        # a [B, Q, V] a layer


def semantic_inference(cls_logits, mask_logits):
    """Per-voxel semantics sum_q P(cls | q) * sigmoid(mask_q):
    [B, X, Y, Z, num_classes]."""
    probs = torch.softmax(cls_logits.float(), dim=-1)[..., :-1]
    masks = torch.sigmoid(mask_logits.float())
    return torch.einsum("bqc,bqxyz->bxyzc", probs, masks)


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """cost [B, Q, T] -> assignment [B, Q] (target index, -1 unmatched) on
    the cost's device. scipy's ``linear_sum_assignment`` on the detached
    cost, on the host, once per batch element (the JAX package's
    ``pure_callback``); no gradient flows through the decision."""
    from scipy.optimize import linear_sum_assignment

    t0 = time.perf_counter()
    host = cost.detach().float().cpu().numpy()
    t1 = time.perf_counter()
    out = np.full(host.shape[:2], -1, np.int64)
    for i in range(host.shape[0]):
        rows, cols = linear_sum_assignment(host[i])
        out[i, rows] = cols
    assign = torch.from_numpy(out).to(cost.device)
    MATCH_STATS["calls"] += 1
    MATCH_STATS["copy_s"] += t1 - t0
    MATCH_STATS["solve_s"] += time.perf_counter() - t1
    return assign


def mask_match_cost(cls_logits, masks_flat, tgt_flat, target_classes,
                    cost_weights: tuple = (2.0, 5.0, 5.0)):
    """The reference MaskHungarianAssigner's cost [B, Q, T]: minus the
    softmax probability of the target class, the mean sigmoid BCE of each
    (query, target) pair and the dice cost (eps 1).

    cls_logits [B, Q, K+1]; masks_flat [B, Q, V] logits; tgt_flat [B, T, V]
    binary; target_classes [B, T] ints."""
    b, qn = cls_logits.shape[:2]
    t = tgt_flat.shape[1]
    v = masks_flat.shape[-1]
    p_cls = torch.softmax(cls_logits, dim=-1)
    cost_cls = -torch.gather(
        p_cls, 2, target_classes.long()[:, None, :].expand(b, qn, t))
    probs = torch.sigmoid(masks_flat)
    inter = torch.einsum("bqv,btv->bqt", probs, tgt_flat)
    cost_dice = 1.0 - (2 * inter + 1.0) / (
        probs.sum(-1)[:, :, None] + tgt_flat.sum(-1)[:, None] + 1.0)
    cost_mask = (F.softplus(-masks_flat).sum(-1)[:, :, None]
                 + torch.einsum("bqv,btv->bqt", masks_flat,
                                1.0 - tgt_flat)) / v
    w_cls, w_mask, w_dice = cost_weights
    return w_cls * cost_cls + w_mask * cost_mask + w_dice * cost_dice


def mask2former_loss(outputs, target_masks, target_classes, target_valid,
                     no_object_weight: float = 0.1,
                     cost_weights: tuple = (2.0, 5.0, 5.0)):
    """Hungarian-matched mask classification loss of one layer.

    target_masks [B, T, X, Y, Z] binary per GT segment; target_classes
    [B, T] ints; target_valid [B, T] bool (padded slots False);
    cost_weights (cls, mask BCE, dice): the reference's 2, 5, 5."""
    cls_logits = outputs["cls_logits"].float()
    mask_logits = outputs["mask_logits"].float()
    b, qn = cls_logits.shape[:2]
    t = target_masks.shape[1]
    v = int(np.prod(target_masks.shape[2:]))
    masks_flat = mask_logits.reshape(b, qn, v)
    tgt_flat = target_masks.reshape(b, t, v).float()
    valid = target_valid.bool()

    cost = mask_match_cost(cls_logits, masks_flat, tgt_flat, target_classes,
                           cost_weights) + 1e4 * (~valid)[:, None].float()
    assign = hungarian_match(cost)  # [B, Q]; -1 = unmatched query

    safe = assign.clamp_min(0)
    matched_cls = torch.gather(target_classes.long(), 1, safe)
    matched_valid = (assign >= 0) & torch.gather(valid, 1, safe)
    tgt_cls = torch.where(matched_valid, matched_cls,
                          torch.full_like(matched_cls,
                                          cls_logits.shape[-1] - 1))
    w = torch.where(matched_valid, 1.0, no_object_weight)
    ce = -torch.gather(torch.log_softmax(cls_logits, dim=-1), 2,
                       tgt_cls[..., None])[..., 0]
    loss_cls = (ce * w).sum() / torch.clamp(w.sum(), min=1e-6)

    matched_masks = torch.gather(tgt_flat, 1,
                                 safe[..., None].expand(b, qn, v))
    validf = matched_valid.float()[..., None]
    bce = (torch.clamp(masks_flat, min=0) - masks_flat * matched_masks
           + torch.log1p(torch.exp(-masks_flat.abs())))
    loss_mask = (bce * validf).sum() / torch.clamp(validf.sum() * v,
                                                   min=1e-6)
    p = torch.sigmoid(masks_flat)
    inter = (p * matched_masks).sum(-1)
    dice = 1.0 - (2 * inter + 1.0) / (p.sum(-1) + matched_masks.sum(-1)
                                      + 1.0)
    loss_dice = (dice * matched_valid).sum() / torch.clamp(
        matched_valid.sum(), min=1e-6)
    return {"loss_mask_cls": loss_cls, "loss_mask_bce": loss_mask,
            "loss_mask_dice": loss_dice}


def mask2former_loss_all_layers(outputs, target_masks, target_classes,
                                target_valid,
                                no_object_weight: float = 0.1):
    """The final layer's loss plus every auxiliary layer's, each matched
    on its own; auxiliary terms are suffixed ``_aux{i}``."""
    losses = mask2former_loss(outputs, target_masks, target_classes,
                              target_valid, no_object_weight)
    shape = outputs["mask_logits"].shape[2:]
    b, qn = outputs["cls_logits"].shape[:2]
    for i, (cls_l, mask_l) in enumerate(outputs.get("aux", [])):
        aux = {"cls_logits": cls_l,
               "mask_logits": mask_l.reshape(b, qn, *shape)}
        for k, val in mask2former_loss(aux, target_masks, target_classes,
                                       target_valid,
                                       no_object_weight).items():
            losses[f"{k}_aux{i}"] = val
    return losses
