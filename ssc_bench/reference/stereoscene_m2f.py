"""The plain reference of StereoScene's trunk with OccFormer's query-based
occupancy head (the ``stereoscene_m2f`` family): plain ``torch``, float32
(the caller turns TF32 off), importing nothing of the program.

The trunk is ``model.py``'s, unchanged: EfficientNet + SECONDFPN over both
eyes, the view transformer (stereo volume, DepthNet, MIE, the splat as an
``index_add`` over ranks the reference computes itself) and ResNet3D, whose
every stage is a level of the head's pyramid. The head is written here:

- the pixel decoder: each of the ``num_feat_levels`` coarsest levels
  projected (linear, GroupNorm eps 1e-6) and given a 3D sine encoding
  (channels split in thirds, positions (i + 1) / n x 2 pi) plus a learned
  level embedding; post-norm encoder layers of 3D multi-scale deformable
  self-attention and an FFN over the levels' tokens together; then the
  finer levels fused FPN-style (lateral projection, the coarser output
  upsampled trilinearly, a 3x3x3 convolution, GroupNorm, ReLU), and the
  mask features a linear map of the finest;
- the deformable sampling as ``F.grid_sample`` on each level's 5D value
  volume (trilinear, ``align_corners=False``, zero padding): a location
  in [0, 1] is the voxel coordinate ``loc * size - 0.5``, and a corner
  outside the level adds nothing; the samples are summed under the
  softmaxed attention weights;
- the decoder: learned queries and their positions, a prediction (class
  logits, mask logits = a 3-layer MLP of the normed queries against the
  mask features) before the first layer and after each; each post-norm
  layer is masked cross-attention to one level (round-robin, coarsest
  first; keys carry the level's sine encoding, values its level
  embedding), self-attention and an FFN. The attention mask is the last
  prediction's mask logits resized to the level (the antialiased linear
  resize: a triangle kernel as wide as the shrink, each output's weights
  summing to 1), below 0 masked; a query masked everywhere attends
  everywhere; a masked energy takes -1e9. ``Head.decode`` gives each
  layer, in place of its own mask, the one another run gave it where
  asked (``families/stereoscene_m2f.py`` compares the program's decoder so);
- ``semantic``: the sum over the queries of the no-object-free class
  softmax times the mask's sigmoid, [B, classes, X, Y, Z].

Module names follow the program's ``state_dict`` so one seeded
``state_dict`` loads into both. ``model.set_quantizer`` routes every
linear layer, convolution, attention product, mask product and sampled
product through a quantize-dequantize function (the control of
``correct``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import geometry
from .model import (EfficientNet, GroupNorm, Linear, ResNet3D, SECONDFPN,
                    ViewTransformer, Conv3d, Detector, _Q, set_quantizer,
                    upsample)

EPS = 1e-6  # flax's norms, as the program's head


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                        EPS)


def channels_last_gn(x: torch.Tensor, norm: GroupNorm) -> torch.Tensor:
    """GroupNorm of a channels-last [B, ..., C] tensor."""
    return norm(x.movedim(-1, 1)).movedim(1, -1)


def sine_3d(shape: Sequence[int], channels: int, device,
            temperature: float = 10000.0) -> torch.Tensor:
    """[X * Y * Z, channels]: per axis a third of the channels (the last
    axis the rest) of interleaved sin / cos at positions (i + 1) / n x
    2 pi over the frequencies temperature ** (2k / width)."""
    per = channels // 3
    widths = (per, per, channels - 2 * per)
    parts = []
    for axis, (n, width) in enumerate(zip(shape, widths)):
        even = width + width % 2
        pos = torch.arange(1, n + 1, dtype=torch.float32,
                           device=device) * (2 * math.pi / n)
        freq = temperature ** (torch.arange(0, even, 2, dtype=torch.float32,
                                            device=device) / even)
        ang = pos[:, None] / freq[None]
        enc = torch.stack([ang.sin(), ang.cos()], dim=2).flatten(1)[:, :width]
        view = [1, 1, 1, width]
        view[axis] = n
        parts.append(enc.reshape(view).expand(*shape, width))
    return torch.cat(parts, dim=-1).reshape(-1, channels)


def shrink_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in]: the antialiased linear resize of an axis that keeps
    or shrinks its length (the identity where it keeps it)."""
    scale = n_in / n_out
    centre = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (centre[:, None] - src[None]).abs() / scale).clamp_min(0.0)
    return w / w.sum(1, keepdim=True)


def resize_masks(masks: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """[B, Q, X, Y, Z] -> [B, Q, *shape] (each axis shrinks or keeps)."""
    wx, wy, wz = (shrink_weights(n, m, masks.device)
                  for n, m in zip(masks.shape[2:], shape))
    return torch.einsum("bqxyz,ix,jy,kz->bqijk", masks, wx, wy, wz)


class FFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


class DeformableLayer(_Q, nn.Module):
    """Post-norm 3D multi-scale deformable self-attention, then the FFN."""

    def __init__(self, dim: int, heads: int, levels: int, points: int = 4):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = Linear(dim, dim)
        self.sampling_offsets = Linear(dim, heads * levels * points * 3)
        self.attention_weights = Linear(dim, heads * levels * points)
        self.output_proj = Linear(dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = FFN(dim, 4 * dim)

    def sample(self, value: torch.Tensor, shapes: List[Sequence[int]],
               loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """value [B, V, C] (levels flattened X-major); loc [B, Q, heads,
        levels, points, 3] as (x, y, z) in [0, 1]; attn [B, Q, heads,
        levels, points] -> [B, Q, C]."""
        b, _, c = value.shape
        nq = loc.shape[1]
        h, ch = self.heads, c // self.heads
        out = value.new_zeros(b * h, ch, nq)
        start = 0
        for lvl, (x, y, z) in enumerate(shapes):
            n = x * y * z
            vol = self.q(value[:, start:start + n]).reshape(b, x, y, z, h, ch)
            start += n
            vol = vol.permute(0, 4, 5, 1, 2, 3).reshape(b * h, ch, x, y, z)
            # grid_sample's last axis indexes the volume's last (Z) axis
            grid = (2.0 * loc[:, :, :, lvl] - 1.0).flip(-1)
            grid = grid.permute(0, 2, 1, 3, 4).reshape(b * h, nq,
                                                       self.points, 1, 3)
            taps = F.grid_sample(vol, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=False)
            wgt = self.q(attn[:, :, :, lvl].permute(0, 2, 1, 3)
                         .reshape(b * h, 1, nq, self.points, 1))
            out = out + (taps * wgt).sum(dim=(3, 4))
        return out.reshape(b, h * ch, nq).transpose(1, 2)

    def forward(self, tokens, pos, ref, shapes):
        b, v, _ = tokens.shape
        h, lv, p = self.heads, self.levels, self.points
        query = tokens + pos
        size = torch.tensor(shapes, dtype=torch.float32, device=tokens.device)
        offsets = self.sampling_offsets(query).reshape(b, v, h, lv, p, 3)
        loc = ref[None, :, None, None, None] + offsets / size[:, None]
        attn = torch.softmax(self.attention_weights(query)
                             .reshape(b, v, h, lv * p), dim=-1)
        out = self.output_proj(self.sample(
            self.value_proj(tokens), shapes, loc,
            attn.reshape(b, v, h, lv, p)))
        tokens = layer_norm(tokens + out, self.norm1)
        return layer_norm(self.ffn(tokens), self.norm2)


class PixelDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int], dim: int, levels: int,
                 layers: int, heads: int):
        super().__init__()
        n = len(in_channels)
        self.n, self.n_enc, self.n_layers = n, min(levels, n), layers
        groups = min(32, dim)
        self.level_embed = nn.Parameter(torch.empty(self.n_enc, dim))
        for i in range(self.n_enc):  # coarsest first
            setattr(self, f"input_proj{i}", Linear(in_channels[n - 1 - i],
                                                   dim))
            setattr(self, f"input_gn{i}", GroupNorm(groups, dim, eps=EPS))
        for i in range(layers):
            setattr(self, f"encoder{i}",
                    DeformableLayer(dim, heads, self.n_enc))
        for i in range(n - self.n_enc):
            setattr(self, f"lateral{i}", Linear(in_channels[i], dim))
            setattr(self, f"lateral_gn{i}", GroupNorm(groups, dim, eps=EPS))
            setattr(self, f"output_conv{i}",
                    Conv3d(dim, dim, 3, padding=1, bias=False))
            setattr(self, f"output_gn{i}", GroupNorm(groups, dim, eps=EPS))
        self.mask_feature = Linear(dim, dim)

    def forward(self, feats: List[torch.Tensor]):
        """feats: channels-first [B, Ci, X, Y, Z], finest first -> (mask
        features [B, C, X0, Y0, Z0], memories channels-first, coarsest
        first)."""
        dim = self.level_embed.shape[1]
        tokens, poss, refs, shapes = [], [], [], []
        for i in range(self.n_enc):
            f = feats[self.n - 1 - i].movedim(1, -1)
            shape = tuple(f.shape[1:4])
            proj = channels_last_gn(getattr(self, f"input_proj{i}")(f),
                                    getattr(self, f"input_gn{i}"))
            tokens.append(proj.flatten(1, 3))
            poss.append(sine_3d(shape, dim, f.device) + self.level_embed[i])
            centres = [(torch.arange(n, dtype=torch.float32, device=f.device)
                        + 0.5) / n for n in shape]
            refs.append(torch.stack(torch.meshgrid(*centres, indexing="ij"),
                                    dim=-1).reshape(-1, 3))
            shapes.append(shape)
        tok = torch.cat(tokens, 1)
        pos, ref = torch.cat(poss), torch.cat(refs)
        for i in range(self.n_layers):
            tok = getattr(self, f"encoder{i}")(tok, pos, ref, shapes)
        outs, start = [], 0
        for x, y, z in shapes:
            n = x * y * z
            outs.append(tok[:, start:start + n].reshape(-1, x, y, z, dim)
                        .movedim(-1, 1))
            start += n
        for i in reversed(range(self.n - self.n_enc)):
            lateral = channels_last_gn(
                getattr(self, f"lateral{i}")(feats[i].movedim(1, -1)),
                getattr(self, f"lateral_gn{i}")).movedim(-1, 1)
            up = F.interpolate(outs[-1], size=tuple(feats[i].shape[2:]),
                               mode="trilinear", align_corners=False)
            y = getattr(self, f"output_conv{i}")(lateral + up)
            outs.append(F.relu(getattr(self, f"output_gn{i}")(y)))
        mask = self.mask_feature(outs[-1].movedim(1, -1)).movedim(-1, 1)
        return mask, outs


class CrossAttention(_Q, nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, dim), Linear(dim, dim)
        self.v_proj, self.out_proj = Linear(dim, dim), Linear(dim, dim)

    def forward(self, queries, query_pos, feats, feat_pos, masked):
        b, nq, c = queries.shape
        h = self.heads
        q = self.q_proj(queries + query_pos).reshape(b, nq, h, -1)
        k = self.k_proj(feats + feat_pos).reshape(b, feats.shape[1], h, -1)
        v = self.v_proj(feats).reshape(b, feats.shape[1], h, -1)
        energy = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)) \
            / math.sqrt(c // h)
        masked = masked & ~masked.all(-1, keepdim=True)
        energy = torch.where(masked[:, None], torch.full_like(energy, -1e9),
                             energy)
        attn = torch.softmax(energy, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", self.q(attn), self.q(v))
        return self.out_proj(out.reshape(b, nq, c))


class SelfAttention(_Q, nn.Module):
    """flax's multi-head dot-product attention: query, key and value
    projections and ``out``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key = Linear(dim, dim), Linear(dim, dim)
        self.value, self.out = Linear(dim, dim), Linear(dim, dim)

    def forward(self, qk, v):
        b, n, c = qk.shape
        h = self.heads

        def split(t):
            return t.reshape(b, n, h, c // h)

        q, k, val = split(self.query(qk)), split(self.key(qk)), \
            split(self.value(v))
        energy = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)) \
            / math.sqrt(c // h)
        out = torch.einsum("bhqk,bkhd->bqhd",
                           self.q(torch.softmax(energy, -1)), self.q(val))
        return self.out(out.reshape(b, n, c))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.cross_attn = CrossAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.self_attn = SelfAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = FFN(dim, ffn)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, q, qp, feats, pos, masked):
        q = layer_norm(q + self.cross_attn(q, qp, feats, pos, masked),
                       self.norm1)
        q = layer_norm(q + self.self_attn(q + qp, q), self.norm2)
        return layer_norm(self.ffn(q), self.norm3)


class Head(_Q, nn.Module):
    def __init__(self, in_channels: Sequence[int], queries: int, dim: int,
                 layers: int, classes: int, heads: int, decoder_heads: int,
                 levels: int, encoder_layers: int, ffn: int):
        super().__init__()
        self.levels, self.n_layers = levels, layers
        self.pixel_decoder = PixelDecoder(in_channels, dim, levels,
                                          encoder_layers, heads)
        self.level_embed = nn.Parameter(torch.empty(levels, dim))
        self.queries = nn.Parameter(torch.empty(queries, dim))
        self.query_pos = nn.Parameter(torch.empty(queries, dim))
        self.cls_head = Linear(dim, classes + 1)
        for i in range(3):
            setattr(self, f"mask_head{i}", Linear(dim, dim))
        self.decoder_norm = nn.LayerNorm(dim)
        for i in range(layers):
            setattr(self, f"layer{i}", DecoderLayer(dim, decoder_heads, ffn))

    def predict(self, q, mask_feats):
        dec = layer_norm(q, self.decoder_norm)
        embed = self.mask_head2(F.relu(self.mask_head1(
            F.relu(self.mask_head0(dec)))))
        masks = torch.einsum("bqc,bcxyz->bqxyz", self.q(embed),
                             self.q(mask_feats))
        return self.cls_head(dec), masks

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """feats: the 3D encoder's stages [B, Ci, X, Y, Z], finest first.
        -> ``decode``'s outputs, the mask features [B, X, Y, Z, C] and the
        decoder's memories ``memory<i>`` [B, X, Y, Z, C], coarsest first."""
        mask_feats, memories = self.pixel_decoder(feats)
        memories = memories[:self.levels]
        out = self.decode(mask_feats, memories)
        out["mask_features"] = mask_feats.movedim(1, -1)
        out.update((f"memory{i}", m.movedim(1, -1))
                   for i, m in enumerate(memories))
        return out

    def decode(self, mask_feats: torch.Tensor, memories: List[torch.Tensor],
               given: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """The queries through the layers over ``memories`` (channels
        first, coarsest first) against ``mask_feats`` [B, C, X, Y, Z] ->
        class logits, mask logits, ``attn_masks`` [B, Q, V1 + ...
        + Vn] (the attention mask each layer was given, layer after layer,
        True = not attended) and ``own_masks`` (the one the last prediction
        gives). Each layer is given its own where ``given`` is None, else
        its slice of ``given``."""
        b, dim = mask_feats.shape[:2]
        keys, poss, shapes = [], [], []
        for i, m in enumerate(memories):
            keys.append(m.flatten(2).transpose(1, 2) + self.level_embed[i])
            poss.append(sine_3d(m.shape[2:], dim, m.device)[None])
            shapes.append(tuple(m.shape[2:]))
        q = self.queries[None].repeat(b, 1, 1)
        qp = self.query_pos[None].repeat(b, 1, 1)
        cls, masks = self.predict(q, mask_feats)
        used, own, start = [], [], 0
        for i in range(self.n_layers):
            lvl = i % self.levels
            own.append(resize_masks(masks, shapes[lvl]).flatten(2) < 0.0)
            n = math.prod(shapes[lvl])
            used.append(own[-1] if given is None
                        else given[..., start:start + n])
            start += n
            q = getattr(self, f"layer{i}")(q, qp, keys[lvl], poss[lvl],
                                           used[-1])
            cls, masks = self.predict(q, mask_feats)
        return {"cls_logits": cls, "mask_logits": masks,
                "attn_masks": torch.cat(used, -1),
                "own_masks": torch.cat(own, -1)}


def semantic(cls_logits: torch.Tensor,
             mask_logits: torch.Tensor) -> torch.Tensor:
    """[B, classes, X, Y, Z]: sum over the queries of P(class | query)
    (the no-object class left out) times sigmoid(mask)."""
    probs = torch.softmax(cls_logits, dim=-1)[..., :-1]
    return torch.einsum("bqc,bqxyz->bcxyz", probs, torch.sigmoid(mask_logits))


class M2FDetector(nn.Module):
    """The whole model from a configuration file's ``model`` dict (the
    fields of the program's ``DetectorConfig``, ``head_type``
    ``Mask2FormerOccHead``)."""

    ranks = Detector.ranks

    def __init__(self, m: Dict):
        super().__init__()
        self.m = m
        lo, hi, step = m["dbound"]
        num_depth = int(round((hi - lo) / step))
        _, _, nx = geometry.gen_dx_bx(m["xbound"], m["ybound"], m["zbound"])
        self.img_backbone = EfficientNet(m["backbone_arch"],
                                         m["backbone_out_indices"],
                                         m["backbone_drop_path_rate"])
        self.img_neck = SECONDFPN(m["neck_in_channels"],
                                  m["neck_out_channels"],
                                  m["neck_upsample_strides"])
        self.img_view_transformer = ViewTransformer(
            num_depth, sum(m["neck_out_channels"]), m["numC_Trans"],
            m["cam_channels"], tuple(int(v) for v in nx),
            m["attention_chunk"])
        self.img_bev_encoder_backbone = ResNet3D(
            m["numC_Trans"], m["voxel_channels"], m["voxel_strides"],
            m["resnet_depth"], m["norm_groups"])
        self.out_indices = tuple(m["voxel_out_indices"])
        h = m["mask_head"]
        self.pts_bbox_head = Head(
            [m["voxel_channels"][i] for i in self.out_indices],
            h["num_queries"], h["embed_dim"], h["num_layers"],
            m["out_channel"], h["num_heads"],
            h.get("decoder_heads", h["num_heads"]), h["num_feat_levels"],
            h["num_encoder_layers"], h.get("ffn_dim", 4 * h["embed_dim"]))
        self.register_buffer("frustum", torch.from_numpy(
            geometry.create_frustum(tuple(m["input_size"]), m["downsample"],
                                    m["dbound"])), persistent=False)

    def forward(self, batch, generator=None,
                ranks=None) -> Dict[str, torch.Tensor]:
        """batch: imgs [B, 2, H, W, 3] and the calibration tensors ->
        cls_logits [B, Q, classes + 1], mask_logits [B, Q, X, Y, Z],
        mask_features [B, X, Y, Z, C] (the pixel decoder's), the head's
        attention masks and memories (``Head.forward``) and depth_prob
        [B, D, fH, fW]."""
        imgs = batch["imgs"].float()
        b = imgs.shape[0]
        flat = imgs.transpose(0, 1).reshape((2 * b,) + imgs.shape[2:])
        feats = self.img_neck(self.img_backbone(flat.permute(0, 3, 1, 2),
                                                generator, groups=2))
        mlp = geometry.get_mlp_input(batch["rots"], batch["trans"],
                                     batch["intrins"], batch["post_rots"],
                                     batch["post_trans"], batch["bda"])
        vox, depth_prob = self.img_view_transformer(
            feats[:b], feats[b:], mlp[:, 0], mlp[:, 1], batch["calib"],
            self.ranks(batch) if ranks is None else ranks, generator)
        stages = self.img_bev_encoder_backbone(vox)
        out = self.pts_bbox_head([stages[i] for i in self.out_indices])
        return dict(out, depth_prob=depth_prob)


def scores(outputs: Dict[str, torch.Tensor],
           label_shape: Sequence[int]) -> torch.Tensor:
    """The class scores [B, classes, *label_shape] of OccFormer's test
    path: the mask logits upsampled trilinearly, then ``semantic``."""
    return semantic(outputs["cls_logits"],
                    upsample(outputs["mask_logits"], label_shape))


def build(model_cfg: Dict, device, quantizer: Optional[Callable] = None,
          checkpoint_blocks: bool = False) -> M2FDetector:
    """The reference on ``device`` in float32, with every product through
    ``quantizer`` where one is given (``checkpoint_blocks``: serving only,
    nothing to recompute)."""
    with torch.device(device):
        model = M2FDetector(model_cfg)
    model.to(device)
    if quantizer is not None:
        set_quantizer(model, quantizer)
    return model.eval()
