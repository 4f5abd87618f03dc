"""Top-level stereo occupancy detector, port of
``stereoscene_tpu/models/detector.py``
(ref: occupancy/detectors/bevdepth_occupancy.py:23-359).

Both views run through one backbone + neck (eye-major batch concat), the
view transformer lifts the LEFT camera's context features through the
MIE-fused depth distribution into the voxel grid over a static splat plan,
and the 3D encoder + head predict occupancy logits. ``infer`` adds the
serving tail: trilinear upsample to the label grid and argmax.

The optional subsystems of the JAX package (bevdepth_occupancy.py:27
use_grid_mask, ViewTransformerLSSVoxel.py:327-340 imgseg, resnet3d.py:
158-165 crp3d, occhead.py:171-218 supervise_points; all off in the scored
config) are switches of ``DetectorConfig``, as there: the grid mask acts in
training mode only, drawn from the step's generator; the imgseg head (two
BasicBlocks and a 1x1 conv on the left features) gives ``imgseg_logits``;
CRP3D gives ``crp_logits``; the point branch gives ``output_points`` for
a batch with ``points_occ``.

The batch is the JAX package's dict (channels-last images, KITTI 3x4
intrinsics; see ``BEVDepthOccupancy.forward``) as torch tensors on one
device. ``use_kernel`` picks the hand-written CUDA kernels (K1
``fused_gwc_warp``, P1 ``deform_conv2d``, K3 ``lift_splat_fused``, and
under the Mask2Former head ``msdeform_attn_3d``); None means "the kernels
when the tensors are on CUDA". The model is built with
``conv3d_kernel=True`` to send the hourglass and ResNet3D convs the JAX
package's gate picks to K4 (``layers.Conv3d``).

Eval mode (the default) is inference, under ``torch.no_grad``; training
mode (``model.train()``) is the JAX package's ``train=True``: BatchNorm on
batch statistics, DropPath and dropout, gradients, and the dynamic-rank
splat unless the batch carries a plan (detector.py:266-288).

Spatial sharding (``parallel.spatial``, the JAX package's
``voxel_constraint``, detector.py:363-364): over a space group of S > 1
ranks each rank runs the image side and the splat whole, keeps the X slab
of its rank from the voxel features, and runs the 3D encoder, its neck
and the head on the slab. In training the logits stay slabs (the losses
take the matching slab of the labels, ``engine.train``); in eval they are
gathered whole on every space rank. The branches that read the whole grid
run on it too: CRP3D gathers its stage's slabs and runs whole on every
space rank (``models/resnet3d.py``), and the point branch samples each
point on the rank whose slab holds it and sums the samples over the space
group (``models/occhead.py``).

``resnet_depth`` picks the 3D encoder's blocks (BasicBlock at 10/18/34,
Bottleneck at 50/101, whose stages are 4x ``voxel_channels`` wide); the
voxel neck and CRP3D take each stage's real width.

``head_type`` picks the head. ``OccHead`` (the default) is StereoScene's:
SECONDFPN3D over the 3D encoder's stages, then the 3D conv head, and
``output_voxels``. ``Mask2FormerOccHead`` is OccFormer's query-based head
(``models/mask2former_occ.py``, built with the keyword arguments of
``mask_head``) straight on the 3D encoder's pyramid, with no voxel neck: the forward gives
``cls_logits`` [B, Q, classes + 1] and ``mask_logits`` [B, Q, X, Y, Z]
(fp32), and the class map is OccFormer's test path, the mask logits
upsampled trilinearly to the label grid, ``semantic_inference``, then
argmax (``BEVDepthOccupancy.class_scores``). It serves and evaluates; it
does not train yet (``engine.train.create_train_state`` refuses it), and
it runs on the whole grid only (no spatial sharding, no point branch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .. import geometry
from ..data.augment import grid_mask
from ..ops.resize import resize_trilinear
from ..ops.splat_plan import SplatPlanCache
from ..parallel import spatial
from ..utils.spans import span
from .depth_net import BasicBlock2d
from .efficientnet import CustomEfficientNet
from .layers import checkpoint_region, remat
from .lss import ViewTransformerLiftSplatShootVoxel
from .mask2former_occ import Mask2FormerOccHead, semantic_inference
from .occhead import OccHead
from .resnet3d import CustomResNet3D, stage_widths
from .second_fpn import SECONDFPN, SECONDFPN3D


MASK_HEAD = "Mask2FormerOccHead"
# a reference-style config's Mask2FormerOccHead entry -> the head's keywords
MASK_HEAD_KEYS = {"num_queries": "num_queries",
                  "feat_channels": "embed_dim",
                  "num_decoder_layers": "num_layers",
                  "num_heads": "num_heads",
                  "num_decoder_heads": "decoder_heads",
                  "num_feat_levels": "num_feat_levels",
                  "num_encoder_layers": "num_encoder_layers",
                  "feedforward_channels": "ffn_dim"}


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static hyperparameters of the active stereoscene model; the same
    fields and defaults as the JAX package's ``DetectorConfig``. The
    backbone's drop path and checkpointing act in training mode, and so
    does ``bev_with_cp``, which checkpoints the view transformer (and each
    of its hourglasses and its MIE block within it), the voxel encoder and
    its neck (``BEVDepthOccupancy.view_transform``, ``bev_outputs``).
    ``crp_mega_shape`` must
    divide the grid of stage ``crp_level`` = 2 (the flagship's 16x16x2
    takes (8, 8, 1), which matches ``relation_label_shape`` (16, 16, 2) of
    the pipeline). ``head_type`` and ``mask_head`` (the Mask2Former head's
    keyword arguments, unused by ``OccHead``) are the port's own: the JAX
    package has one head."""

    input_size: Tuple[int, int] = (384, 1280)
    downsample: int = 8
    xbound: Tuple[float, float, float] = (0.0, 51.2, 0.8)
    ybound: Tuple[float, float, float] = (-25.6, 25.6, 0.8)
    zbound: Tuple[float, float, float] = (-2.0, 4.4, 0.8)
    dbound: Tuple[float, float, float] = (2.0, 58.0, 0.5)
    bev_with_cp: bool = False
    backbone_arch: str = "b7"
    backbone_out_indices: Tuple[int, ...] = (2, 3, 4, 5, 6)
    backbone_drop_path_rate: float = 0.2
    backbone_with_cp: bool = True
    neck_in_channels: Tuple[int, ...] = (48, 80, 224, 640, 2560)
    neck_upsample_strides: Tuple[float, ...] = (0.5, 1, 2, 4, 4)
    neck_out_channels: Tuple[int, ...] = (128, 128, 128, 128, 128)
    numC_Trans: int = 128
    cam_channels: int = 30
    voxel_channels: Tuple[int, ...] = (128, 256, 512)
    voxel_out_indices: Tuple[int, ...] = (0, 1, 2)
    voxel_out_channels: Tuple[int, ...] = (128, 128, 128)
    voxel_strides: Tuple[int, ...] = (1, 2, 2)
    fpn3d_upsample_strides: Tuple[int, ...] = (1, 2, 4)
    out_channel: int = 20
    resnet_depth: int = 18
    norm_groups: int = 32
    attention_chunk: int = 1024
    splat_group: int = 8
    use_grid_mask: bool = False
    imgseg: bool = False
    imgseg_class: int = 20
    crp3d: bool = False
    crp_mega_shape: Tuple[int, int, int] = (32, 32, 4)
    supervise_points: bool = False
    head_type: str = "OccHead"
    mask_head: Optional[Dict[str, int]] = None

    @property
    def num_depth(self) -> int:
        lo, hi, step = self.dbound
        return int(round((hi - lo) / step))

    @property
    def feature_size(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.downsample,
                self.input_size[1] // self.downsample)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        _, _, nx = geometry.gen_dx_bx(self.xbound, self.ybound, self.zbound)
        return (int(nx[0]), int(nx[1]), int(nx[2]))

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "DetectorConfig":
        """Build from a reference-style config dict (stereoscene.py keys),
        as the JAX package's ``DetectorConfig.from_config``
        (models/detector.py:113-147)."""
        model = cfg["model"]
        vt = model["img_view_transformer"]
        grid, data = vt["grid_config"], vt["data_config"]
        bb, neck = model["img_backbone"], model["img_neck"]
        bev_bb = model["img_bev_encoder_backbone"]
        head = model["pts_bbox_head"]
        if head["type"] == MASK_HEAD:
            fields = dict(head_type=MASK_HEAD,
                          out_channel=head["num_occupancy_classes"],
                          mask_head={v: head[k] for k, v in
                                     MASK_HEAD_KEYS.items() if k in head})
        else:
            bev_neck = model["img_bev_encoder_neck"]
            fields = dict(
                voxel_out_channels=tuple(bev_neck["out_channels"]),
                fpn3d_upsample_strides=tuple(bev_neck["upsample_strides"]),
                out_channel=head["out_channel"])
        if "block_strides" in bev_bb:
            fields["voxel_strides"] = tuple(bev_bb["block_strides"])
        return cls(
            input_size=tuple(data["input_size"]),
            downsample=vt["downsample"],
            xbound=tuple(grid["xbound"]),
            ybound=tuple(grid["ybound"]),
            zbound=tuple(grid["zbound"]),
            dbound=tuple(grid["dbound"]),
            backbone_arch=bb["arch"],
            backbone_out_indices=tuple(bb["out_indices"]),
            backbone_drop_path_rate=bb.get("drop_path_rate", 0.0),
            backbone_with_cp=bb.get("with_cp", False),
            neck_in_channels=tuple(neck["in_channels"]),
            neck_upsample_strides=tuple(neck["upsample_strides"]),
            neck_out_channels=tuple(neck["out_channels"]),
            numC_Trans=vt["numC_Trans"],
            cam_channels=vt["cam_channels"],
            voxel_channels=tuple(bev_bb["block_inplanes"]),
            voxel_out_indices=tuple(bev_bb["out_indices"]),
            resnet_depth=bev_bb["depth"],
            use_grid_mask=model.get("use_grid_mask", False),
            norm_groups=bev_bb.get("norm_cfg", {}).get("num_groups", 32),
            **fields,
        )


class BEVDepthOccupancy(nn.Module):
    """The stereo occupancy model. ``state_dict`` keys follow the reference
    checkpoint layout. It is built on ``device``, by default the CUDA card;
    the CPU only when asked for."""

    def __init__(self, cfg: DetectorConfig, device=None,
                 conv3d_kernel: bool = False,
                 label_shape: Tuple[int, int, int] = (256, 256, 32)):
        super().__init__()
        self.cfg = cfg
        self.label_shape = tuple(label_shape)
        self.img_backbone = CustomEfficientNet(
            cfg.backbone_arch, cfg.backbone_out_indices,
            cfg.backbone_drop_path_rate, cfg.backbone_with_cp)
        self.img_neck = SECONDFPN(cfg.neck_in_channels, cfg.neck_out_channels,
                                  cfg.neck_upsample_strides)
        self.img_view_transformer = ViewTransformerLiftSplatShootVoxel(
            num_depth=cfg.num_depth, numC_input=sum(cfg.neck_out_channels),
            numC_Trans=cfg.numC_Trans, cam_channels=cfg.cam_channels,
            grid_shape=cfg.grid_shape, attention_chunk=cfg.attention_chunk,
            splat_group=cfg.splat_group, conv3d_kernel=conv3d_kernel,
            with_cp=cfg.bev_with_cp)
        strides = tuple(cfg.voxel_strides) + (2,) * (
            len(cfg.voxel_channels) - len(cfg.voxel_strides))
        self.voxel_total_stride = math.prod(strides)
        self.img_bev_encoder_backbone = CustomResNet3D(
            cfg.numC_Trans, cfg.voxel_channels, strides,
            depth=cfg.resnet_depth, norm_groups=cfg.norm_groups,
            conv3d_kernel=conv3d_kernel, crp3d=cfg.crp3d,
            crp_mega_shape=cfg.crp_mega_shape,
            out_indices=cfg.voxel_out_indices)
        widths = stage_widths(cfg.resnet_depth, cfg.voxel_channels)
        self.mask_head = cfg.head_type == MASK_HEAD
        if self.mask_head:
            if cfg.supervise_points:
                raise ValueError(f"{MASK_HEAD} has no point branch")
            self.pts_bbox_head = Mask2FormerOccHead(
                [widths[i] for i in cfg.voxel_out_indices],
                num_classes=cfg.out_channel,
                device=torch.device("cuda") if device is None else device,
                **(cfg.mask_head or {}))
        elif cfg.head_type == "OccHead":
            self.img_bev_encoder_neck = SECONDFPN3D(
                widths, cfg.voxel_out_channels, cfg.fpn3d_upsample_strides,
                cfg.norm_groups)
            self.pts_bbox_head = OccHead(
                sum(cfg.voxel_out_channels), cfg.out_channel,
                cfg.norm_groups, supervise_points=cfg.supervise_points)
        else:
            raise ValueError(f"unknown head_type {cfg.head_type!r} (OccHead "
                             f"or {MASK_HEAD})")
        if cfg.imgseg:
            n = sum(cfg.neck_out_channels)
            self.imgseg_block0 = BasicBlock2d(n)
            self.imgseg_block1 = BasicBlock2d(n)
            self.imgseg_head = nn.Conv2d(n, cfg.imgseg_class, 1)
        self.frustum = torch.from_numpy(geometry.create_frustum(
            cfg.input_size, cfg.downsample, cfg.dbound))
        self.plan_cache = SplatPlanCache(self)
        self.to(torch.device("cuda") if device is None else device)
        self.eval()

    # ---- stage 1: shared image encoder over both eyes ----
    def encode_images(self, imgs: torch.Tensor, generator=None):
        """imgs [B, 2, H, W, 3] -> (left, right) [B, C, fH, fW]. In
        training mode with ``use_grid_mask`` the images are grid-masked
        first, one draw per image from ``generator``."""
        with span("stereoscene.images"):
            b = imgs.shape[0]
            flat = imgs.transpose(0, 1).reshape((2 * b,) + imgs.shape[2:])
            flat = flat.permute(0, 3, 1, 2)
            if self.cfg.use_grid_mask and self.training:
                flat = grid_mask(flat, generator, groups=2)
            feats = self.img_backbone(flat, generator, groups=2)
            neck = self.img_neck(feats)
            return neck[:b], neck[b:]

    # ---- geometry: voxel ranks of the LEFT camera's frustum ----
    def compute_ranks(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, D*fH*fW] int32 voxel ranks (sentinel X*Y*Z out of bounds),
        computed on the device of ``batch['rots']``."""
        cfg = self.cfg
        geom = geometry.get_geometry(
            self.frustum.to(batch["rots"].device),
            batch["rots"][:, :1], batch["trans"][:, :1],
            batch["intrins"][:, :1], batch["post_rots"][:, :1],
            batch["post_trans"][:, :1], batch["bda"])[:, 0]
        dx, bx, nx = geometry.gen_dx_bx(cfg.xbound, cfg.ybound, cfg.zbound)
        coords, valid = geometry.voxel_indices(geom, dx, bx, nx)
        ranks = geometry.flatten_voxel_ranks(coords, valid, nx)
        return ranks.reshape(geom.shape[0], -1)

    def attach_plan(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """The batch with its static splat plan (cached per calibration)."""
        if "splat_order" in batch:
            return batch
        return self.plan_cache.attach(batch)

    # ---- stage 2: stereo + mono + MIE + lift-splat ----
    def view_transform(self, feat_left, feat_right, batch, use_kernel=None,
                       generator=None):
        """-> (voxel features [B, C, X, Y, Z], depth_prob [B, D, fH, fW]);
        the splat follows the batch's plan (``attach_plan``) or, without
        one, the dynamic ranks of ``compute_ranks``."""
        with span("stereoscene.view"):
            mlp = geometry.get_mlp_input(
                batch["rots"], batch["trans"], batch["intrins"],
                batch["post_rots"], batch["post_trans"], batch["bda"],
            ).to(feat_left.dtype)
            if "splat_order" in batch:
                plan = (batch["splat_order"], batch["splat_ranks"],
                        batch["splat_bounds"])
            else:
                plan = self.compute_ranks(batch)
            vt = self.img_view_transformer
            args = (feat_left, feat_right, mlp[:, 0], mlp[:, 1],
                    batch["calib"], plan, use_kernel)
            # bev_with_cp (detector.py:174-196 of the JAX package: nn.remat
            # of the view transformer, the voxel encoder and its neck) acts
            # in training under grad
            if not (self.cfg.bev_with_cp and self.training
                    and torch.is_grad_enabled()):
                return vt(*args, generator)
            # the dropout mask is drawn before the region, so the recompute
            # sees it (the generator would give another)
            return checkpoint_region(
                vt, vt, *args, None,
                vt.depth_net.aspp_mask(feat_left, generator))

    def check_sharding(self) -> None:
        """Raise, by name, where this model cannot run on the space group's
        layout: a grid X that does not divide into slabs at every stride
        of the 3D encoder, or the Mask2Former head (whole grid only)."""
        if spatial.active():
            if self.mask_head:
                raise ValueError(f"{MASK_HEAD} runs on the whole grid only, "
                                 "not on a space group's slabs")
            spatial.check_grid(self.cfg.grid_shape[0],
                               self.voxel_total_stride)

    # ---- stage 3: 3D encoder + head ----
    def bev_encode(self, voxel_feat):
        """[B, C, X, Y, Z] -> logits [B, classes, X, Y, Z] (the Mask2Former
        head: its output dict)."""
        return self.bev_outputs(voxel_feat)[0]

    def bev_outputs(self, voxel_feat, points=None, img_feats=None,
                    points_uv=None, use_kernel=None):
        """-> (logits [B, classes, X, Y, Z], point logits [B, P, classes]
        or None, CRP relation logits or None); the point branch runs where
        ``points`` are given. The Mask2Former head gives its output dict
        (``cls_logits``, ``mask_logits``, ``aux``) in the logits' place;
        ``use_kernel`` goes to its deformable attention."""
        cp = self.cfg.bev_with_cp
        with span("stereoscene.bev"):
            outs = remat(cp, self.img_bev_encoder_backbone, voxel_feat)
            crp_logits = points_out = None
            if self.cfg.crp3d:
                outs, crp_logits = outs
            if self.mask_head:  # channels-last levels, high-res first
                return self.pts_bbox_head(
                    [f.permute(0, 2, 3, 4, 1) for f in outs],
                    use_kernel), None, crp_logits
            fused = remat(cp, self.img_bev_encoder_neck, outs)
            if self.cfg.supervise_points and points is not None:
                points_out = self.pts_bbox_head.forward_points(
                    fused, points, img_feats, points_uv)
            return self.pts_bbox_head(fused), points_out, crp_logits

    def _normalized_points(self, batch):
        """points_occ ego xyz -> [-1, 1]^3 grid coordinates for the point
        branch (normalised by the grid's bounds, occhead.py:180-186)."""
        cfg = self.cfg
        dev = batch["points_occ"].device
        lo = torch.tensor([cfg.xbound[0], cfg.ybound[0], cfg.zbound[0]],
                          dtype=torch.float32, device=dev)
        hi = torch.tensor([cfg.xbound[1], cfg.ybound[1], cfg.zbound[1]],
                          dtype=torch.float32, device=dev)
        pts = batch["points_occ"][..., :3].float()
        return (pts - lo) / (hi - lo) * 2.0 - 1.0

    def forward(self, batch: Dict[str, torch.Tensor], use_kernel=None,
                generator=None):
        """batch (channels-last, one device):
          imgs [B, 2, H, W, 3]; rots [B, 2, 3, 3]; trans [B, 2, 3];
          intrins [B, 2, 3, 4]; post_rots [B, 2, 3, 3]; post_trans [B, 2, 3];
          bda [B, 3, 3]; calib [B] (fx * baseline); optionally the plan
          (splat_order / splat_ranks / splat_bounds), and for the point
          branch points_occ [B, P, 4] and points_uv [B, P, 3].
        Returns output_voxels [B, X, Y, Z, classes] (in training on a
        sharded grid, this rank's slab [B, X / S, Y, Z, classes]), depth_prob
        [B, D, fH, fW], and where their switches are on output_points
        [B, P, classes] (for a batch with points_occ), imgseg_logits
        [B, fH, fW, imgseg_class] and crp_logits [B, 4, V, M]. (The JAX
        package returns those three as None when off; here they are left
        out, so every value of the dict is a tensor.) The Mask2Former head
        gives cls_logits [B, Q, classes + 1] and mask_logits [B, Q, X, Y, Z]
        (fp32) in output_voxels' place.

        Eval mode: inference without autograd, in the parameters' dtype,
        over the batch's plan (built and cached when missing). Training
        mode: with autograd, in the images' dtype (the bf16 policy casts
        them, ``engine.train``), over the batch's plan or else the dynamic
        ranks; ``generator`` seeds DropPath and dropout."""
        if self.training:
            return self._forward(batch, batch["imgs"], use_kernel, generator)
        with torch.no_grad():
            batch = self.attach_plan(batch)
            dtype = next(self.parameters()).dtype
            return self._forward(batch, batch["imgs"].to(dtype), use_kernel,
                                 None)

    def _forward(self, batch, imgs, use_kernel, generator):
        feat_left, feat_right = self.encode_images(imgs, generator)
        imgseg_logits = None
        if self.cfg.imgseg:
            seg = self.imgseg_block1(self.imgseg_block0(feat_left))
            imgseg_logits = self.imgseg_head(seg).permute(0, 2, 3, 1)
        voxel_feat, depth_prob = self.view_transform(
            feat_left, feat_right, batch, use_kernel, generator)
        if spatial.active():
            self.check_sharding()
            voxel_feat = spatial.shard_voxels(voxel_feat)
        points = points_uv = None
        if self.cfg.supervise_points and "points_occ" in batch:
            points = self._normalized_points(batch)
            if "points_uv" in batch:
                points_uv = batch["points_uv"][..., :2]
        logits, output_points, crp_logits = self.bev_outputs(
            voxel_feat, points, feat_left, points_uv, use_kernel)
        if self.mask_head:
            out = {"cls_logits": logits["cls_logits"],
                   "mask_logits": logits["mask_logits"],
                   "depth_prob": depth_prob, "imgseg_logits": imgseg_logits,
                   "crp_logits": crp_logits}
            return {k: v for k, v in out.items() if v is not None}
        logits = logits.permute(0, 2, 3, 4, 1)
        if not self.training:
            logits = spatial.gather_slabs(logits, dim=1)
        out = {"output_voxels": logits,
               "depth_prob": depth_prob,
               "output_points": output_points,
               "imgseg_logits": imgseg_logits,
               "crp_logits": crp_logits}
        return {k: v for k, v in out.items() if v is not None}

    @torch.no_grad()
    def infer(self, batch: Dict[str, torch.Tensor],
              use_kernel=None) -> torch.Tensor:
        """Class map [B, *label_shape] (int64): fp32 logits upsampled
        trilinearly to the label grid, then argmax (bench.py:195-200); the
        Mask2Former head: argmax of its ``class_scores`` on the label grid
        (OccFormer's ``simple_test``)."""
        with span("stereoscene.infer"):
            out = self.forward(batch, use_kernel)
            with span("stereoscene.classmap"):
                return self.class_scores(out, self.label_shape).argmax(-1)

    def class_scores(self, out: Dict[str, torch.Tensor],
                     shape) -> torch.Tensor:
        """fp32 class scores [B, *shape, classes] of ``forward``'s outputs
        on the grid ``shape``: the logits resized trilinearly; the
        Mask2Former head: OccFormer's ``simple_test``, the mask logits
        resized trilinearly, then ``semantic_inference``."""
        shape = tuple(shape)
        if self.mask_head:
            masks = out["mask_logits"].float()
            if tuple(masks.shape[2:]) != shape:
                masks = resize_trilinear(masks[..., None], shape)[..., 0]
            return semantic_inference(out["cls_logits"], masks)
        logits = out["output_voxels"].float()
        if tuple(logits.shape[1:4]) != shape:
            logits = resize_trilinear(logits, shape)
        return logits

