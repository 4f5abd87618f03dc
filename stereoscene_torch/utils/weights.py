"""Weight bridge and seeded initialisation.

``load_flax_params(model, params, batch_stats)`` fills a port model from the
JAX package's parameter trees (nested dicts of numpy arrays, e.g. after
``jax.device_get``), and ``flax_trees(model)`` goes the other way: the
port's parameters and BatchNorm statistics, or any tensors keyed by its
parameter names such as gradients, as flax trees. The name map below is the
inverse of the JAX package's ``utils/convert_reference.build_name_map``:
every flax leaf path maps to the reference ``state_dict`` key the port
uses, with the layout transform from the flax layout to torch's (inverse of
``utils/checkpoint_convert.py``) and back.

The optional subsystems' parameters (CRP3D ``cp_mega_voxels``, the imgseg
head, the OccHead point branch) have no rule in the JAX package's
converter, so the port names them after the JAX module paths, which follow
the reference modules its docstrings cite (crp3d.py CPMegaVoxels under
resnet3d.py's backbone, bevdepth_occupancy.py's imgseg head, occhead.py's
point branch): ``img_bev_encoder_backbone.cp_mega_voxels.<name>``,
``imgseg_block0`` / ``imgseg_block1`` / ``imgseg_head`` and
``pts_bbox_head.{img_feat_reduce, soft_w1, soft_w2, point_occ_mlp}``.

A ``BEVOcc`` (``models/bevocc.py``) has no reference converter rule
either: ``bevocc_name_map`` names its keys after the JAX module paths, the
backbone keeping the reference layout. The variant modules whose
submodules carry the JAX scope names (``models/necks3d.py``,
``bevformer.py``, ``vit.py`` ...) map through ``module_rules``, which
reads the rules off the JAX module's own trees; ``load_rules`` and
``rules_trees`` apply any map. The nuScenes family's models
(``BEVFormerDetector``, ``Mask2FormerOccHead``) name every submodule after
its JAX scope, so their map is ``module_rules`` over ``flax_template``, the
tree of flax shapes read off the port module itself. The trees hold
copies, never views of the port's tensors.

``seeded_init_(model, seed)`` gives every tensor a deterministic value from a
``torch.Generator``, with the zero-initialised gates (BRI ``gamma``, CA3D
``alpha``) and the DCN offset head nonzero, so a run exercises every path.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

Transform = Callable[[np.ndarray], np.ndarray]
# (port key, flax -> torch layout, torch -> flax layout)
Rule = Tuple[str, Transform, Transform]


def _conv(w):  # flax [k..., Cin/g, Cout] -> torch [Cout, Cin/g, k...]
    nd = w.ndim - 2
    return np.transpose(w, (nd + 1, nd) + tuple(range(nd)))


def _conv_inv(w):  # torch [Cout, Cin/g, k...] -> flax [k..., Cin/g, Cout]
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, nd + 2)) + (1, 0))


def _deconv(w):  # flax [k..., Cin, Cout] -> torch [Cin, Cout, k...]
    nd = w.ndim - 2
    return np.transpose(w, (nd, nd + 1) + tuple(range(nd)))


def _deconv_inv(w):  # torch [Cin, Cout, k...] -> flax [k..., Cin, Cout]
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, nd + 2)) + (0, 1))


def _linear(w):  # flax [in, out] <-> torch [out, in]
    return np.transpose(w, (1, 0))


def _dense_as_conv(nd):  # flax [in, out] -> torch 1x1 conv [out, in, 1...]
    return lambda w: np.transpose(w, (1, 0)).reshape(
        w.shape[1], w.shape[0], *([1] * nd))


def _dense_as_conv_inv(w):  # torch 1x1 conv [out, in, 1...] -> flax
    return np.transpose(w.reshape(w.shape[0], w.shape[1]), (1, 0))


def _dcn(w):  # flax tap-major [9, Cin/g, Cout] -> torch [Cout, Cin/g, 3, 3]
    return np.transpose(w, (2, 1, 0)).reshape(w.shape[2], w.shape[1], 3, 3)


def _dcn_inv(w):  # torch [Cout, Cin/g, 3, 3] -> flax [9, Cin/g, Cout]
    return np.transpose(w.reshape(w.shape[0], w.shape[1], 9), (2, 1, 0))


def _scalar_conv(w):  # scalar affine of a C=1 1x1x1 conv3d
    return np.reshape(w, (1, 1, 1, 1, 1))


def _scalar_conv_inv(w):
    return np.reshape(w, ())


def _same(w):
    return np.asarray(w)


class _Map:
    def __init__(self):
        self.params: Dict[str, Rule] = {}
        self.stats: Dict[str, Rule] = {}
        self.unused: Tuple[str, ...] = ()  # port key prefixes flax lacks

    def raw(self, ours, theirs):
        """A parameter kept in the same layout (an embedding table)."""
        self.params[ours] = (theirs, _same, _same)

    def ln(self, ours, theirs):
        """A flax ``nn.LayerNorm`` (scale, bias) -> torch LayerNorm."""
        self.params[f"{ours}/scale"] = (f"{theirs}.weight", _same, _same)
        self.params[f"{ours}/bias"] = (f"{theirs}.bias", _same, _same)

    def conv(self, ours, theirs, bias=True, inner=True):
        """Our ConvNd wrapper (``Conv_0`` inside) or a bare conv leaf."""
        leaf = f"{ours}/Conv_0" if inner else ours
        self.params[f"{leaf}/kernel"] = (f"{theirs}.weight", _conv,
                                         _conv_inv)
        if bias:
            self.params[f"{leaf}/bias"] = (f"{theirs}.bias", _same, _same)

    def deconv(self, ours, theirs):
        self.params[f"{ours}/kernel"] = (f"{theirs}.weight", _deconv,
                                         _deconv_inv)

    def norm(self, ours, theirs, kind):
        leaf = f"{ours}/{kind}_0"
        self.params[f"{leaf}/scale"] = (f"{theirs}.weight", _same, _same)
        self.params[f"{leaf}/bias"] = (f"{theirs}.bias", _same, _same)
        if kind == "BatchNorm":
            self.stats[f"{leaf}/mean"] = (f"{theirs}.running_mean", _same,
                                          _same)
            self.stats[f"{leaf}/var"] = (f"{theirs}.running_var", _same,
                                         _same)

    def gn(self, ours, theirs):
        self.norm(ours, theirs, "GroupNorm")

    def bn(self, ours, theirs):
        self.norm(ours, theirs, "BatchNorm")

    def dense(self, ours, theirs, conv_nd=0):
        if conv_nd == 0:
            fwd, inv = _linear, _linear
        else:
            fwd, inv = _dense_as_conv(conv_nd), _dense_as_conv_inv
        self.params[f"{ours}/kernel"] = (f"{theirs}.weight", fwd, inv)
        self.params[f"{ours}/bias"] = (f"{theirs}.bias", _same, _same)

    def mlp(self, ours, theirs):
        self.dense(f"{ours}/fc1", f"{theirs}.fc1")
        self.dense(f"{ours}/fc2", f"{theirs}.fc2")

    def se(self, ours, theirs):
        self.dense(f"{ours}/conv_reduce", f"{theirs}.conv_reduce", 2)
        self.dense(f"{ours}/conv_expand", f"{theirs}.conv_expand", 2)

    def convgn3d(self, ours, theirs):
        self.conv(f"{ours}/conv", f"{theirs}.0", bias=False)
        self.gn(f"{ours}/gn", f"{theirs}.1")

    def hourglass(self, ours, theirs):
        for i in (1, 2, 3, 4):
            self.convgn3d(f"{ours}/conv{i}", f"{theirs}.conv{i}.0")
        for i in (5, 6):
            self.deconv(f"{ours}/conv{i}_deconv", f"{theirs}.conv{i}.0")
            self.bn(f"{ours}/conv{i}_bn", f"{theirs}.conv{i}.1")
        self.convgn3d(f"{ours}/redir1", f"{theirs}.redir1")
        self.convgn3d(f"{ours}/redir2", f"{theirs}.redir2")


def efficientnet_rules(m: _Map, arch: str, ours: str = "img_backbone",
                       theirs: str = "img_backbone.layers",
                       head: bool = True) -> None:
    """Rules of a ``CustomEfficientNet`` under flax scope ``ours`` and
    port key ``theirs``: the stem, every block (``InvertedResidual`` or the
    EdgeTPU family's ``EdgeResidual``: ``conv1`` / ``conv2``) and, with
    ``head``, the head conv (flax builds it only when out_indices takes
    stage 6)."""
    from ..models.efficientnet import scaled_stage_settings

    _, stages, _ = scaled_stage_settings(arch)

    def conv_module(o, t):
        m.conv(f"{o}/conv", f"{t}.conv", bias=False, inner=False)
        m.bn(f"{o}/bn", f"{t}.bn")

    conv_module(f"{ours}/stem", f"{theirs}.0")
    for s, stage in enumerate(stages, start=1):
        for j, blk in enumerate(stage):
            o, t = f"{ours}/stage{s}_block{j}", f"{theirs}.{s}.{j}"
            se, expand = blk[2], blk[4]
            if len(blk) == 7 and blk[5] == "edge":
                conv_module(f"{o}/conv1", f"{t}.conv1")
                conv_module(f"{o}/conv2", f"{t}.conv2")
                continue
            if expand != 1:
                conv_module(f"{o}/expand_conv", f"{t}.expand_conv")
            conv_module(f"{o}/depthwise_conv", f"{t}.depthwise_conv")
            if se > 0:
                m.dense(f"{o}/se/conv1", f"{t}.se.conv1.conv", 2)
                m.dense(f"{o}/se/conv2", f"{t}.se.conv2.conv", 2)
            conv_module(f"{o}/linear_conv", f"{t}.linear_conv")
    if head:
        conv_module(f"{ours}/head", f"{theirs}.{len(stages) + 1}")


def resnet3d_rules(m: _Map, depth: int, block_inplanes: Sequence[int],
                   block_strides: Sequence[int],
                   bev: str = "") -> None:
    """A ``CustomResNet3D`` at ``depth`` under the prefix ``bev`` (none
    for the module alone): its input projection, and its stages' flax
    ``layer{s}_block{j}/conv1..conv3, gn1..gn3, downsample_conv,
    downsample_gn`` -> the reference's ``layers.{s}.{j}.conv1..conv3,
    bn1..bn3, downsample.0/.1`` (conv3 / gn3 in the Bottleneck depths)."""
    from ..models.resnet3d import STAGE_BLOCKS, block_class

    ours_pre, theirs_pre = (f"{bev}/", f"{bev}.") if bev else ("", "")
    m.conv(f"{ours_pre}input_proj_conv", f"{theirs_pre}input_proj.0",
           bias=False)
    m.gn(f"{ours_pre}input_proj_gn", f"{theirs_pre}input_proj.1")
    block = block_class(depth)
    n_convs = 2 if block.expansion == 1 else 3
    strides = tuple(block_strides) + (2,) * len(block_inplanes)
    cin = block_inplanes[0]
    for s, planes in enumerate(block_inplanes):
        for j in range(STAGE_BLOCKS[depth][s]):
            ours = f"{ours_pre}layer{s}_block{j}"
            theirs = f"{theirs_pre}layers.{s}.{j}"
            for i in range(1, n_convs + 1):
                m.conv(f"{ours}/conv{i}", f"{theirs}.conv{i}", bias=False)
                m.gn(f"{ours}/gn{i}", f"{theirs}.bn{i}")
            stride = strides[s] if j == 0 else 1
            if stride != 1 or cin != planes * block.expansion:
                m.conv(f"{ours}/downsample_conv", f"{theirs}.downsample.0",
                       bias=False)
                m.gn(f"{ours}/downsample_gn", f"{theirs}.downsample.1")
            cin = planes * block.expansion


def flax_name_map(cfg, head=None) -> _Map:
    """flax leaf path -> (port state_dict key, flax->torch transform).
    ``head`` (the model's ``OccHead``) adds the rules of the point branch's
    image-feature and soft-weight layers, which the detector never builds
    but a head may."""
    m = _Map()
    efficientnet_rules(m, cfg.backbone_arch)

    for i, s in enumerate(cfg.neck_upsample_strides):
        theirs = f"img_neck.deblocks.{i}"
        if s >= 1:
            m.deconv(f"img_neck/deblock{i}_deconv", f"{theirs}.0")
        else:
            m.conv(f"img_neck/deblock{i}_conv", f"{theirs}.0", bias=False)
        m.bn(f"img_neck/deblock{i}_bn", f"{theirs}.1")

    vt, tvt = "img_view_transformer", "img_view_transformer"
    dn, tdn = f"{vt}/depth_net", f"{tvt}.depth_net"
    m.conv(f"{dn}/reduce_conv", f"{tdn}.reduce_conv.0")
    m.gn(f"{dn}/reduce_gn", f"{tdn}.reduce_conv.1")
    m.gn(f"{dn}/bn", f"{tdn}.bn")
    m.mlp(f"{dn}/depth_mlp", f"{tdn}.depth_mlp")
    m.mlp(f"{dn}/context_mlp", f"{tdn}.context_mlp")
    m.se(f"{dn}/depth_se", f"{tdn}.depth_se")
    m.se(f"{dn}/context_se", f"{tdn}.context_se")
    m.conv(f"{dn}/context_conv", f"{tdn}.context_conv")
    for i in range(3):
        ours, theirs = f"{dn}/block{i}", f"{tdn}.depth_conv.{i}"
        m.conv(f"{ours}/conv1", f"{theirs}.conv1", bias=False)
        m.bn(f"{ours}/bn1", f"{theirs}.bn1")
        m.conv(f"{ours}/conv2", f"{theirs}.conv2", bias=False)
        m.bn(f"{ours}/bn2", f"{theirs}.bn2")
    aspp, taspp = f"{dn}/aspp", f"{tdn}.depth_conv.3"
    for i in (1, 2, 3, 4):
        m.conv(f"{aspp}/aspp{i}_conv", f"{taspp}.aspp{i}.atrous_conv",
               bias=False, inner=False)
        m.bn(f"{aspp}/aspp{i}_bn", f"{taspp}.aspp{i}.bn")
    m.conv(f"{aspp}/gap_conv", f"{taspp}.global_avg_pool.1", bias=False)
    m.gn(f"{aspp}/gap_gn", f"{taspp}.global_avg_pool.2")
    m.conv(f"{aspp}/out_conv", f"{taspp}.conv1", bias=False)
    m.bn(f"{aspp}/out_bn", f"{taspp}.bn1")
    m.params[f"{dn}/dcn/weight"] = (f"{tdn}.depth_conv.4.weight", _dcn,
                                    _dcn_inv)
    m.conv(f"{dn}/dcn/conv_offset", f"{tdn}.depth_conv.4.conv_offset",
           inner=False)
    m.conv(f"{dn}/depth_pred", f"{tdn}.depth_conv.5")

    sv, tsv = f"{vt}/stereo_volume_net", f"{tvt}.stereo_volume_net"
    fw, tfw = f"{sv}/feature_withcam", f"{tsv}.feature_withcam"
    m.conv(f"{fw}/reduce_conv", f"{tfw}.reduce_conv.0")
    m.gn(f"{fw}/reduce_gn", f"{tfw}.reduce_conv.1")
    m.mlp(f"{fw}/depth_mlp", f"{tfw}.depth_mlp")
    m.se(f"{fw}/depth_se", f"{tfw}.depth_se")
    m.conv(f"{fw}/depth_conv", f"{tfw}.depth_conv.0")
    m.convgn3d(f"{sv}/dres0_0", f"{tsv}.dres0.0")
    m.convgn3d(f"{sv}/dres0_1", f"{tsv}.dres0.2")
    m.convgn3d(f"{sv}/dres1_0", f"{tsv}.dres1.0")
    m.convgn3d(f"{sv}/dres1_1", f"{tsv}.dres1.2")
    for name in ("dres2", "dres3", "dres4"):
        m.hourglass(f"{sv}/{name}", f"{tsv}.{name}")
    m.convgn3d(f"{sv}/classif3_1", f"{tsv}.classif3_1.0")
    m.conv(f"{sv}/classif3_2", f"{tsv}.classif3_2.0", bias=False)

    vi, tvi = f"{vt}/volume_interaction", f"{tvt}.volume_interaction"
    for d in ("lss2stereo", "stereo2lss"):
        for name in ("query", "key", "value"):
            m.params[f"{vi}/{d}/{name}_w"] = (
                f"{tvi}.{d}.{name}_conv.weight", _scalar_conv,
                _scalar_conv_inv)
            m.params[f"{vi}/{d}/{name}_b"] = (f"{tvi}.{d}.{name}_conv.bias",
                                              _same, _same)
        m.params[f"{vi}/{d}/gamma"] = (f"{tvi}.{d}.gamma", _same, _same)
    m.conv(f"{vi}/redir1", f"{tvi}.redir1")
    m.conv(f"{vi}/redir2", f"{tvi}.redir2")
    m.hourglass(f"{vi}/dres1", f"{tvi}.dres1")
    ca, tca = f"{vi}/ca3d", f"{tvi}.CA3D.fn"
    m.conv(f"{ca}/conv1", f"{tca}.conv1.0")
    m.gn(f"{ca}/gn1", f"{tca}.conv1.2")
    m.dense(f"{ca}/fc_reduce", f"{tca}.conv2.0", 3)
    m.dense(f"{ca}/fc_expand", f"{tca}.conv2.2", 3)
    m.conv(f"{ca}/conv2", f"{tca}.conv.0")
    m.gn(f"{ca}/gn2", f"{tca}.conv.2")
    m.params[f"{vi}/ca3d_alpha"] = (f"{tvi}.CA3D.alpha", _same, _same)

    bev = "img_bev_encoder_backbone"
    resnet3d_rules(m, cfg.resnet_depth, cfg.voxel_channels,
                   cfg.voxel_strides, bev)

    neck = "img_bev_encoder_neck"
    for i in range(len(cfg.voxel_channels)):
        m.deconv(f"{neck}/deblock{i}_deconv", f"{neck}.deblocks.{i}.0")
        m.gn(f"{neck}/deblock{i}_gn", f"{neck}.deblocks.{i}.1")

    if cfg.crp3d:
        cp = f"{bev}/cp_mega_voxels"
        tcp = f"{bev}.cp_mega_voxels"
        for name in ("mega_context", "voxel_reduce", "fuse"):
            m.conv(f"{cp}/{name}", f"{tcp}.{name}")
        m.gn(f"{cp}/voxel_gn", f"{tcp}.voxel_gn")
        m.dense(f"{cp}/mega_key", f"{tcp}.mega_key")
        m.dense(f"{cp}/relation_head", f"{tcp}.relation_head")

    if cfg.imgseg:
        for i in (0, 1):
            ours = f"imgseg_block{i}"
            for j in (1, 2):
                m.conv(f"{ours}/conv{j}", f"{ours}.conv{j}", bias=False)
                m.bn(f"{ours}/bn{j}", f"{ours}.bn{j}")
        m.conv("imgseg_head", "imgseg_head")

    ph = "pts_bbox_head"
    m.conv(f"{ph}/occ_conv0_0", f"{ph}.occ_convs.0.0", bias=False)
    m.gn(f"{ph}/occ_conv0_gn", f"{ph}.occ_convs.0.1")
    m.conv(f"{ph}/occ_conv0_1", f"{ph}.occ_convs.0.3", bias=False)
    if cfg.supervise_points or getattr(head, "supervise_points", False):
        m.mlp(f"{ph}/point_occ_mlp", f"{ph}.point_occ_mlp")
    for name in ("img_feat_reduce", "soft_w1", "soft_w2"):
        if hasattr(head, name):
            m.dense(f"{ph}/{name}", f"{ph}.{name}")
    return m


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _model_map(model) -> _Map:
    from ..models.bevformer_det import BEVFormerDetector
    from ..models.bevocc import BEVOcc
    from ..models.mask2former_occ import Mask2FormerOccHead

    if isinstance(model, BEVOcc):
        return bevocc_name_map(model)
    if isinstance(model, (BEVFormerDetector, Mask2FormerOccHead)):
        return module_rules(model, flax_template(model))
    return flax_name_map(model.cfg, model.pts_bbox_head)


@torch.no_grad()
def load_rules(module, name_map: _Map, params, batch_stats=None) -> None:
    """Copy flax trees into ``module`` under ``name_map`` (in place,
    keeping its dtype and device). Strict: every flax leaf must map to a
    port tensor of the same size, and every port tensor except BN step
    counters and the map's ``unused`` ones must be filled."""
    sd = module.state_dict()
    filled = set()
    for tree, rules in ((params, name_map.params),
                        (batch_stats or {}, name_map.stats)):
        for path, leaf in _flatten(tree).items():
            if path not in rules:
                raise KeyError(f"flax leaf {path} has no port counterpart")
            key, fwd, _ = rules[path]
            if key not in sd:
                raise KeyError(f"{path} -> {key}: not in the port state_dict")
            arr = fwd(np.asarray(leaf, dtype=np.float32))
            if tuple(arr.shape) != tuple(sd[key].shape):
                raise ValueError(f"{path} -> {key}: shape {arr.shape} != "
                                 f"{tuple(sd[key].shape)}")
            sd[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(key)
    missing = [k for k in sd if k not in filled
               and not k.endswith("num_batches_tracked")
               and not k.startswith(name_map.unused)]
    if missing:
        raise KeyError(f"{len(missing)} port tensors not filled, first 10: "
                       f"{missing[:10]}")


def load_flax_params(model, params, batch_stats) -> None:
    """Copy the JAX package's ``params`` / ``batch_stats`` trees into the
    port ``model`` (a ``BEVDepthOccupancy``, a ``BEVOcc``, a
    ``BEVFormerDetector`` or a ``Mask2FormerOccHead``), strictly
    (``load_rules``)."""
    load_rules(model, _model_map(model), params, batch_stats)


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def rules_trees(module, name_map: _Map, tensors=None):
    """``module``'s parameters and BatchNorm statistics as flax
    ``(params, batch_stats)`` trees of fp32 numpy arrays under
    ``name_map``. ``tensors`` (port key -> tensor, e.g. gradients)
    replaces the parameters; a parameter missing from it maps to zeros."""
    sd = module.state_dict()
    trees = []
    for rules, source in ((name_map.params, tensors),
                          (name_map.stats, None)):
        flat = {}
        for path, (key, _, inv) in rules.items():
            value = sd[key] if source is None else source.get(key)
            # a copy: a CPU tensor's .numpy() shares its memory, and a
            # later in-place update (BatchNorm statistics) would move the
            # tree, even under a JAX computation still running on it
            arr = (np.zeros(tuple(sd[key].shape), np.float32) if value is None
                   else value.detach().float().cpu().numpy().copy())
            flat[path] = np.ascontiguousarray(inv(arr))
        trees.append(_unflatten(flat))
    return trees[0], trees[1]


def flax_trees(model, tensors=None):
    """The port ``model``'s (as in ``load_flax_params``) parameters and
    BatchNorm statistics as the JAX package's ``(params, batch_stats)``
    trees (``rules_trees``)."""
    return rules_trees(model, _model_map(model), tensors)


def encoder_rules(m: _Map, ours: str, theirs: str, enc) -> None:
    """Rules of a ``bevformer.OccupancyEncoder`` ``enc`` under flax scope
    ``ours`` and port prefix ``theirs``."""
    m.raw(f"{ours}/bev_queries", f"{theirs}.bev_queries")
    for name in ("can_bus_mlp1", "can_bus_mlp2"):
        if hasattr(enc, name):
            m.dense(f"{ours}/{name}", f"{theirs}.{name}")
    if hasattr(enc, "can_bus_norm"):
        m.ln(f"{ours}/can_bus_norm", f"{theirs}.can_bus_norm")
    for i in range(enc.num_layers):
        o, t = f"{ours}/layer{i}", f"{theirs}.layer{i}"
        for name in ("norm1", "norm2", "norm3"):
            m.ln(f"{o}/{name}", f"{t}.{name}")
        for fo, ft in (("self_attn", "self_attn"),
                       ("cross_attn/deform", "cross_attn.deform")):
            for name in ("sampling_offsets", "attention_weights",
                         "value_proj", "output_proj"):
                m.dense(f"{o}/{fo}/{name}", f"{t}.{ft}.{name}")
        m.dense(f"{o}/ffn1", f"{t}.ffn1")
        m.dense(f"{o}/ffn2", f"{t}.ffn2")


def bevocc_name_map(model) -> _Map:
    """The rules of a ``models.bevocc.BEVOcc``. The JAX converter has no
    rule for this family, so the port's keys are the JAX module paths
    (``pts_bbox_head.transformer0.layer0.norm1.weight``); the backbone
    keeps the reference layout, and its head conv, which flax does not
    build under ``out_indices=(5,)``, is unused."""
    m = _Map()
    efficientnet_rules(m, model.backbone.split("-")[1], head=False)
    m.unused = (f"img_backbone.layers.{len(model.img_backbone.layers) - 1}.",)
    m.dense("img_neck", "img_neck")
    head = model.pts_bbox_head
    ph = "pts_bbox_head"
    for i in range(head.fpn_level):
        m.dense(f"{ph}/transfer_conv{i}", f"{ph}.transfer_conv{i}")
        pe = f"positional_encoding{i}"
        m.raw(f"{ph}/{pe}/row_embed", f"{ph}.{pe}.row_embed")
        m.raw(f"{ph}/{pe}/col_embed", f"{ph}.{pe}.col_embed")
        encoder_rules(m, f"{ph}/transformer{i}", f"{ph}.transformer{i}",
                      getattr(head, f"transformer{i}"))
        m.dense(f"{ph}/lift{i}", f"{ph}.lift{i}")
        m.conv(f"{ph}/occ{i}", f"{ph}.occ{i}")
        if head.pred_ground:
            m.conv(f"{ph}/ground{i}", f"{ph}.ground{i}")
    for k in range(1, head.fpn_level):
        m.deconv(f"{ph}/deblock{k}_deconv", f"{ph}.deblock{k}_deconv")
        m.gn(f"{ph}/deblock{k}_gn", f"{ph}.deblock{k}_gn")
    return m


# scopes of the JAX package's wrapper modules (layers.ConvNd, GroupNorm,
# BatchNorm), which hold the flax layer one level down
_WRAPPERS = {"Conv_0", "GroupNorm_0", "BatchNorm_0"}
_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _kernel_rule(mod, scope: str, shape) -> Tuple[Transform, Transform]:
    from ..models.depth_net import DeformConvPack

    if isinstance(mod, nn.modules.conv._ConvTransposeNd):
        return _deconv, _deconv_inv
    if isinstance(mod, nn.modules.conv._ConvNd):
        if len(shape) == 2:  # a flax Dense held as a 1x1 conv (SELayer)
            return _dense_as_conv(mod.weight.dim() - 2), _dense_as_conv_inv
        return _conv, _conv_inv
    if isinstance(mod, DeformConvPack):
        return _dcn, _dcn_inv
    if len(shape) == 2:
        return _linear, _linear
    # flax DenseGeneral (attention): [in, heads, head_dim] for the
    # projections, [heads, head_dim, out] for "out"
    if scope.endswith("out"):
        return (lambda w: w.reshape(-1, w.shape[-1]).T,
                lambda w, s=tuple(shape): w.T.reshape(s))
    return (lambda w: w.reshape(w.shape[0], -1).T,
            lambda w, s=tuple(shape): w.T.reshape(s))


def module_rules(module, params, batch_stats=None,
                 renames: Sequence[Tuple[str, str]] = ()) -> _Map:
    """Rules for a port ``module`` whose submodules are named after the
    JAX module's scopes, read off the JAX module's own trees (e.g. from
    ``init``): a scope's wrapper level (``Conv_0``, ``GroupNorm_0``,
    ``BatchNorm_0``) is dropped, ``renames`` maps a flax scope prefix to a
    port module path (``/``-separated) where the names differ, and the
    layout transform follows the port module's type (Linear, ConvNd,
    ConvTransposeNd, DCN, attention projections). Leaves: kernel / scale
    -> weight, mean / var -> running_mean / running_var, other names as
    they are."""
    from ..models.depth_net import DeformConvPack

    mods = dict(module.named_modules())
    m = _Map()
    for tree, rules in ((params, m.params), (batch_stats or {}, m.stats)):
        for path, leaf in _flatten(tree).items():
            *scope, name = path.split("/")
            scope = "/".join(s for s in scope if s not in _WRAPPERS)
            for old, new in renames:
                if scope == old or scope.startswith(old + "/"):
                    scope = new + scope[len(old):]
                    break
            mod_path = scope.replace("/", ".")
            if mod_path not in mods:
                raise KeyError(f"flax leaf {path}: no port module {mod_path}")
            mod = mods[mod_path]
            shape = np.shape(leaf)
            fwd = inv = _same
            if name == "kernel":
                fwd, inv = _kernel_rule(mod, scope, shape)
            elif name == "weight" and isinstance(mod, DeformConvPack):
                fwd, inv = _dcn, _dcn_inv
            elif name == "bias" and len(shape) > 1:
                fwd = lambda w: w.reshape(-1)  # noqa: E731
                inv = lambda w, s=tuple(shape): w.reshape(s)  # noqa: E731
            key = _LEAVES.get(name, name)
            rules[path] = (f"{mod_path}.{key}" if mod_path else key, fwd,
                           inv)
    return m


def flax_template(module):
    """The flax ``params`` tree of a port module whose submodules carry the
    JAX scope names and are flax's own layers, as read-only zero arrays of
    the flax shapes: a Linear is a Dense [in, out], or a DenseGeneral where
    its parent's ``dense_general`` names it ("in": [in, heads, dh] with a
    [heads, dh] bias; "out": [heads, dh, out]); a LayerNorm or GroupNorm
    holds scale and bias; a conv its [k..., in, out] kernel; any other
    module's own parameters keep their name and shape."""
    mods = dict(module.named_modules())
    flat = {}
    for path, mod in mods.items():
        pre = path.replace(".", "/") + "/" if path else ""
        if isinstance(mod, nn.Linear):
            parent, _, name = path.rpartition(".")
            kind = getattr(mods[parent], "dense_general", {}).get(name)
            heads = getattr(mods[parent], "num_heads", 1)
            cout, cin = mod.weight.shape
            kernel, bias = {
                "in": ((cin, heads, cout // heads), (heads, cout // heads)),
                "out": ((heads, cin // heads, cout), (cout,)),
            }.get(kind, ((cin, cout), (cout,)))
            leaves = {"kernel": kernel, "bias": bias}
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            leaves = {"scale": tuple(mod.weight.shape),
                      "bias": tuple(mod.bias.shape)}
        elif isinstance(mod, nn.modules.conv._ConvNd):
            cout, cin = mod.weight.shape[:2]
            leaves = {"kernel": tuple(mod.weight.shape[2:]) + (cin, cout),
                      "bias": None if mod.bias is None else (cout,)}
        else:
            leaves = {name: tuple(p.shape)
                      for name, p in mod.named_parameters(recurse=False)}
        for name, shape in leaves.items():
            if shape is not None:
                flat[pre + name] = np.broadcast_to(np.float32(0), shape)
    return _unflatten(flat)


@torch.no_grad()
def seeded_init_(model: torch.nn.Module, seed: int = 0) -> None:
    """Deterministic random weights from ``torch.Generator(seed)``:
    He-uniform conv / linear weights, small random biases, norm scales near
    1, random BN statistics, gates ``gamma`` / ``alpha`` = 0.3 and a DCN
    offset head with ~0.1x the usual scale (sub-pixel offsets)."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("running_mean"):
            val = torch.randn(t.shape, generator=gen) * 0.2
        elif name.endswith("running_var"):
            val = torch.rand(t.shape, generator=gen) * 0.5 + 0.75
        elif name.endswith((".gamma", ".alpha")):
            val = torch.full(t.shape, 0.3)
        elif t.dim() >= 2:
            fan_in = int(np.prod(t.shape[1:]))
            bound = (6.0 / fan_in) ** 0.5
            if "conv_offset" in name:
                bound *= 0.1
            val = (torch.rand(t.shape, generator=gen) * 2 - 1) * bound
        elif name.endswith(".weight"):  # norm scale
            val = 1.0 + 0.1 * torch.randn(t.shape, generator=gen)
        else:
            val = 0.1 * torch.randn(t.shape, generator=gen)
        t.copy_(val)
