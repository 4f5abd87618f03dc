"""The detector's Mask2Former head type (OccFormer's query-based head on
the StereoScene trunk) at TINY on the CPU:

- ``DetectorConfig.from_config`` reads the head from the reference-style
  config ``stereoscene_m2f_kitti.py``, and its head entry builds a TINY
  detector with no voxel neck;
- the default head type leaves ``BEVDepthOccupancy`` as it was: the same
  ``state_dict`` keys and shapes and the same outputs and class map as
  before the head type existed (digests and sums read off the detector
  then, seeded as here);
- ``infer`` and the eval step give the argmax of ``semantic_inference``
  over the mask logits upsampled trilinearly to the label grid;
- under a profiler the head opens its encoder and decoder spans inside
  ``stereoscene.bev``, and each deformable attention call its own;
- ``create_train_state`` refuses the head by name.
"""

import dataclasses
import hashlib
import json
import pathlib

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from stereoscene_torch.config import Config
from stereoscene_torch.engine.eval import make_eval_step
from stereoscene_torch.engine.train import create_train_state
from stereoscene_torch.metrics import empty_state
from stereoscene_torch.models.detector import (MASK_HEAD, BEVDepthOccupancy,
                                               DetectorConfig)
from stereoscene_torch.models.mask2former_occ import semantic_inference
from stereoscene_torch.tools import _frames
from stereoscene_torch.utils.weights import seeded_init_

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "stereoscene_torch" \
    / "configs"
LABEL_SHAPE = (32, 32, 8)
# the TINY detector's state_dict (name, shape) digest, and its outputs'
# sums and class map digest on frame seed 5 (torch.manual_seed(0),
# seeded_init_ 3), as the detector gave them before the head type existed
DEFAULT = {"keys": (725, "19d8a160e5dafd58e37b7c3fadf515517c3bcc305fe98d01"
                         "4febba56fc0fe997"),
           "output_voxels": (341.5632354913105, 11183.34711561675),
           "depth_prob": (128.0000002561137, 128.0000002561137),
           "classes": "7d82fc81c7fc2f6b816faa3c7b9d07e78535ee4f188ec4984f8b"
                      "86be4c95e486"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_m2f_config():
    """The TINY config with the m2f config's 3D encoder and head entries,
    shrunk to TINY widths."""
    cfg = Config.fromfile(str(CONFIGS / "stereoscene_tiny.py"))
    m2f = Config.fromfile(str(CONFIGS / "stereoscene_m2f_kitti.py"))
    model = cfg["model"]
    model["img_bev_encoder_backbone"] = dict(
        m2f["model"]["img_bev_encoder_backbone"], block_inplanes=[8, 16, 32],
        block_strides=[1, 2, 2], out_indices=(0, 1, 2),
        norm_cfg=dict(type="GN", num_groups=4, requires_grad=True))
    model["img_bev_encoder_neck"] = None
    model["pts_bbox_head"] = dict(
        m2f["model"]["pts_bbox_head"], in_channels=[8, 16, 32],
        feat_channels=12, num_queries=6, num_heads=4, num_decoder_heads=3,
        num_feat_levels=2, num_encoder_layers=2, num_decoder_layers=3,
        feedforward_channels=96)
    return DetectorConfig.from_config(cfg)


@pytest.fixture(scope="module")
def m2f():
    torch.manual_seed(0)
    cfg = tiny_m2f_config()
    model = BEVDepthOccupancy(cfg, device="cpu", label_shape=LABEL_SHAPE)
    seeded_init_(model, 3)
    return model, _frames.frame(cfg, "cpu", seed=5)


def test_config_reads_the_head():
    cfg = DetectorConfig.from_config(
        Config.fromfile(str(CONFIGS / "stereoscene_m2f_kitti.py")))
    assert (cfg.head_type, cfg.out_channel) == (MASK_HEAD, 20)
    assert cfg.mask_head == dict(
        num_queries=100, embed_dim=192, num_layers=9, num_heads=8,
        decoder_heads=6, num_feat_levels=3, num_encoder_layers=6,
        ffn_dim=1536)
    assert cfg.voxel_channels == (128, 256, 512, 1024)
    assert cfg.voxel_strides == (1, 2, 2, 2)
    assert cfg.voxel_out_indices == (0, 1, 2, 3)
    assert cfg.grid_shape == (128, 128, 16)
    # the trunk is the published config's, up to the 3D encoder
    kitti = DetectorConfig.from_config(
        Config.fromfile(str(CONFIGS / "stereoscene_semantickitti.py")))
    trunk = [f.name for f in dataclasses.fields(DetectorConfig)
             if not f.name.startswith(("voxel_", "fpn3d_", "mask_", "head_"))]
    assert all(getattr(cfg, k) == getattr(kitti, k) for k in trunk)


def test_m2f_builds_without_a_voxel_neck(m2f):
    model, _ = m2f
    names = {k.split(".")[0] for k in model.state_dict()}
    assert "img_bev_encoder_neck" not in names
    head = model.pts_bbox_head
    assert head.layer0.ffn.fc1.out_features == 96
    assert head.layer0.cross_attn.num_heads == 3
    assert head.pixel_decoder.encoder0.ffn.fc1.out_features == 4 * 12
    assert head.pixel_decoder.encoder0.num_heads == 4


def test_default_head_type_is_unchanged():
    torch.manual_seed(0)
    cfg = DetectorConfig.from_config(
        Config.fromfile(str(CONFIGS / "stereoscene_tiny.py")))
    assert cfg.head_type == "OccHead"
    model = BEVDepthOccupancy(cfg, device="cpu", label_shape=LABEL_SHAPE)
    seeded_init_(model, 3)
    spec = [(k, list(v.shape)) for k, v in model.state_dict().items()]
    assert (len(spec), hashlib.sha256(json.dumps(spec).encode())
            .hexdigest()) == DEFAULT["keys"]
    batch = _frames.frame(cfg, "cpu", seed=5)
    out = model(batch)
    assert set(out) == {"output_voxels", "depth_prob"}
    for key in out:
        sums = (float(out[key].double().sum()),
                float(out[key].double().abs().sum()))
        assert sums == pytest.approx(DEFAULT[key], rel=1e-5), key
    classes = model.infer(batch)
    assert hashlib.sha256(classes.numpy().tobytes()).hexdigest() == \
        DEFAULT["classes"]


def test_infer_is_semantic_inference_of_the_upsampled_masks(m2f):
    model, batch = m2f
    out = model(batch)
    assert set(out) == {"cls_logits", "mask_logits", "depth_prob"}
    b, q = out["cls_logits"].shape[:2]
    assert out["cls_logits"].shape == (b, q, 21)
    assert out["mask_logits"].shape == (b, q, 16, 16, 4)
    masks = F.interpolate(out["mask_logits"], size=LABEL_SHAPE,
                          mode="trilinear", align_corners=False)
    want = semantic_inference(out["cls_logits"], masks).argmax(-1)
    classes = model.infer(batch)
    assert classes.dtype == torch.int64 and torch.equal(classes, want)
    pred, _ = make_eval_step(LABEL_SHAPE)(model, batch, empty_state())
    assert torch.equal(pred, want)


def test_head_spans_open_under_a_profiler(m2f):
    model, batch = m2f
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.infer(batch)
    spans = {}
    for e in prof.events():
        if e.name.startswith("stereoscene."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    (bev,) = spans["stereoscene.bev"]
    (enc,) = spans["stereoscene.head.encoder"]
    (dec,) = spans["stereoscene.head.decoder"]
    assert bev[0] <= enc[0] < enc[1] <= dec[0] < dec[1] <= bev[1]
    deform = spans["stereoscene.msdeform"]
    assert len(deform) == model.cfg.mask_head["num_encoder_layers"] == 2
    assert all(enc[0] <= s < e <= enc[1] for s, e in deform)


def test_train_state_refuses_the_head(m2f):
    model, _ = m2f
    with pytest.raises(NotImplementedError, match=MASK_HEAD):
        create_train_state(model, device="cpu")
