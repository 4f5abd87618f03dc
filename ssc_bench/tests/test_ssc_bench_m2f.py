"""The ``stereoscene_m2f`` family at test widths on the CPU (float32): the
program (``BEVDepthOccupancy`` with the Mask2Former head) against its
plain reference (``reference/stereoscene_m2f.py``) on one seeded
``state_dict``: the deformable sampling alone, the head's outputs,
``semantic_inference`` and the class map of ``infer``; then the serving
comparison through ``serve.run``, sound, with the attention mask ignored
and with the last decoder layer skipped, which the limits must catch."""

import json
import os
import time

import pytest
import torch

from ssc_bench import generate, harness, m2f_faults, serve
from ssc_bench.cell import Cell, load
from ssc_bench.families import stereoscene_m2f as family
from ssc_bench.reference import stereoscene_m2f as reference

from .conftest import HERE, ROOT

# float32 on both sides: the gaps are rounding (sound runs read 1e-6)
LIMITS = {"depth_gap": 1e-4, "feature_gap": 1e-4, "mask_gap": 1e-4,
          "sem_gap": 1e-4, "class_gap": 1e-4, "attn_mask_gap": 1e-4}
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(HERE, "tiny_m2f.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pair(tiny):
    """(program, reference, batch) on one seeded state_dict."""
    torch.set_num_threads(2)
    state = harness.seeded_weights(tiny, SEED, "cpu")
    prog = family.build_program(tiny, "cpu")
    ref = family.build_reference(tiny["model"], "cpu")
    harness.load_weights(prog, state)
    harness.load_weights(ref, state)
    traffic = load(ROOT, "m2f-serve-stream").traffic
    m = tiny["model"]
    batch = dict(generate.geometry_batch(traffic, m["input_size"], 1, 0,
                                         "cpu"),
                 imgs=generate.frame_pool(dict(traffic, pool=1),
                                          m["input_size"], SEED, "cpu")[0])
    return prog, ref, batch


def close(got, want, tol=1e-4):
    assert got.shape == want.shape
    if want.dtype == torch.bool:
        assert torch.equal(got, want)
        return
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol * scale


def test_sampling_matches_the_gathers():
    """grid_sample on the level volumes against the program's gathers, with
    locations inside, on the edges and outside every level."""
    from stereoscene_torch.ops.msdeform_attn import msdeform_attn_3d

    gen = torch.Generator().manual_seed(3)
    shapes = [(4, 3, 2), (2, 2, 1)]
    b, heads, points, c = 2, 2, 3, 8
    v = sum(x * y * z for x, y, z in shapes)
    value = torch.randn(b, v, c, generator=gen)
    loc = torch.rand(b, 5, heads, len(shapes), points, 3,
                     generator=gen) * 1.4 - 0.2
    attn = torch.rand(b, 5, heads, len(shapes), points, generator=gen)
    layer = reference.DeformableLayer(c, heads, len(shapes), points)
    close(layer.sample(value, shapes, loc, attn),
          msdeform_attn_3d(value, shapes, loc, attn, heads), 1e-5)


def test_offsets_and_weights_are_seeded(pair):
    prog, _, _ = pair
    enc = prog.pts_bbox_head.pixel_decoder.encoder0
    for layer in (enc.sampling_offsets, enc.attention_weights):
        assert float(layer.weight.detach().abs().max()) > 0.05


def test_outputs_semantics_and_classes_match(pair, tiny):
    from stereoscene_torch.models.mask2former_occ import semantic_inference

    prog, ref, batch = pair
    got = {}  # what the serving hooks keep
    hooks = [prog.get_submodule(path).register_forward_hook(
        lambda _m, _i, out, key=key, keep=keep: got.update({key: keep(out)}))
        for key, (path, keep) in family.SERVE_OUTPUTS.items()]
    with torch.no_grad():
        prog(batch)
        want = ref(batch)
    for h in hooks:
        h.remove()
    for key in family.SERVE_OUTPUTS:  # memory2: the FPN's, not a memory
        if key in want:
            close(got[key], want[key])
    close(semantic_inference(got["cls_logits"], got["mask_logits"]),
          reference.semantic(want["cls_logits"], want["mask_logits"])
          .movedim(1, -1))
    label_shape = tuple(tiny["label_shape"])
    classes = prog.infer(batch)
    scores = reference.scores(want, label_shape)
    assert torch.equal(classes, scores.argmax(1))
    gaps = family.serve_frame(got, want, classes, label_shape)
    assert all(gaps[k] <= LIMITS[k] for k in LIMITS), gaps


def test_decoder_given_its_own_masks_is_the_free_run(pair):
    """``Head.decode`` given the masks a run gave its layers repeats the
    run; given other masks it parts from it."""
    _, ref, batch = pair
    head = ref.pts_bbox_head
    with torch.no_grad():
        want = ref(batch)
        args = (want["mask_features"].movedim(-1, 1),
                [want[f"memory{i}"].movedim(-1, 1)
                 for i in range(head.levels)])
        same = head.decode(*args, want["attn_masks"])
        other = head.decode(*args, ~want["attn_masks"])
    for key in ("cls_logits", "mask_logits", "attn_masks", "own_masks"):
        close(same[key], want[key], 1e-6)
    assert not torch.equal(other["mask_logits"], want["mask_logits"])


@pytest.mark.parametrize("fault", [None, "mask", "skip_last"])
def test_serving_comparison_catches_the_faults(tiny, monkeypatch, fault):
    """``m2f_faults.break_head``'s faults, the classes restored after."""
    from stereoscene_torch.models import mask2former_occ as head

    base = load(ROOT, "m2f-serve-stream")
    assert set(base.limits) <= set(family.SERVE_NUMBERS)
    traffic = dict(base.traffic, pool=1, warmup_frames=1, check_frames=1)
    cell = Cell("m2f", 1, tiny, traffic, base.end_to_end, [], LIMITS)
    if fault is not None:
        for cls, name in ((head.Mask2FormerOccHead, "__init__"),
                          (head.MaskedCrossAttention, "forward")):
            monkeypatch.setattr(cls, name, getattr(cls, name))
        m2f_faults.break_head(fault)
    out = serve.run(cell, SEED, 0.3, False, "cpu", time.time())
    assert out.correct == (fault is None), out.checks
    if fault is not None:  # far above float32's rounding (1e-6)
        assert out.checks["mask_gap"]["value"] > 1e-3
