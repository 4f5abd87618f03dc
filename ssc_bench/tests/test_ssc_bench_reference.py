"""The plain reference against the program at test widths on the CPU, in
float32: the eval forward, and three training steps from the same weights,
batches and dropout draws."""

import json
import os

import pytest
import torch

from ssc_bench import check, generate, harness
from ssc_bench.families import stereoscene
from ssc_bench.reference import model as reference
from ssc_bench.reference.train import train_steps

from .conftest import HERE


@pytest.fixture
def tiny():
    torch.set_num_threads(2)
    with open(os.path.join(HERE, "tiny.json")) as f:
        return json.load(f)


def frames(config, seed):
    with open(os.path.join(HERE, "..", "traffic", "camera_stream.json")) as f:
        traffic = dict(json.load(f), pool=2)
    m = config["model"]
    geo = generate.geometry_batch(traffic, m["input_size"], 1, 0, "cpu")
    return [dict(geo, imgs=imgs) for imgs in
            generate.frame_pool(traffic, m["input_size"], seed, "cpu")]


def test_eval_forward_matches_the_program(tiny):
    m = tiny["model"]
    state = harness.seeded_weights(tiny, 11, "cpu")
    program = harness.build_program(tiny, "cpu")
    harness.load_weights(program, state)
    ref = reference.build(m, "cpu")
    harness.load_weights(ref, state)
    for batch in frames(tiny, 11):
        with torch.no_grad():
            got = program(batch)
            want = ref(batch)
            classes = program.infer(batch)
        gaps = stereoscene.serve_frame(
            {"logits": got["output_voxels"].permute(0, 4, 1, 2, 3),
             "depth_prob": got["depth_prob"]}, want, classes,
            tiny["label_shape"])
        assert gaps["logit_gap"] < 1e-5 and gaps["depth_gap"] < 1e-6
        assert gaps["class_gap"] < 1e-5


def test_training_steps_match_the_program(tiny):
    from stereoscene_torch.engine.train import (create_train_state,
                                                make_train_step)

    m = tiny["model"]
    with open(os.path.join(HERE, "..", "traffic", "train_b2.json")) as f:
        traffic = dict(json.load(f), batches=3)
    batches = generate.train_batches(traffic, m["input_size"],
                                     tiny["label_shape"], m["dbound"], 5,
                                     "cpu")
    state_dict = harness.seeded_weights(tiny, 5, "cpu")
    program = harness.build_program(tiny, "cpu")
    harness.load_weights(program, state_dict)
    state = create_train_state(program, device="cpu")
    step = make_train_step(stereoscene.loss_config(tiny))
    losses = []
    for s, batch in enumerate(batches):
        losses.append(float(step(state, batch, generate.step_generator(
            5, s, "cpu"))[1]["loss_total"]))
        if s == 0:
            first = {n: float(state.optimizer.state[p]["exp_avg"].norm()
                              / 0.1) for n, p in state.trainable}
    ref = reference.build(m, "cpu")
    harness.load_weights(ref, state_dict)
    grads = {}
    logs = train_steps(ref, batches, [generate.step_generator(5, s, "cpu")
                                      for s in range(3)],
                       lambda out, batch: stereoscene.reference_losses(
                           out, batch, tiny), tiny["optimizer"],
                       lambda names, gs: grads.update(
                           (n, float(g.norm())) for n, g in zip(names, gs)))
    # the first two steps agree to float32 rounding; Adam's first updates
    # of gradient entries near zero then part the third a little
    assert losses[:2] == pytest.approx([x["loss_total"] for x in logs][:2],
                                       rel=1e-6)
    assert losses[2] == pytest.approx(logs[2]["loss_total"], rel=1e-3)
    assert check.leaf_gap(first, grads) < 1e-4


def test_voxel_terms_in_blocks_match_the_whole(monkeypatch):
    """Labels above ``BLOCK_VOXELS`` are summed block by block, each block
    recomputed in the backward: the same terms and the same gradient to
    float32 rounding; at or below it, the whole grid in one piece."""
    from ssc_bench.reference import losses

    gen = torch.Generator().manual_seed(5)
    up = torch.randn(2, 20, 8, 6, 4, generator=gen, requires_grad=True)
    gt = torch.multinomial(torch.ones(20), 2 * 8 * 6 * 4, replacement=True,
                           generator=gen).reshape(2, 8, 6, 4)
    gt[:, :, 0] = 255
    runs = []
    for block in (gt.numel(), 40):
        monkeypatch.setattr(losses, "BLOCK_VOXELS", block)
        terms = losses.voxel_terms(up, gt)
        runs.append([t.detach() for t in terms]
                    + list(torch.autograd.grad(sum(terms), [up])))
    for whole, blocked in zip(*runs):
        torch.testing.assert_close(blocked, whole, rtol=1e-5, atol=1e-7)
    assert losses.voxel_terms(up, gt)[0].grad_fn is not None
