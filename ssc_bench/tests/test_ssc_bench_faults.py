"""A run at test widths on the CPU, past the harness's look for a card,
with its timed path sound and then broken underneath: ``correct`` has to
come out true, then false for each fault a cell can have."""

import time

import pytest

from ssc_bench import calibrate, serve, training


def test_sound_serving_run_is_correct(tiny_cell):
    cell = tiny_cell("kitti-serve-stream", pool=4, warmup_frames=1,
                     check_frames=2)
    out = serve.run(cell, 2 ** 31 + 12345, 1.0, False, "cpu", time.time())
    assert out.correct, out.checks
    assert out.attempted >= 4
    assert set(out.metrics) == {"frames_per_s", "frame_ms_p95",
                                "setup_s"}


def test_altered_answer_is_caught(tiny_cell):
    cell = tiny_cell("kitti-serve-stream", pool=4, warmup_frames=1,
                     check_frames=2)
    out = serve.run(cell, 77, 1.0, False, "cpu", time.time(),
                    break_answer=lambda c: (c + 1) % 20)
    assert not out.correct
    assert out.checks["class_gap"]["value"] > out.checks["class_gap"]["limit"]


def unchanged_state(step):
    """A step that returns its state unchanged."""
    def broken(state, batch, generator=None):
        saved = [p.detach().clone() for _, p in state.trainable]
        state, logs = step(state, batch, generator)
        for (_, p), s in zip(state.trainable, saved):
            p.data.copy_(s)
        return state, logs
    return broken


@pytest.mark.parametrize("fault", [None, unchanged_state,
                                   *calibrate.TRAIN_FAULTS.values()],
                         ids=["sound", "unchanged_state",
                              *calibrate.TRAIN_FAULTS])
def test_training_faults_are_caught(tiny_cell, fault):
    cell = tiny_cell("kitti-train-b2", batches=4)
    out = training.run(cell, 3, 0.5, False, "cpu", time.time(),
                       break_step=fault)
    assert out.correct == (fault is None), out.checks
    assert set(out.metrics) == {"train_frames_per_s", "train_peak_gib",
                                "setup_s"}


@pytest.mark.parametrize("fault", [None, unchanged_state],
                         ids=["sound", "unchanged_state"])
def test_training_faults_at_batch_one_are_caught(tiny_cell, fault):
    """At B = 1 no half of a batch exists: a state left unchanged is the
    step's fault here, and the dropped slab the loss's (below)."""
    cell = tiny_cell("highres-train-b1", batches=3)
    out = training.run(cell, 13, 0.5, False, "cpu", time.time(),
                       break_step=fault)
    assert out.correct == (fault is None), out.checks


@pytest.mark.parametrize("fault", [None, "loss_slab"])
def test_stages_of_the_first_step_are_judged_alone(tiny_cell, fault):
    """The voxel side on the program's own input and the loss on the
    program's own outputs: float32 rounding when sound; a loss that leaves
    out a sixteenth of the grid reads far above it, while the voxel side,
    which the loss does not reach in the first forward, reads the same."""
    cell = tiny_cell("highres-train-b1", batches=4)
    cell.limits = {"bev_gap": 1e-5, "loss_outputs_gap": 1e-5}
    out = training.run(cell, 7, 0.5, False, "cpu", time.time(),
                       break_step=fault and calibrate.TRAIN_FAULTS[fault])
    assert out.checks["bev_gap"]["value"] <= 1e-5, out.checks
    assert out.correct == (fault is None), out.checks
    if fault:
        assert out.checks["loss_outputs_gap"]["value"] > 1e-3, out.checks


def test_loss_over_half_the_batch_is_caught(tiny_cell):
    """The forward over the whole batch keeps every shape and the first
    stage's features; the first gradient tells the loss over half of it."""
    cell = tiny_cell("kitti-train-b2", batches=4)
    out = training.run(cell, 5, 0.5, False, "cpu", time.time(),
                       break_step=calibrate.TRAIN_FAULTS["half_batch_loss"])
    grad = out.checks["grad_median"]
    assert grad["value"] > grad["limit"], out.checks
    assert out.checks["stage2_gap"]["value"] <= \
        out.checks["stage2_gap"]["limit"]
