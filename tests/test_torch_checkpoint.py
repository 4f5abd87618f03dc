"""The port's ``CheckpointManager`` against the JAX package's orbax one.

A round trip restores a TINY detector's train state bitwise: parameters,
BatchNorm statistics, AdamW moments, ``step``, ``updates`` and, while
gradients accumulate, ``grad_sum``. The same sequence of saves, with and
without metrics, leaves the same steps and the same ``best_step`` under both
managers, also after a new manager reopens the directory.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.engine.checkpoint import CheckpointManager as JaxManager
from stereoscene_torch.engine import train as ttrain
from stereoscene_torch.engine.checkpoint import CheckpointManager
from stereoscene_torch.tools.test import load_checkpoint
from tests.test_torch_modules import port_model

KEY = "semkitti_combined_IoU"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grads(state, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) for _, p in state.trainable]


def _stepped_state(seed, steps, accumulate_steps=2):
    state = ttrain.create_train_state(port_model(seed=seed), device="cpu",
                                      accumulate_steps=accumulate_steps)
    for i in range(steps):
        ttrain.apply_gradients(state, _grads(state, 100 * seed + i))
    return state


def _assert_same_state(a, b):
    assert (a.step, a.updates) == (b.step, b.updates)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert (a.grad_sum is None) == (b.grad_sum is None)
    for x, y in zip(a.grad_sum or (), b.grad_sum or ()):
        assert torch.equal(x, y)


def test_round_trip_restores_the_train_state_bitwise(tmp_path):
    # three steps of accumulate 2: one update, and a grad_sum pending
    state = _stepped_state(seed=1, steps=3)
    assert (state.step, state.updates) == (3, 1)
    assert state.grad_sum is not None
    assert state.optimizer.state_dict()["state"]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state.step, state, epoch=0)
    assert os.listdir(tmp_path) == ["3.pth"]

    fresh = _stepped_state(seed=2, steps=0)
    fresh, step = CheckpointManager(str(tmp_path)).restore(fresh)
    assert step == 3
    _assert_same_state(state, fresh)
    # the next step (the accumulated update, at the schedule's LR) agrees
    for s in (state, fresh):
        ttrain.apply_gradients(s, _grads(s, 7))
    assert state.updates == 2 and state.grad_sum is None
    _assert_same_state(state, fresh)

    ckpt = torch.load(mgr.path(3), weights_only=True)
    assert ckpt["meta"] == {"step": 3, "updates": 1, "epoch": 0,
                            "metrics": {}}
    assert set(ckpt) == {"meta", "state_dict", "optimizer", "grad_sum"}
    # the eval CLI's loader reads the file as it is
    model = port_model(seed=9)
    load_checkpoint(model, mgr.path(3))
    for k, v in model.state_dict().items():
        assert torch.equal(v, ckpt["state_dict"][k]), k


def test_restore_without_a_checkpoint_is_a_no_op(tmp_path):
    state = _stepped_state(seed=1, steps=0)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step is None and mgr.best_step is None
    assert mgr.restore(state) == (state, 0)


def test_async_save_then_wait_is_complete(tmp_path):
    """The state is copied on the caller's thread: changing it after
    ``save(wait=False)`` does not reach the file."""
    state = _stepped_state(seed=3, steps=1, accumulate_steps=1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, state, metrics={KEY: 12.5}, wait=False)
    ttrain.apply_gradients(state, _grads(state, 4))
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["1.pth"]
    ckpt = torch.load(mgr.path(1), weights_only=True)
    assert ckpt["meta"]["metrics"] == {KEY: 12.5}
    assert "grad_sum" not in ckpt
    for k, v in want.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    assert CheckpointManager(str(tmp_path)).best_step == 1


# (step, metrics): saves without metrics, with the key, without the key, a
# repeated step and a step below the latest (both skipped), and ties
SAVES = [(2, None), (4, {KEY: 30.0}), (6, None), (6, {KEY: 99.0}),
         (8, None), (10, {KEY: 10.0}), (9, None), (12, None),
         (14, {KEY: 50.0}), (16, {"other": 1.0}), (18, {KEY: 50.0})]


class _JaxState:
    def __init__(self, step):
        self.params = {"w": jnp.full((3,), float(step))}
        self.batch_stats = {}
        self.opt_state = {"m": jnp.zeros((3,))}
        self.step = jnp.int32(step)


def _torch_state(step):
    state = ttrain.create_train_state(torch.nn.Linear(3, 1), device="cpu")
    state.step = step
    return state


@pytest.mark.parametrize("max_to_keep", [2, 3])
def test_surviving_steps_match_orbax(tmp_path, max_to_keep):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmgr = JaxManager(jdir, max_to_keep=max_to_keep)
    tmgr = CheckpointManager(tdir, max_to_keep=max_to_keep)

    def steps(directory):
        return sorted(int(n.split(".")[0]) for n in os.listdir(directory)
                      if not n.startswith("."))

    for i, (step, metrics) in enumerate(SAVES):
        if i == 6:  # a new run reopens both directories
            jmgr = JaxManager(jdir, max_to_keep=max_to_keep)
            tmgr = CheckpointManager(tdir, max_to_keep=max_to_keep)
        jmgr.save(step, _JaxState(step), metrics=metrics)
        tmgr.save(step, _torch_state(step), metrics=metrics)
        want = sorted(jmgr._mgr.all_steps())
        assert steps(tdir) == want, (step, metrics)
        assert (tmgr.latest_step, tmgr.best_step) == (
            jmgr.latest_step, jmgr.best_step), (step, metrics)
    assert tmgr.best_step == 18
