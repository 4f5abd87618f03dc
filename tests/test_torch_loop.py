"""The port's training loop: ports of tests/test_engine.py's
``test_preemption_checkpoint_and_midepoch_resume``,
``test_transfer_weight_hook`` and ``test_tensorboard_writer_roundtrip``.

A run cut by SIGTERM and then resumed must end bitwise equal to an
uninterrupted one: the resumed run restores the weights, the AdamW moments
and a pending ``grad_sum``, realigns the loader's epoch and cursor, and
draws each step's dropout from ``step_generator(seed, step)``.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from stereoscene_tpu.utils import tb_writer as jtb
from stereoscene_torch import data
from stereoscene_torch.engine import train as ttrain
from stereoscene_torch.engine.checkpoint import CheckpointManager
from stereoscene_torch.engine.loop import TransferWeightHook, run_training
from stereoscene_torch.utils import tb_writer

N_BATCHES = 10


def _sample(i):
    rng = np.random.RandomState(i)
    return {"x": rng.randn(3).astype(np.float32), "tag": np.int32(i)}


def _loader():
    """Ten one-sample batches, shuffled anew each epoch."""
    return data.BatchLoader(list(range(N_BATCHES)), _sample, batch_size=1,
                            shuffle=True, seed=3, num_workers=1)


def _state():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 1))
    return ttrain.create_train_state(model, lr=1e-2, device="cpu",
                                     accumulate_steps=2)


def _train_step(state, batch, generator):
    """A squared error under a dropout mask drawn from ``generator``."""
    model = state.model
    model.train()
    keep = torch.rand(batch["x"].shape, generator=generator) < 0.5
    loss = ((model(batch["x"] * keep) - 1.0) ** 2).mean()
    grads = torch.autograd.grad(loss, [p for _, p in state.trainable])
    ttrain.apply_gradients(state, list(grads))
    return state, {"loss_total": loss.detach(), "tag": batch["tag"][0]}


def _eval(state):
    with torch.no_grad():
        out = state.model(torch.ones(1, 3))
    return {"semkitti_combined_IoU": float(out.abs().sum()),
            "eval_frames": 1}


def _run(work_dir, hooks):
    return run_training(None, _state(), _train_step, _loader(),
                        eval_fn=_eval, max_epochs=2, eval_interval=1,
                        work_dir=work_dir, log_interval=1,
                        save_interval_steps=2, hooks=hooks, seed=5)


@pytest.mark.parametrize("cut", [5, 13], ids=["epoch0", "epoch1"])
def test_preemption_and_resume_match_an_uninterrupted_run(tmp_path, cut):
    full_tags = []
    full = _run(str(tmp_path / "full"),
                [lambda s, e, i, logs: full_tags.append(int(logs["tag"]))])
    assert full.step == 2 * N_BATCHES and full.updates == N_BATCHES
    assert sorted(full_tags[:N_BATCHES]) == list(range(N_BATCHES))
    assert full_tags[:N_BATCHES] != full_tags[N_BATCHES:]  # reshuffled

    wd = str(tmp_path / "cut")
    seen = []

    def record(state, epoch, it, logs):
        seen.append(int(logs["tag"]))
        if len(seen) == cut:  # preempt mid-epoch
            signal.raise_signal(signal.SIGTERM)

    state = _run(wd, [record])
    assert state.step == cut
    assert seen == full_tags[:cut]
    assert state.grad_sum is not None  # an odd step: accumulation pending
    ckpts = CheckpointManager(os.path.join(wd, "ckpts"))
    assert ckpts.latest_step == cut

    resumed = []
    state = _run(wd, [lambda s, e, i, logs: resumed.append(int(logs["tag"]))])
    assert resumed == full_tags[cut:]
    assert state.step == full.step and state.updates == full.updates
    for (name, p), (_, q) in zip(state.trainable, full.trainable):
        assert torch.equal(p, q), name
    got, want = state.optimizer.state_dict(), full.optimizer.state_dict()
    for i, moments in want["state"].items():
        for k, v in moments.items():
            assert torch.equal(got["state"][i][k], v), (i, k)

    records = [json.loads(line) for line in
               open(os.path.join(wd, "train_log.jsonl"))]
    assert any(r.get("preempted_at_step") == cut for r in records)
    # every step is logged but the cut one, which saves and returns first
    assert sum("loss_total" in r for r in records) == 2 * N_BATCHES - 1
    assert [r["eval"]["eval_frames"] for r in records if "eval" in r] == [
        1] * 2
    assert os.listdir(os.path.join(wd, "tf_logs"))


def test_transfer_weight_hook():
    class S:
        def __init__(self, w):
            self.model = torch.nn.Linear(1, 1, bias=False)
            with torch.no_grad():
                self.model.weight.fill_(w)

    h = TransferWeightHook(every_n_iters=2)
    s1 = S(1.0)
    h(s1, 0, 0, {})
    assert float(h.eval_state_dict["weight"]) == 1.0
    h(S(2.0), 0, 1, {})  # skipped (it=1 not multiple of 2)
    assert float(h.eval_state_dict["weight"]) == 1.0
    with torch.no_grad():  # a copy: training on does not reach it
        s1.model.weight.fill_(5.0)
    assert float(h.eval_state_dict["weight"]) == 1.0
    h(S(3.0), 0, 2, {})
    assert float(h.eval_state_dict["weight"]) == 3.0


def test_tensorboard_writer_bytes_match_jax(tmp_path, monkeypatch):
    """Same scalars and wall time -> the same event file as the JAX
    package's writer."""
    assert tb_writer.crc32c(b"") == 0
    assert tb_writer.crc32c(b"123456789") == 0xE3069283
    monkeypatch.setattr(jtb.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(tb_writer.time, "time", lambda: 1700000000.25)
    paths = []
    for module, sub in ((jtb, "jax"), (tb_writer, "torch")):
        with module.TensorBoardWriter(str(tmp_path / sub)) as w:
            w.add_scalar("train/loss", 1.5, step=10)
            w.add_scalars({"train/a": 2.0, "val/b": -0.25}, step=20)
            paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and len(got) > 100
