"""The port's evaluation path against the JAX package's, and its CLI.

The model is ``stereoscene_tiny.py``'s, with seeded port weights carried to
the JAX model by ``utils.weights.flax_trees``. Both sides read the same
synthetic SemanticKITTI tree (tests/test_torch_data.py) through their own
index, pipeline and loader; JAX runs ``run_evaluation`` + ``make_eval_step``
(its own dynamic splat), the port its ``run_evaluation`` (static plan,
plain routes on the CPU). At least 99.9% of voxels agree and every
``semkitti_*`` value within 0.05 points.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu import data as jdata
from stereoscene_tpu.config import Config as JConfig
from stereoscene_tpu.engine.eval import make_eval_step as jax_make_eval_step
from stereoscene_tpu.engine.loop import run_evaluation as jax_run_evaluation
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_torch import data
from stereoscene_torch.config import Config
from stereoscene_torch.data.labels import inv_map
from stereoscene_torch.engine.eval import make_eval_step
from stereoscene_torch.engine.loop import run_evaluation, to_device
from stereoscene_torch.metrics import empty_state
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.tools import test as cli
from stereoscene_torch.utils.weights import flax_trees, seeded_init_
from tests.test_torch_data import ROOT, write_semkitti_tree

TINY_CFG = os.path.join(ROOT, "stereoscene_torch", "configs",
                        "stereoscene_tiny.py")
FRAMES = ("000000", "000005", "000010")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root, ann = write_semkitti_tree(str(tmp_path_factory.mktemp("semkitti")),
                                    frame_ids=FRAMES, seed=4)
    cfg = Config.fromfile(TINY_CFG)
    model = BEVDepthOccupancy(DetectorConfig.from_config(cfg), device="cpu",
                              label_shape=tuple(cfg["occ_size"]))
    seeded_init_(model, 7)
    return cfg, model, root, ann


def _pipe_cfg(cfg, pkg):
    return pkg.PipelineConfig(input_size=tuple(cfg["data_config"]["input_size"]),
                              point_cloud_range=tuple(cfg["point_cloud_range"]))


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's predictions and run_evaluation metrics, batch size 1."""
    cfg, model, root, ann = setup
    jcfg = JConfig.fromfile(os.path.join(ROOT, "stereoscene_tpu", "configs",
                                         "stereoscene_tiny.py"))
    jm = JaxModel(cfg=JaxConfig.from_config(jcfg))
    params, stats = flax_trees(model)
    variables = {"params": params, "batch_stats": stats}
    index = jdata.SemanticKittiIndex(data_root=root, ann_file=ann, split="val")
    loader = jdata.BatchLoader(
        index.frames, jdata.SemanticKittiPipeline(_pipe_cfg(cfg, jdata)),
        batch_size=1, drop_last=False, num_workers=2)
    eval_step = jax_make_eval_step(jm, tuple(cfg["occ_size"]))
    results = jax_run_evaluation(jm, variables, eval_step, loader,
                                 progress=False, reduce_processes=False)
    jitted = jax.jit(eval_step)
    from stereoscene_tpu.metrics import empty_state as jempty

    preds = [np.asarray(jitted(variables, {k: jnp.asarray(v)
                                           for k, v in b.items()},
                               jempty())[0]) for b in loader]
    return np.concatenate(preds), results


def _port_loader(setup, batch_size):
    cfg, _, root, ann = setup
    index = data.SemanticKittiIndex(data_root=root, ann_file=ann, split="val")
    return index, data.BatchLoader(
        index.frames, data.SemanticKittiPipeline(_pipe_cfg(cfg, data)),
        batch_size=batch_size, drop_last=False, num_workers=2)


def _port_preds(setup, batch_size=1):
    cfg, model, _, _ = setup
    index, loader = _port_loader(setup, batch_size)
    eval_step = make_eval_step(tuple(cfg["occ_size"]))
    preds = [eval_step(model, to_device(b, "cpu"), empty_state())[0].numpy()
             for b in loader]
    return index, np.concatenate(preds)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_run_evaluation_matches_jax(setup, jax_run, batch_size):
    """Batch size 2 pads the tail batch of the three frames."""
    cfg, model, _, _ = setup
    jpreds, jres = jax_run
    _, preds = _port_preds(setup, batch_size)
    assert preds.shape == jpreds.shape == (3,) + tuple(cfg["occ_size"])
    agree = float((preds == jpreds).mean())
    assert agree >= 0.999, agree
    _, loader = _port_loader(setup, batch_size)
    res = run_evaluation(model, make_eval_step(tuple(cfg["occ_size"])),
                         loader, progress=False)
    assert res["eval_frames"] == jres["eval_frames"] == 3
    assert res["eval_time_s"] > 0
    semkitti = [k for k in jres if k.startswith("semkitti_")]
    assert set(semkitti) == {k for k in res if k.startswith("semkitti_")}
    for k in semkitti:
        if np.isnan(jres[k]):
            assert np.isnan(res[k]), k
        else:
            assert abs(res[k] - jres[k]) <= 0.05, (k, res[k], jres[k])


def test_eval_step_upsamples_to_occ_size_without_labels(setup):
    cfg, model, _, _ = setup
    _, loader = _port_loader(setup, 1)
    batch = next(iter(loader))
    batch.pop("gt_occ")
    state = empty_state()
    pred, out = make_eval_step(tuple(cfg["occ_size"]))(
        model, to_device(batch, "cpu"), state)
    assert pred.shape == (1,) + tuple(cfg["occ_size"])
    assert out is state


def _cli_args(setup, *extra):
    _, _, root, ann = setup
    return [TINY_CFG, "--device", "cpu", "--cfg-options",
            f"data.val.data_root={root}", f"data.val.ann_file={ann}", *extra]


def test_cli_writes_the_predictions(setup, tmp_path):
    _, model, _, _ = setup
    pth = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": model.state_dict(), "meta": {}}, pth)
    sub, npy = str(tmp_path / "sub"), str(tmp_path / "npy")
    assert cli.main(_cli_args(setup, "--checkpoint", pth, "--batch-size",
                              "2", "--submission-dir", sub,
                              "--save-pred-dir", npy)) is None
    index, preds = _port_preds(setup)
    lut = inv_map()
    for frame, pred in zip(index.frames, preds):
        raw = np.fromfile(os.path.join(sub, "sequences", "08", "predictions",
                                       frame.frame_id + ".label"), np.uint16)
        np.testing.assert_array_equal(raw, lut[pred.reshape(-1)])
        saved = np.load(os.path.join(npy, f"08_{frame.frame_id}.npy"))
        assert saved.dtype == np.uint8
        np.testing.assert_array_equal(saved, pred)


def test_cli_scores_the_checkpoint(setup, tmp_path):
    cfg, model, _, _ = setup
    pth = str(tmp_path / "bare.pth")
    torch.save(model.state_dict(), pth)
    res = cli.main(_cli_args(setup, "--checkpoint", pth))
    _, loader = _port_loader(setup, 1)
    want = run_evaluation(model, make_eval_step(tuple(cfg["occ_size"])),
                          loader, progress=False)
    for k in want:
        if k.startswith("semkitti_") and not np.isnan(want[k]):
            assert res[k] == want[k], k


def test_cli_refuses_a_checkpoint_with_missing_keys(setup, tmp_path):
    _, model, _, _ = setup
    sd = model.state_dict()
    sd.pop(next(k for k in sd if "pts_bbox_head" in k))
    pth = str(tmp_path / "partial.pth")
    torch.save({"state_dict": sd}, pth)
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.main(_cli_args(setup, "--checkpoint", pth))
