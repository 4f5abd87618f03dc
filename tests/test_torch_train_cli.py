"""The port's train CLI at TINY on the CPU, and its eval CLI on what it
saved.

The tree: sequence 00 (train) with LiDAR scans and lidarseg labels
(tests/test_torch_lidar.py), sequence 08 (val), voxel labels for both
(tests/test_torch_data.py). ``stereoscene_torch.tools.train.main`` trains
``stereoscene_tiny.py`` for one epoch with an eval at its end; the log, the
losses and ``ckpts/`` are checked, then ``tools.test.main`` scores
``ckpts/`` and must give the loop's eval metrics.

The first logged loss terms are held against the JAX package's train step
loss (its training forward and ``compute_losses``, which ``make_train_step``
differentiates) on the JAX loader's first batch, with the port's initial
weights carried across by ``utils.weights.flax_trees`` (rtol 2e-3, as in
tests/test_torch_train.py). Both sides take the ASPP dropout mask from
numpy (tests/test_torch_train.py ``_aspp_mask_patch``); both pipelines'
native scatter is off, so both batches come from the same numpy code.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereoscene_torch.native
import stereoscene_tpu.native
from stereoscene_tpu import data as jdata
from stereoscene_tpu.config import Config as JConfig
from stereoscene_tpu.engine import train as jtrain
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_torch.config import Config
from stereoscene_torch.engine.checkpoint import CheckpointManager
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.tools import test as test_cli
from stereoscene_torch.tools import train as train_cli
from stereoscene_torch.utils.weights import flax_trees
from tests.test_torch_data import ROOT, write_semkitti_tree
from tests.test_torch_lidar import write_lidar
from tests.test_torch_train import _aspp_mask_patch

TINY_CFG = os.path.join(ROOT, "stereoscene_torch", "configs",
                        "stereoscene_tiny.py")
JAX_TINY_CFG = os.path.join(ROOT, "stereoscene_tpu", "configs",
                            "stereoscene_tiny.py")
TRAIN_FRAMES = ("000000", "000001")
VAL_FRAMES = ("000000", "000005")
TERMS = ("loss_voxel_ce_0", "loss_voxel_sem_scal_0", "loss_voxel_geo_scal_0",
         "loss_depth", "loss_total")
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    _, ann = write_semkitti_tree(root, frame_ids=TRAIN_FRAMES, seq="00",
                                 seed=1)
    write_semkitti_tree(root, frame_ids=VAL_FRAMES, seq="08", seed=2)
    lidar_root = write_lidar(root, "00", TRAIN_FRAMES, n_points=6000)
    opts = [f"data.{split}.{key}={value}" for split in ("train", "val")
            for key, value in (("data_root", root), ("ann_file", ann))]
    opts += [f"lidar_root={lidar_root}", f"lidarseg_root={lidar_root}"]
    return root, ann, lidar_root, opts


def _aspp_mask():
    cfg = DetectorConfig.from_config(Config.fromfile(TINY_CFG))
    shape = (1, sum(cfg.neck_out_channels)) + cfg.feature_size
    return np.random.RandomState(3).rand(*shape) < 0.5


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """One epoch of the train CLI, its log records and the eval CLI's
    metrics on its ckpts directory."""
    *_, opts = tree
    work_dir = str(tmp_path_factory.mktemp("work"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stereoscene_tpu.native, "available", lambda: False)
        mp.setattr(stereoscene_torch.native, "available", lambda: False)
        _aspp_mask_patch(mp, _aspp_mask())
        state = train_cli.main([
            TINY_CFG, "--work-dir", work_dir, "--device", "cpu",
            "--max-epochs", "1", "--seed", str(SEED), "--cfg-options",
            *opts, "evaluation.interval=1"])
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    ckpts = os.path.join(work_dir, "ckpts")
    val_opts = [o for o in opts if o.startswith("data.val.")]
    results = test_cli.main([TINY_CFG, "--device", "cpu", "--checkpoint",
                             ckpts, "--cfg-options", *val_opts])
    return state, records, ckpts, results


def test_train_cli_logs_losses_and_keeps_checkpoints(trained):
    state, records, ckpts, _ = trained
    steps = [r for r in records if "loss_total" in r]
    assert len(steps) == 1 and steps[0]["iter"] == 0  # log interval 50
    for key in TERMS:
        assert math.isfinite(steps[0][key]), key
    assert steps[0]["loss_depth"] > 0
    evals = [r["eval"] for r in records if "eval" in r]
    assert len(evals) == 1 and evals[0]["eval_frames"] == len(VAL_FRAMES)
    assert state.step == len(TRAIN_FRAMES) and state.updates == 2
    assert next(state.model.parameters()).device.type == "cpu"
    mgr = CheckpointManager(ckpts)
    assert mgr.latest_step == mgr.best_step == state.step
    assert sorted(os.listdir(ckpts)) == [f"{state.step}.pth"]
    ckpt = torch.load(mgr.path(state.step), weights_only=True)
    assert ckpt["meta"]["metrics"]["semkitti_combined_IoU"] == \
        evals[0]["semkitti_combined_IoU"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(ckpt["state_dict"][k], v), k


def test_eval_cli_on_ckpts_gives_the_loops_metrics(trained):
    _, records, _, results = trained
    loop = [r["eval"] for r in records if "eval" in r][-1]
    keys = [k for k in loop if k.startswith("semkitti_")]
    assert len(keys) > 20
    for k in keys:
        if math.isnan(loop[k]):
            assert math.isnan(results[k]), k
        else:
            assert results[k] == loop[k], k


def test_first_loss_matches_the_jax_train_step(tree, trained):
    root, ann, lidar_root, _ = tree
    _, records, _, _ = trained
    jcfg = JConfig.fromfile(JAX_TINY_CFG)
    det = JaxConfig.from_config(jcfg)
    dcfg = jcfg["data_config"]
    pipe = jdata.PipelineConfig(
        input_size=tuple(dcfg["input_size"]), resize=tuple(dcfg["resize"]),
        rot=tuple(dcfg["rot"]), flip=dcfg["flip"],
        crop_h=tuple(dcfg["crop_h"]), is_train=True, load_lidar_depth=True,
        point_cloud_range=tuple(jcfg["point_cloud_range"]))
    index = jdata.SemanticKittiIndex(data_root=root, ann_file=ann,
                                     split="train", lidar_root=lidar_root,
                                     lidarseg_root=lidar_root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stereoscene_tpu.native, "available", lambda: False)
        loader = jdata.BatchLoader(
            index.frames, jdata.SemanticKittiPipeline(pipe, seed=SEED),
            batch_size=1, shuffle=True, seed=SEED, num_workers=1)
        batch = {k: jnp.asarray(v) for k, v in next(iter(loader)).items()}
    # the CLI's initial weights: the same seed before the same build
    torch.manual_seed(SEED)
    model = BEVDepthOccupancy(DetectorConfig.from_config(
        Config.fromfile(TINY_CFG)), device="cpu",
        label_shape=tuple(jcfg["occ_size"]))
    params, stats = flax_trees(model)
    jm = JaxModel(cfg=det)
    loss_cfg = jtrain.LossConfig(downsample=det.downsample, dbound=det.dbound)

    def losses(p, s, b):
        """The loss function of the JAX train step (``make_train_step``):
        the training forward, then ``compute_losses``."""
        out, _ = jm.apply({"params": p, "batch_stats": s}, b, train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        terms = jtrain.compute_losses(out, b, loss_cfg)
        return dict(terms, loss_total=sum(terms.values()))

    with pytest.MonkeyPatch.context() as mp:
        _aspp_mask_patch(mp, _aspp_mask())
        logs = jax.jit(losses)(params, stats, batch)
    first = next(r for r in records if "loss_total" in r)
    for key in TERMS:
        np.testing.assert_allclose(first[key], float(logs[key]), rtol=2e-3,
                                   err_msg=key)
