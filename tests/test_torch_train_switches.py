"""The port's train step with every optional switch and loss term on,
against the JAX package's at TINY; the grid mask in the training forward;
``debug_grads``; the burn-in tool; and the train CLI with the loss keys
and ``model.use_grid_mask`` that the JAX CLI reads.

The train-step comparison runs the model of
tests/test_torch_optional_modules.py (every switch on) in training mode on
one batch with voxel, depth, image-seg, point and relation labels (the
relation matrix from the label producer), every loss term on (the KL depth
loss), and compares each loss term within rtol 2e-3
(tests/test_torch_train.py). Both sides take the ASPP dropout mask and the
grid mask from numpy, the grid mask made by the port's
``grid_mask_from_draws`` (held to the JAX arithmetic in
tests/test_torch_data_branches.py). The gradients are compared submodule
by submodule in tests/test_torch_optional_modules.py, because of the TINY
conditioning note of tests/test_torch_train.py.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereoscene_tpu.data.augment as jaug
from stereoscene_tpu.data import labels as jlabels
from stereoscene_tpu.engine import train as jtrain
from stereoscene_tpu.losses.lovasz import lovasz_softmax as jlovasz
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.ops.resize import resize_trilinear as jresize
from stereoscene_torch.data import augment
from stereoscene_torch.engine import train as ttrain
from stereoscene_torch.models import detector as tdetector
from stereoscene_torch.models.detector import BEVDepthOccupancy
from stereoscene_torch.models.detector import DetectorConfig
from stereoscene_torch.tools import train as train_cli
from stereoscene_torch.tools import train_burnin
from stereoscene_torch.utils.weights import flax_trees, seeded_init_
from tests.test_torch_data import ROOT, write_semkitti_tree
from tests.test_torch_lidar import write_lidar
from tests.test_torch_optional_modules import ALL, _all_batch
from tests.test_torch_train import _aspp_mask_patch

TINY_CFG = os.path.join(ROOT, "stereoscene_torch", "configs",
                        "stereoscene_tiny.py")
LOSS_KW = dict(downsample=ALL.downsample, dbound=ALL.dbound, voxel_ohem=1.0,
               voxel_lovasz=1.0, voxel_dice=1.0, voxel_lga=1.0,
               loss_depth_type="kld", loss_seg_weight=1.0,
               loss_crp_weight=1.0, loss_point_ce_weight=1.0,
               loss_point_lovasz_weight=1.0)
NEW_PARAMS = ("img_bev_encoder_backbone.cp_mega_voxels.", "imgseg_",
              "pts_bbox_head.point_occ_mlp.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU at once, and a full torch thread pool in each makes
    the CPU's bf16 and conv kernels crawl (oversubscription)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _labeled_batch(seed):
    """``_all_batch`` with every label: gt_occ at twice the grid, sparse
    gt_depth, img_seg, points_count and the 4-way relation matrix of the
    labels downsampled to stage 2's 4x4x2 grid."""
    rng = np.random.RandomState(seed)
    batch = _all_batch(seed)
    x, y, z = ALL.grid_shape
    h, w = ALL.input_size
    gt = rng.choice([0, 1, 9, 11, 15, 255], (2, 2 * x, 2 * y, 2 * z),
                    p=[0.5, 0.1, 0.1, 0.1, 0.1, 0.1])
    batch["gt_occ"] = gt.astype(np.int32)
    batch["gt_depth"] = ((rng.rand(2, 2, h, w) < 0.1)
                         * rng.uniform(2.1, 9.4, (2, 2, h, w))).astype(
                             np.float32)
    batch["img_seg"] = rng.randint(0, 20, (2, 2, h, w)).astype(np.float32)
    batch["points_count"] = np.array([70, 96], np.int32)
    ds = (2 * x // 4, 2 * y // 4, 2 * z // 2)
    batch["cp_mega_matrix"] = np.stack([
        jlabels.compute_cp_mega_matrix(jlabels.downsample_label_monoscene(
            g.astype(np.uint8), ds)) for g in gt])
    return batch


def _grid_mask():
    """A fixed keep mask [2B, H, W] (left eyes, then right), two of the
    four images masked."""
    h, w = ALL.input_size
    draws = (torch.tensor([True, False, True, False]),
             torch.tensor([20, 30, 17, 25]), torch.tensor([3, 0, 11, 7]),
             torch.tensor([5, 9, 0, 1]))
    return augment.grid_mask_from_draws(h, w, *draws, ratio=0.5).numpy()


@pytest.fixture(scope="module")
def stepped():
    rng = np.random.RandomState(11)
    batch = _labeled_batch(12)
    aspp = rng.rand(2, sum(ALL.neck_out_channels),
                    *ALL.feature_size) < 0.5
    mask = _grid_mask()
    model = BEVDepthOccupancy(DetectorConfig(**ALL.__dict__), device="cpu")
    seeded_init_(model, 7)
    params, stats = flax_trees(model)
    jm = JaxModel(cfg=ALL)

    def jax_forward(p, s, b):
        out, _ = jm.apply({"params": p, "batch_stats": s}, b, train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        # the JAX compute_losses cannot give the voxel Lovasz term (see
        # tests/test_torch_pooled_terms.py); it is computed as it would be
        losses = jtrain.compute_losses(
            out, b, jtrain.LossConfig(**dict(LOSS_KW, voxel_lovasz=0.0)))
        logits = jresize(out["output_voxels"][0].astype(jnp.float32),
                         b["gt_occ"].shape[1:4])
        losses["loss_voxel_lovasz_0"] = jlovasz(
            jax.nn.softmax(logits, axis=-1), b["gt_occ"], ignore=255)
        return losses

    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _aspp_mask_patch(mp, aspp)
        mp.setattr(jaug, "grid_mask",
                   lambda flat, key: flat * jnp.asarray(mask)[..., None])
        mp.setattr(tdetector, "grid_mask", lambda flat, gen, groups=1:
                   flat * torch.from_numpy(mask)[:, None])
        want = jax.jit(jax_forward)(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
        record = ttrain.apply_gradients
        mp.setattr(ttrain, "apply_gradients", lambda state, grads: (
            seen.append([g.clone() for g in grads]), record(state, grads)))
        state = ttrain.create_train_state(model, device="cpu")
        _, logs = ttrain.make_train_step(
            ttrain.LossConfig(**LOSS_KW), debug_grads=True)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()},
                torch.Generator().manual_seed(0))
    return ({k: float(v) for k, v in want.items()},
            {k: float(v) for k, v in logs.items()},
            dict(zip([n for n, _ in state.trainable], seen[0])))


def test_every_loss_term_matches_jax(stepped):
    want, logs, _ = stepped
    assert set(logs) == set(want) | {"loss_total", "grad_norm",
                                     "grad_nonfinite"}
    assert len(want) == 12
    for key, value in want.items():
        assert math.isfinite(value) and value != 0, key
        np.testing.assert_allclose(logs[key], value, rtol=2e-3, err_msg=key)
    np.testing.assert_allclose(logs["loss_total"], sum(want.values()),
                               rtol=2e-3)


def test_debug_grads_and_new_parameters_get_gradients(stepped):
    _, logs, grads = stepped
    want = math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))
    np.testing.assert_allclose(logs["grad_norm"], want, rtol=1e-5)
    assert logs["grad_nonfinite"] == 0.0
    for prefix in NEW_PARAMS:
        leaves = [g for n, g in grads.items() if n.startswith(prefix)]
        assert leaves and all(float(g.abs().sum()) > 0 for g in leaves), \
            prefix


def test_grad_diagnostics_count_nonfinite_entries():
    grads = [torch.tensor([3.0, 4.0]), torch.tensor([[0.0, float("nan")],
                                                     [float("inf"), 1.0]])]
    out = ttrain.grad_diagnostics(grads)
    assert float(out["grad_nonfinite"]) == 2.0
    assert not math.isfinite(float(out["grad_norm"]))
    out = ttrain.grad_diagnostics([grads[0], torch.ones(2, 2)])
    assert float(out["grad_nonfinite"]) == 0.0
    np.testing.assert_allclose(float(out["grad_norm"]), math.sqrt(29.0))


def test_grid_mask_acts_in_training_only():
    """The backbone sees the images grid-masked by the step generator's
    first draws in training mode, and unmasked in eval mode."""
    model = BEVDepthOccupancy(DetectorConfig(**ALL.__dict__), device="cpu")
    seen = []
    model.img_backbone.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    imgs = torch.randn(2, 2, *ALL.input_size, 3,
                       generator=torch.Generator().manual_seed(0))
    flat = imgs.transpose(0, 1).reshape(4, *imgs.shape[2:]).permute(
        0, 3, 1, 2)
    model.train()
    model.encode_images(imgs, torch.Generator().manual_seed(5))
    model.eval()
    with torch.no_grad():
        model.encode_images(imgs)
    draws = augment.grid_mask_draws(4, torch.Generator().manual_seed(5),
                                    "cpu", groups=2)
    mask = augment.grid_mask_from_draws(*ALL.input_size, *draws)
    torch.testing.assert_close(seen[0], flat * mask[:, None], rtol=0,
                               atol=0)
    assert not torch.equal(seen[0], flat)
    torch.testing.assert_close(seen[1], flat, rtol=0, atol=0)


def test_burnin_tool_passes_its_checks_at_tiny():
    summary = train_burnin.main(["--config", TINY_CFG, "--device", "cpu",
                                 "--steps", "14", "--lr", "1e-3"])
    assert summary["ok"], summary["checks"]
    assert len(summary["loss_trace"]) == 14
    assert summary["nonfinite_grad_steps"] == 0
    assert all(math.isfinite(v) for v in summary["grad_norm_trace"])


def test_burnin_checks_fail_on_a_flat_or_broken_run():
    flat = [10.0] * 20
    checks = train_burnin.check(flat, [1.0] * 20, [0] * 20)
    assert not checks["trend_down"] and not checks["optimizes"]
    falling = list(np.linspace(10.0, 6.0, 20))
    assert all(train_burnin.check(falling, [1.0] * 20, [0] * 20).values())
    broken = train_burnin.check(falling[:-1] + [float("nan")],
                                [1.0] * 19 + [float("nan")], [0] * 19 + [3])
    assert not broken["all_loss_finite"] and not broken["all_grad_finite"]


def test_train_cli_reads_the_optional_loss_keys_and_grid_mask(tmp_path):
    root = str(tmp_path / "tree")
    frames = ("000000", "000001")
    _, ann = write_semkitti_tree(root, frame_ids=frames, seq="00", seed=3)
    lidar = write_lidar(root, "00", frames, n_points=4000)
    work = str(tmp_path / "work")
    seen = []
    loss_w = "model.pts_bbox_head.semkitti_loss_weight_cfg"
    train_cli.main([
        TINY_CFG, "--work-dir", work, "--device", "cpu", "--max-epochs", "1",
        "--cfg-options", f"data.train.data_root={root}",
        f"data.train.ann_file={ann}", f"lidar_root={lidar}",
        f"lidarseg_root={lidar}", "model.use_grid_mask=True",
        f"{loss_w}.voxel_ohem=0.5", f"{loss_w}.voxel_lovasz=0.5"],
        hooks=[lambda state, epoch, it, logs: seen.append(
            (state.model.cfg.use_grid_mask, dict(logs)))])
    assert len(seen) == 2
    for grid_mask, logs in seen:
        assert grid_mask
        for key in ("loss_voxel_ohem_0", "loss_voxel_lovasz_0"):
            assert math.isfinite(float(logs[key])) and float(logs[key]) > 0
    with open(os.path.join(work, "train_log.jsonl")) as f:
        first = json.loads(f.readline())
    assert "loss_voxel_ohem_0" in first and "loss_voxel_lovasz_0" in first
