"""The port's TINY detector end to end against the JAX package's.

The port model gets seeded weights, the JAX model the same weights through
the reference converter; the same numpy batch goes through both. Tolerances
are those of tests/test_full_model_parity.py: depth_prob within 2e-4 and
logits within 2e-3 after normalising by max|ref|.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_tpu.ops.resize import resize_trilinear as jresize
from stereoscene_torch.models.detector import DetectorConfig
from stereoscene_torch.utils.weights import load_flax_params
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import japply, port_model, to_flax

LABEL_SHAPE = (16, 16, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    batch = _tiny_batch(b=2, rng=np.random.RandomState(3))
    model = port_model(seed=7)
    jax_model = JaxModel(cfg=TINY)
    params, stats = to_flax(model, jax_model, batch)
    return model, jax_model, {"params": params, "batch_stats": stats}, batch


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX forward outputs by splat mode, shared between tests."""
    return {}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("jax_splat", ["dynamic", "static_plan"])
def test_forward_matches_jax(pair, jax_outputs, jax_splat):
    """The JAX side splats either with its dynamic ranks or with the port's
    group-8 static plan and bounds (its ``lift_splat_static``)."""
    model, jax_model, variables, batch = pair
    tb = model.attach_plan(_torch_batch(batch))
    jb = dict(batch)
    if jax_splat == "static_plan":
        for key in ("splat_order", "splat_ranks", "splat_bounds"):
            jb[key] = jnp.asarray(tb[key].numpy())
    want = japply(jax_model, variables, jb, train=False)
    jax_outputs[jax_splat] = want
    got = model(tb)
    dp_want = np.asarray(want["depth_prob"])
    assert got["depth_prob"].shape == dp_want.shape
    np.testing.assert_allclose(got["depth_prob"].numpy(), dp_want, atol=2e-4,
                               rtol=0)
    ref = np.asarray(want["output_voxels"][0])
    out = got["output_voxels"].numpy()
    assert out.shape == ref.shape == (2,) + TINY.grid_shape + (20,)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-3, rtol=0)


def test_infer_matches_jax_upsample_argmax(pair, jax_outputs):
    """infer = fp32 logits, trilinear upsample, argmax (bench.py:195-200)."""
    model, jax_model, variables, batch = pair
    model.label_shape = LABEL_SHAPE
    classes = model.infer(_torch_batch(batch))
    assert classes.shape == (2,) + LABEL_SHAPE
    if "dynamic" not in jax_outputs:
        jax_outputs["dynamic"] = japply(jax_model, variables, batch,
                                        train=False)
    logits = jax_outputs["dynamic"]["output_voxels"][0]
    up = np.asarray(jresize(logits.astype(jnp.float32), LABEL_SHAPE))
    top2 = np.sort(up, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-3 * np.abs(up).max()
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(classes.numpy()[decided],
                                  up.argmax(-1)[decided])


def test_weight_bridge_round_trip(pair):
    """port state_dict -> reference converter -> load_flax_params gives the
    same tensors back, into a model seeded differently."""
    model, _, variables, _ = pair
    other = port_model(seed=99)
    load_flax_params(other, variables["params"], variables["batch_stats"])
    want = model.state_dict()
    got = other.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[key], value, rtol=0, atol=0,
                                       msg=key)


def test_load_flax_params_is_strict(pair):
    model, _, variables, _ = pair
    params = dict(variables["params"])
    params["stray"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(port_model(), params, variables["batch_stats"])
    params = dict(variables["params"])
    params.pop("pts_bbox_head")
    with pytest.raises(KeyError, match="not filled"):
        load_flax_params(port_model(), params, variables["batch_stats"])


def test_config_defaults_match_jax():
    """Same fields and defaults as the JAX DetectorConfig, beside the
    port's own head fields, whose default is the JAX package's one head;
    the flagship grid of 0.8 m voxels is 64x64x8 and D = 112."""
    fields = dataclasses.asdict(DetectorConfig())
    want = dataclasses.asdict(JaxConfig())
    assert {k: fields[k] for k in want} == want
    assert (fields["head_type"], fields["mask_head"]) == ("OccHead", None)
    cfg = DetectorConfig()
    assert cfg.grid_shape == JaxConfig().grid_shape == (64, 64, 8)
    assert cfg.num_depth == 112 and cfg.feature_size == (48, 160)


def test_bf16_forward_keeps_fp32_islands(pair):
    """A bf16 copy of the model runs on the CPU with finite outputs; the
    depth distributions leave their fp32 softmaxes normalised."""
    model, _, _, batch = pair
    half = port_model(seed=7).to(torch.bfloat16)
    out = half(_torch_batch(batch))
    assert out["output_voxels"].dtype == torch.bfloat16
    assert torch.isfinite(out["output_voxels"].float()).all()
    sums = out["depth_prob"].float().sum(1)
    torch.testing.assert_close(sums, torch.ones_like(sums), atol=2e-2,
                               rtol=0)


def test_cpu_model_refuses_the_kernels(pair):
    model, _, _, batch = pair
    with pytest.raises(ValueError, match="CUDA"):
        model(_torch_batch(batch), use_kernel=True)
