"""The port's data-parallel train step at TINY: 2 gloo ranks at B = 1
against the JAX train step at B = 2 on the global batch and against the
port's own one-process step at B = 2.

The ranks run in spawned processes (tests/torch_ranks.py ``ddp_case``)
with the weights of tests/test_torch_train.py's fixture (``port_model``,
carried to JAX by ``utils.weights.flax_trees``), its labelled batch and
its submodule inputs; each rank takes its rows. Every side takes the ASPP
dropout mask from numpy (the only random draw at TINY; each rank its rows
of the global mask).

- Losses of step 1 against the JAX training forward and ``compute_losses``
  on the global batch: rtol 2e-3 (tests/test_torch_train.py's tolerance);
  against the port in one process: rtol 1e-5, and 1e-3 at step 2.
- Gradients submodule by submodule (the sum over the global batch of each
  submodule's output times a cotangent, pooled and reduced as the train
  step pools and reduces): against JAX within max(2e-2 * leaf scale, 1e-4
  * global scale), tests/test_torch_train.py's tolerance; against the port
  in one process within max(1e-3 * leaf scale, 1e-4 * global scale).
- The whole step's gradient against the port in one process within 2.5e-2
  of the global scale. The whole detector's gradient at TINY is
  ill-conditioned (tests/test_torch_train.py): replacing the one-process
  BatchNorm statistics by the pooled two-pass ones, in a one-rank group on
  the same batch, moves backbone leaves by 1.2% of the global scale, so
  the per-leaf check is the submodule one. The plain path does not run in
  float64 (its norms, losses and splat compute in fp32), so no float64
  comparison is made.
- Parameters and buffers bitwise equal across the ranks after 2 steps;
  every step's loss terms identical on both ranks.
"""

import jax
import numpy as np
import pytest
import torch

from stereoscene_tpu.engine import train as jtrain
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_torch.utils.weights import flax_trees
from tests import torch_ranks
from tests.test_models import TINY
from tests.test_torch_train import (
    ASPP_SHAPE,
    LOSS_CFG,
    _aspp_mask_patch,
    _flat,
    _jax_module_grads,
    _labeled_batch,
    _module_inputs,
    port_model,
)

W = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(5)
    batch = _labeled_batch(rng)
    mask = rng.rand(*ASPP_SHAPE) < 0.5
    inputs = _module_inputs(rng)
    model = port_model(seed=7)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    args = (model.cfg, weights, batch, inputs, mask, LOSS_CFG)
    ranks = torch_ranks.run_ranks(torch_ranks.ddp_case, W,
                                  tmp_path_factory.mktemp("ddp"), *args)
    one = torch_ranks.ddp_case(0, 1, None, *args)
    params, stats = flax_trees(model)
    jm = JaxModel(cfg=TINY)
    loss_cfg = jtrain.LossConfig(**LOSS_CFG)

    def jax_losses(p, s, b):
        out, _ = jm.apply({"params": p, "batch_stats": s}, b, train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jtrain.compute_losses(out, b, loss_cfg)

    with pytest.MonkeyPatch.context() as mp:
        _aspp_mask_patch(mp, mask)
        jlosses = jax.jit(jax_losses)(params, stats, batch)
        jgrads = _flat(_jax_module_grads(params, stats, inputs))
    jlosses = {k: float(v) for k, v in jlosses.items()}
    jlosses["loss_total"] = sum(jlosses.values())

    def flat(grads):
        tree, _ = flax_trees(model, grads)
        return _flat(tree)

    return dict(ranks=ranks, one=one, weights=weights, jlosses=jlosses,
                jgrads=jgrads,
                rank_grads=[flat(r["modules"]) for r in ranks],
                one_grads=flat(one["modules"]))


def _leaves_off(got, want, leaf_tol, global_tol):
    assert got.keys() == want.keys() and len(want) > 300
    scale = max(np.abs(g).max() for g in want.values())
    assert scale > 1e-2  # a degenerate grad field would hide bugs
    bad = []
    for key, w in want.items():
        leaf = max(np.abs(w).max(), np.abs(got[key]).max(), 1e-6)
        err = np.abs(got[key] - w).max()
        if err > max(leaf_tol * leaf, global_tol * scale):
            bad.append((key, float(err / leaf)))
    return bad


def test_ddp_step_losses_match_jax_on_the_global_batch(runs):
    for r in runs["ranks"]:
        logs = r["steps"]["logs"][0]
        assert set(logs) == set(runs["jlosses"])
        for key, want in runs["jlosses"].items():
            np.testing.assert_allclose(logs[key], want, rtol=2e-3,
                                       err_msg=key)


def test_ddp_submodule_grads_match_jax(runs):
    for grads in runs["rank_grads"]:
        bad = _leaves_off(grads, runs["jgrads"], 2e-2, 1e-4)
        assert not bad, f"{len(bad)} leaves off: {sorted(bad)[:8]}"


def test_ddp_submodule_grads_match_one_process(runs):
    for grads in runs["rank_grads"]:
        bad = _leaves_off(grads, runs["one_grads"], 1e-3, 1e-4)
        assert not bad, f"{len(bad)} leaves off: {sorted(bad)[:8]}"


def test_ddp_step_matches_one_process(runs):
    one = runs["one"]["steps"]
    for r in runs["ranks"]:
        for i, rtol in enumerate((1e-5, 1e-3)):
            for key, want in one["logs"][i].items():
                np.testing.assert_allclose(r["steps"]["logs"][i][key], want,
                                           rtol=rtol,
                                           err_msg=f"step {i + 1} {key}")
        got, want = r["steps"]["grads"], one["grads"]
        assert got.keys() == want.keys()
        scale = max(float(g.abs().max()) for g in want.values())
        worst = max(float((got[k] - want[k]).abs().max()) for k in want)
        assert worst <= 2.5e-2 * scale, worst / scale


def test_ddp_ranks_stay_bitwise_equal(runs):
    a, b = (r["steps"] for r in runs["ranks"])
    assert a["logs"] == b["logs"]
    assert a["state"].keys() == b["state"].keys()
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    moved = [k for k, v in runs["weights"].items()
             if not torch.equal(v, a["state"][k])]
    assert len(moved) > 300  # the steps moved the parameters
