"""The port's data parallelism (``stereoscene_torch.parallel``) on two CPU
ranks over gloo, against the JAX package on the concatenated batch and
against the port in one process.

The ranks run in spawned processes (tests/torch_ranks.py, no JAX there);
each takes its rows of the same seeded numpy inputs. Tolerances:

- ``all_sum``, ``reduce_ints``, the metric state sum and the broadcast:
  exact;
- BatchNorm (4-D and 5-D, plain and under ``torch.utils.checkpoint`` with
  the statistics updated once) against ``stereoscene_tpu.models.layers.
  BatchNorm``: outputs, input gradients (each rank's rows), weight
  gradients (summed over the ranks) and running statistics within 1e-5 of
  each tensor's scale;
- the pooled losses against the JAX losses: values rtol 1e-5, gradients
  within 1e-5 of their scale; a rank's gradient is W times its rows of the
  global one (``all_sum``'s backward sums the ranks' equal loss
  gradients; ``reduce_gradients`` divides by W);
- keep masks: each rank's rows of the one-process draw, bitwise; an
  EfficientNet block with drop path, checkpointed on two ranks, against
  the plain block in one process within 1e-5 of scale.

Then the CLIs as two spawned ranks on a TINY SemanticKITTI tree: the train
CLI with ``--deterministic-data`` (5 train frames, shards of 3 and 2, so
2 steps an epoch, the fewer) gives the losses of one process at B = 2
(rtol 1e-5 at step 1, 1e-3 at step 2: step 1 moves the parameters by
Adam's lr * sign(g), which rounding can flip where g is about 0); a
SIGTERM to one rank after step 1 makes both save that step, and the
resume (mid-epoch) ends bitwise equal to the uninterrupted run; the eval CLI over 3
val frames (shards of 2 and 1) gives exactly the one-process metrics.
``--flops``: the parameter count equals the JAX ``param_count`` of the
same weights, and the FLOPs equal an independent count (forward hooks on
the Conv and Linear modules, a dispatch mode's count of ``bmm``).
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.engine.flops import param_count as jax_param_count
from stereoscene_tpu.losses import depth as jdepth
from stereoscene_tpu.losses import semkitti as jsem
from stereoscene_tpu.models.layers import BatchNorm as JBatchNorm
from stereoscene_torch import parallel
from stereoscene_torch.engine import flops
from stereoscene_torch.engine.eval import make_eval_step
from stereoscene_torch.metrics import empty_state
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.models.efficientnet import InvertedResidual
from stereoscene_torch.utils.weights import flax_trees, seeded_init_
from tests import torch_ranks
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_data import write_semkitti_tree
from tests.test_torch_lidar import write_lidar
from tests.test_torch_train_cli import TINY_CFG

W = 2
LOSSES = ("ce_ssc_loss", "sem_scal_loss", "geo_scal_loss", "bce_depth_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    rng = np.random.RandomState(0)

    def n(*shape, scale=1.0, shift=0.0):
        return (rng.randn(*shape) * scale + shift).astype(np.float32)

    c = 6
    probs = np.exp(n(8, 4, 4, 16))
    depth = (rng.rand(4, 2, 16, 16) < 0.3) * rng.uniform(2.1, 9.6,
                                                         (4, 2, 16, 16))
    block = InvertedResidual(8, 8, 3, 1, 6, 4, drop_path_rate=0.5)
    for m in block.modules():  # statistics away from their defaults
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(generator=torch.Generator().manual_seed(1))
            m.running_var.uniform_(0.5, 1.5)
    return dict(
        x=n(4, 3), u=n(4, 3),
        bn4=n(4, c, 5, 7, scale=2.0, shift=1.0), bn4_cot=n(4, c, 5, 7),
        bn5=n(4, c, 3, 4, 5, scale=0.5, shift=-1.0), bn5_cot=n(4, c, 3, 4, 5),
        bn_state=dict(weight=n(c, scale=0.3, shift=1.0), bias=n(c),
                      running_mean=n(c), running_var=np.exp(n(c))),
        logits=n(4, 6, 6, 4, 20, scale=2.0),
        target=np.where(rng.rand(4, 6, 6, 4) < 0.1, 255,
                        rng.randint(0, 20, (4, 6, 6, 4))).astype(np.int32),
        depth=depth.astype(np.float32),
        depth_probs=(probs / probs.sum(-1, keepdims=True)).astype(np.float32),
        block={k: v.numpy() for k, v in block.state_dict().items()},
        block_x=n(4, 8, 6, 6), block_cot=n(4, 8, 6, 6))


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """(the global inputs, the two ranks' results, the one process's)."""
    data = _data()
    ranks = torch_ranks.run_ranks(torch_ranks.units, W,
                                  tmp_path_factory.mktemp("units"),
                                  dict(data, with_cp=1))
    one = torch_ranks.units(0, 1, None, dict(data, with_cp=0))
    return data, ranks, one


def _rows(a, rank, groups=1):
    """Rank ``rank``'s rows of the global ``a`` (``groups`` blocks)."""
    a = np.asarray(a)
    n = a.shape[0] // (groups * W)
    a = a.reshape(groups, W * n, *a.shape[1:])[:, rank * n:(rank + 1) * n]
    return a.reshape(-1, *a.shape[2:])


def _close(got, want, tol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=msg)


def test_all_sum_forward_and_backward(units):
    data, ranks, _ = units
    x, u = data["x"], data["u"]
    total = sum(_rows(x, r) ** 2 for r in range(W))
    for r, out in enumerate(ranks):
        y, gx = out["all_sum"]
        np.testing.assert_allclose(y.numpy(), total, rtol=1e-6)
        # d/dx_r of sum over ranks of <u_r', sum x^2> = 2 x_r sum_r' u_r'
        np.testing.assert_allclose(
            gx.numpy(), 2 * _rows(x, r) * sum(_rows(u, q) for q in range(W)),
            rtol=1e-6)
    assert not parallel.initialized()
    t = torch.ones(2)
    assert parallel.all_sum(t) is t  # the identity without a group


def test_reduce_ints_metric_sum_and_broadcast(units):
    _, ranks, _ = units
    for out in ranks:
        assert out["ints"] == [[3, -1], [1, -1], [2, 0]]
        for k, v in out["metrics"].items():
            assert v.dtype == torch.int64 and bool((v == 11).all()), k
        assert bool((out["broadcast"] == 1.0).all())  # rank 0's weight


def _jax_bn(data, key):
    """JAX BatchNorm in training mode on the whole batch: (y NCHW, dx,
    dscale, dbias, running mean, running var)."""
    x = np.moveaxis(data[key], 1, -1)
    cot = np.moveaxis(data[key + "_cot"], 1, -1)
    st = data["bn_state"]
    variables = {
        "params": {"BatchNorm_0": {"scale": st["weight"],
                                   "bias": st["bias"]}},
        "batch_stats": {"BatchNorm_0": {"mean": st["running_mean"],
                                        "var": st["running_var"]}}}
    bn = JBatchNorm(epsilon=1e-5, torch_momentum=0.1)

    def f(params, x):
        y, upd = bn.apply(dict(variables, params=params), x, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], x)
    s = upd["batch_stats"]["BatchNorm_0"]
    return (np.moveaxis(np.asarray(y), -1, 1), np.moveaxis(np.asarray(gx),
                                                            -1, 1),
            gp["BatchNorm_0"]["scale"], gp["BatchNorm_0"]["bias"],
            s["mean"], s["var"])


@pytest.mark.parametrize("key", ["bn4_cp0", "bn4_cp1", "bn5_cp0",
                                 "bn5_cp1"])
def test_batchnorm_matches_jax_on_the_global_batch(units, key):
    data, ranks, _ = units
    y, gx, gw, gb, mean, var = _jax_bn(data, key[:3])
    for r, out in enumerate(ranks):
        got = out[key]
        _close(got["y"], _rows(y, r), msg="y")
        _close(got["gx"], _rows(gx, r), msg="dx")
        _close(got["gw"], gw, msg="dweight")
        _close(got["gb"], gb, msg="dbias")
        _close(got["mean"], mean, msg="running mean")
        _close(got["var"], var, msg="running var")


def _jax_loss(name, data):
    if name == "bce_depth_loss":
        return jax.value_and_grad(lambda p: jdepth.bce_depth_loss(
            jnp.asarray(data["depth"]), p, 4, (2.0, 10.0, 0.5)))(
                jnp.asarray(data["depth_probs"]))
    extra = ((jsem.class_weights_from_frequencies(),)
             if name == "ce_ssc_loss" else ())
    return jax.value_and_grad(lambda lg: getattr(jsem, name)(
        lg, jnp.asarray(data["target"]), *extra))(jnp.asarray(data["logits"]))


@pytest.mark.parametrize("name", LOSSES)
def test_pooled_loss_matches_jax_on_the_global_batch(units, name):
    data, ranks, one = units
    value, grad = _jax_loss(name, data)
    grad = np.asarray(grad)
    for r, out in enumerate(ranks):
        got, got_grad = out[name]
        np.testing.assert_allclose(float(got), float(value), rtol=1e-5)
        _close(got_grad.numpy() / W, _rows(grad, r), msg=name)
    np.testing.assert_allclose(float(one[name][0]), float(value), rtol=1e-5)


def test_keep_masks_are_the_rows_of_the_one_process_draw(units):
    _, ranks, one = units
    for key, groups in (("mask_eyes", 2), ("mask_maps", 1)):
        want = one[key].numpy()
        assert 0 < want.mean() < 1
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[key].numpy(),
                                          _rows(want, r, groups))


def test_checkpointed_block_with_drop_path_matches_one_process(units):
    """Two ranks run the block under ``with_cp`` (the recompute pools
    BatchNorm's statistics again) with the global drop-path mask; one
    process runs it plainly on the whole batch."""
    _, ranks, one = units
    want = one["block"]
    assert 0 < want["keep"].float().mean() < 1
    for r, out in enumerate(ranks):
        got = out["block"]
        np.testing.assert_array_equal(got["keep"].numpy(),
                                      _rows(want["keep"].numpy(), r, 2))
        _close(got["y"], _rows(want["y"].numpy(), r, 2), msg="y")
        _close(got["gx"], _rows(want["gx"].numpy(), r, 2), msg="dx")
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w, msg="param grad")
        for k, v in want["state"].items():
            _close(got["state"][k], v, msg=k)


TRAIN_FRAMES = tuple(f"{i:06d}" for i in range(5))
VAL_FRAMES = ("000000", "000005", "000010")
TERMS = ("loss_voxel_ce_0", "loss_voxel_sem_scal_0", "loss_voxel_geo_scal_0",
         "loss_depth", "loss_total")


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    """A TINY tree: 5 train frames with LiDAR, 3 val frames; the train
    CLI's arguments, without the work dir."""
    root = str(tmp_path_factory.mktemp("dp_tree"))
    _, ann = write_semkitti_tree(root, frame_ids=TRAIN_FRAMES, seq="00",
                                 seed=1)
    write_semkitti_tree(root, frame_ids=VAL_FRAMES, seq="08", seed=2)
    lidar = write_lidar(root, "00", TRAIN_FRAMES, n_points=6000)
    val = [f"data.val.data_root={root}", f"data.val.ann_file={ann}"]
    opts = val + [f"data.train.data_root={root}",
                  f"data.train.ann_file={ann}", f"lidar_root={lidar}",
                  f"lidarseg_root={lidar}"]
    argv = [TINY_CFG, "--device", "cpu", "--max-epochs", "1",
            "--deterministic-data", "--seed", "0", "--cfg-options", *opts]
    return argv, val


@pytest.fixture(scope="module")
def dp_runs(cli_tree, tmp_path_factory):
    """The train CLI as 2 ranks at B = 1 for one epoch (uninterrupted, with
    the loop's eval after it), as one process at B = 2, and as 2 ranks cut
    by a SIGTERM to rank 1 after step 1, then resumed."""
    argv, _ = cli_tree
    tmp = tmp_path_factory.mktemp("dp_runs")
    full_dir, cut_dir = str(tmp / "full"), str(tmp / "cut")
    cut_argv = argv + ["evaluation.interval=1", "--work-dir", cut_dir]
    full, cut, resumed = zip(*torch_ranks.run_ranks(
        torch_ranks.train_cli_rank, W, tmp,
        [(argv + ["evaluation.interval=1", "--work-dir", full_dir], None),
         (cut_argv, 1), (cut_argv, None)], join=False,
        timeout=8 * torch_ranks.TIMEOUT_S))
    one, = torch_ranks.train_cli_rank(0, 1, None, [(
        argv + ["evaluation.interval=100", "--batch-size", "2",
                "--work-dir", str(tmp / "one")], None)])
    return dict(full=full, one=one, cut=cut, resumed=resumed,
                full_dir=full_dir, cut_dir=cut_dir)


def _records(work_dir):
    import json

    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_two_ranks_match_one_process_at_twice_the_batch(dp_runs):
    """Shards of 3 and 2 frames take 2 steps an epoch on both ranks; the
    ranks log the same losses, those of one process at B = 2."""
    full, one = dp_runs["full"], dp_runs["one"]
    assert [r["step"] for r in full] == [2, 2] and one["step"] == 2
    for i in range(2):
        assert full[0]["steps"][i] == full[1]["steps"][i]
        rtol = 1e-5 if i == 0 else 1e-3
        for key in TERMS:
            np.testing.assert_allclose(full[0]["steps"][i][key],
                                       one["steps"][i][key], rtol=rtol,
                                       err_msg=f"step {i + 1} {key}")
    assert full[0]["steps"][0]["loss_depth"] > 0
    for k, v in full[0]["state"].items():
        assert torch.equal(v, full[1]["state"][k]), k
    # rank 0 alone writes the log: one line per logged step and eval
    records = _records(dp_runs["full_dir"])
    assert sum("loss_total" in r for r in records) == 1  # iter 0 only
    evals = [r["eval"] for r in records if "eval" in r]
    assert len(evals) == 1 and evals[0]["eval_frames"] == len(VAL_FRAMES)


def test_sigterm_to_one_rank_saves_both_and_resumes_bitwise(dp_runs):
    cut, resumed, full = dp_runs["cut"], dp_runs["resumed"], dp_runs["full"]
    assert [r["step"] for r in cut] == [1, 1]
    assert [len(r["steps"]) for r in cut] == [1, 1]
    records = _records(dp_runs["cut_dir"])
    assert [r["preempted_at_step"] for r in records
            if "preempted_at_step" in r] == [1]
    assert [r["step"] for r in resumed] == [2, 2]
    assert resumed[0]["steps"] == full[0]["steps"][1:]
    for r in resumed:
        for k, v in full[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
    evals = [[_semkitti(r["eval"]) for r in _records(dp_runs[d])
              if "eval" in r] for d in ("cut_dir", "full_dir")]
    assert len(evals[0]) == len(evals[1]) == 1
    _same(evals[0][0], evals[1][0])


def _semkitti(metrics):
    return {k: v for k, v in metrics.items() if k.startswith("semkitti_")}


def _same(a, b):
    assert a.keys() == b.keys() and len(a) == 25
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k


def test_eval_cli_two_ranks_equal_one_process(cli_tree, dp_runs, tmp_path,
                                              capsys):
    """Shards of 2 and 1 val frames; the int64 metric states summed over
    the ranks give exactly the one-process metrics and the loop's eval.
    The one-process run also prints the ``--flops`` line."""
    from stereoscene_torch.tools import test as test_cli

    _, val = cli_tree
    argv = [TINY_CFG, "--device", "cpu", "--checkpoint",
            os.path.join(dp_runs["full_dir"], "ckpts"), "--cfg-options",
            *val]
    ranks = torch_ranks.run_ranks(torch_ranks.eval_cli_rank, W, tmp_path,
                                  argv, join=False)
    one = test_cli.main(argv + ["--flops"])
    assert one["eval_frames"] == len(VAL_FRAMES)
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[flops]"))
    assert "GFLOP/call, n/a GB accessed" in line and "M params" in line
    for r in ranks:
        assert r["eval_frames"] == len(VAL_FRAMES)
        _same(_semkitti(r), _semkitti(one))
    loop = [r["eval"] for r in _records(dp_runs["full_dir"]) if "eval" in r]
    _same(_semkitti(loop[0]), _semkitti(one))


class _MatmulCount(torch.utils._python_dispatch.TorchDispatchMode):
    """FLOPs of every ``aten.bmm`` and ``aten.mm`` call: 2 m n k a
    product."""

    def __init__(self):
        super().__init__()
        self.flops = {"aten.bmm": 0, "aten.mm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in ("aten.bmm", "aten.mm"):
            a, b = args[0].shape, args[1].shape
            self.flops[name] += 2 * math.prod(a) * b[-1]
        return func(*args, **(kwargs or {}))


def _conv_linear_hooks(model):
    """Forward hooks adding each Conv, transposed Conv and Linear module's
    FLOPs (2 per multiply-add, bias left out) -> (counts, handles)."""
    counts = {"aten.convolution": 0, "aten.addmm": 0}

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Linear):
            counts["aten.addmm"] += 2 * output.numel() * module.in_features
        elif module.transposed:
            counts["aten.convolution"] += (
                2 * inputs[0].numel() * module.out_channels // module.groups
                * math.prod(module.kernel_size))
        else:
            counts["aten.convolution"] += (
                2 * output.numel() * module.in_channels // module.groups
                * math.prod(module.kernel_size))

    kinds = (torch.nn.Linear, torch.nn.modules.conv._ConvNd)
    return counts, [m.register_forward_hook(hook) for m in model.modules()
                    if isinstance(m, kinds)]


def test_flops_report_matches_jax_params_and_an_independent_count(capsys):
    model = BEVDepthOccupancy(DetectorConfig(**dataclasses.asdict(TINY)),
                              device="cpu")
    seeded_init_(model, 7)
    batch = model.attach_plan({k: torch.from_numpy(np.array(v))
                               for k, v in _tiny_batch(b=1).items()})
    step = make_eval_step((16, 16, 8))
    out = flops.report(step, model, model, batch, empty_state(),
                       use_kernel=False, name="eval forward")
    params, _ = flax_trees(model)
    assert out["params"] == jax_param_count(params) > 0
    counts, handles = _conv_linear_hooks(model)
    matmuls = _MatmulCount()
    try:
        with matmuls:
            step(model, batch, empty_state(), use_kernel=False)
    finally:
        for h in handles:
            h.remove()
    want = {k: v for k, v in {**counts, **matmuls.flops}.items() if v}
    assert out["by_op"] == want
    assert out["flops"] == sum(want.values())
    assert want["aten.convolution"] > 0.9 * out["flops"]
    line = capsys.readouterr().out.strip()
    assert line.startswith("[flops] eval forward: ")
    assert f"{out['params'] / 1e6:.2f} M params" in line
