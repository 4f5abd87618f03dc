"""Run functions of the port on several CPU ranks, one spawned process a
rank, over a gloo process group, for the data-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_ddp.py).

This module imports torch and the port only, never JAX, so a spawned rank
starts quickly; the tests hold the ranks' results against JAX in the
pytest process. Every group rendezvouses through a fresh ``file://`` store
under the test's ``tmp_path`` (no port to collide with under xdist) and
times out after ``TIMEOUT_S``; every rank is joined with a deadline, so a
hang fails one test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import time
import uuid

import torch

from stereoscene_torch import parallel

TIMEOUT_S = 60.0


def store_url(tmp_path) -> str:
    """A fresh ``file://`` rendezvous for one process group."""
    return f"file://{os.path.join(str(tmp_path), uuid.uuid4().hex)}"


def _rank_main(fn, rank, world, url, join, out, args):
    torch.set_num_threads(1)
    if join:
        parallel.init_distributed(url, world, rank, "cpu",
                                  timeout_s=TIMEOUT_S)
    try:
        result = fn(rank, world, url, *args)
    finally:
        if join:
            parallel.shutdown()
    torch.save(result, out)


def run_ranks(fn, world: int, tmp_path, *args, join: bool = True,
              timeout: float = 4 * TIMEOUT_S) -> list:
    """``fn(rank, world, url, *args)`` on ``world`` spawned processes;
    returns their results in rank order (tensors, containers and Python
    scalars, as ``torch.save`` keeps them). With ``join`` each rank joins
    the gloo group at ``url`` first and leaves it after; without, ``fn``
    joins it itself (a CLI's ``--coordinator url``). Raises if a rank
    fails or is still running after ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    url = store_url(tmp_path)
    outs = [os.path.join(str(tmp_path), f"rank{r}-{uuid.uuid4().hex}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, url, join, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise RuntimeError(f"ranks {hung} still running after {timeout} s; "
                           f"exit codes {codes}")
    return [torch.load(out, weights_only=True) for out in outs]


def _rows(batch, rank, b):
    """Rank ``rank``'s ``b`` samples of a global numpy batch, as tensors."""
    return {k: torch.from_numpy(v[rank * b:(rank + 1) * b].copy())
            for k, v in batch.items()}


def train_steps(rank, world, url, cfg, weights, batch, loss_kw, steps,
                aspp_mask=None):
    """``steps`` train steps of the port's model (``cfg``, ``weights``) on
    this rank's rows of the numpy ``batch``, each step's generator
    ``step_generator(0, step)``; ``aspp_mask`` (numpy, the global batch's)
    stands in for the ASPP dropout draw. Returns each step's loss terms,
    the gradients that step 1 applied (after the reduction over ranks),
    the parameters and buffers at the end."""
    from stereoscene_torch.engine import train
    from stereoscene_torch.engine.loop import step_generator
    from stereoscene_torch.models.detector import BEVDepthOccupancy

    model = BEVDepthOccupancy(cfg, device="cpu")
    model.load_state_dict(weights)
    state = train.create_train_state(model, device="cpu")
    applied = []
    apply = train.apply_gradients

    def record(state, grads):
        applied.append([g.clone() for g in grads])
        apply(state, grads)

    step = train.make_train_step(train.LossConfig(**loss_kw))
    b = next(iter(batch.values())).shape[0] // world
    logs = []
    with _aspp_mask(aspp_mask, rank, world), \
            _patched(train, "apply_gradients", record):
        for _ in range(steps):
            _, out = step(state, _rows(batch, rank, b),
                          step_generator(0, state.step, "cpu"))
            logs.append({k: float(v) for k, v in out.items()})
    return {"logs": logs,
            "grads": dict(zip([n for n, _ in state.trainable], applied[0])),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


@contextlib.contextmanager
def _patched(obj, name, value):
    """``obj.name`` is ``value`` within the block (these functions also
    run in the pytest process)."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _aspp_mask(aspp_mask, rank, world):
    """Within the block the ASPP dropout takes this rank's rows of
    ``aspp_mask`` (numpy, the global batch's) in place of its draw."""
    from stereoscene_torch.models import layers

    if aspp_mask is None:
        return contextlib.nullcontext()
    b = aspp_mask.shape[0] // world
    rows = torch.from_numpy(aspp_mask[rank * b:(rank + 1) * b].copy())
    return _patched(layers, "keep_mask",
                    lambda shape, keep, gen, device: rows)


def module_grads(rank, world, url, cfg, weights, inputs, aspp_mask):
    """The gradients of every parameter of the port's model (``cfg``,
    ``weights``) in training mode under the sum over the global batch of
    each submodule's output times its cotangent (tests/test_torch_train.py
    ``_module_inputs``, JAX layouts: ``imgs`` and ``enc_cot`` stack the
    left eyes, then the right ones), on this rank's rows. The objective is
    pooled by ``all_sum`` and the gradients reduced by
    ``reduce_gradients``, as the train step pools and reduces; with
    ``world`` 1 and no group, the one-process gradients. The ASPP dropout
    takes its rows of ``aspp_mask``."""
    from stereoscene_torch.models.detector import BEVDepthOccupancy

    model = BEVDepthOccupancy(cfg, device="cpu")
    model.load_state_dict(weights)
    model.train()
    b = inputs["left"].shape[0] // world
    t = {}
    for k, v in inputs.items():
        if k == "vols":
            continue
        if k in ("imgs", "enc_cot"):  # [eye * B + sample]
            v = v.reshape(2, -1, *v.shape[1:])[:, rank * b:(rank + 1) * b]
            v = v.reshape(-1, *v.shape[2:])
        else:
            v = v[rank * b:(rank + 1) * b]
        t[k] = torch.from_numpy(v.copy())
    vols = [torch.from_numpy(v[rank * b:(rank + 1) * b].copy())
            for v in inputs["vols"]]
    vt = model.img_view_transformer

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    with _aspp_mask(aspp_mask, rank, world):
        imgs = t["imgs"].reshape(2, b, *t["imgs"].shape[1:]).transpose(0, 1)
        left, right = model.encode_images(imgs)
        total = (torch.cat([left, right]).permute(0, 2, 3, 1)
                 * t["enc_cot"]).sum()
        out = vt.stereo_volume_net(nchw(t["left"]), nchw(t["right"]),
                                   t["ml"], t["mr"], t["calib"])
        total = total + (out["single_channel"] * t["single_cot"]).sum() + (
            out["multi_channel"].permute(0, 2, 3, 4, 1)
            * t["multi_cot"]).sum()
        dn = vt.depth_net(nchw(t["left"]), t["ml"])
        total = total + (dn.permute(0, 2, 3, 1) * t["dn_cot"]).sum()
        total = total + (vt.volume_interaction(*vols) * t["vi_cot"]).sum()
        logits = model.bev_encode(t["vox"].permute(0, 4, 1, 2, 3))
        total = total + (logits.permute(0, 2, 3, 4, 1)
                         * t["bev_cot"]).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(parallel.all_sum(total),
                                list(model.parameters()), allow_unused=True)
    grads = parallel.reduce_gradients(
        [torch.zeros_like(p) if g is None else g
         for p, g in zip(model.parameters(), grads)])
    return dict(zip(names, grads))


def _bn_run(bn, x, cot, checkpointed):
    """BatchNorm ``bn`` (training mode) on ``x`` [N, C, ...], optionally
    under ``layers.checkpoint_region`` with the statistics updated by the
    forward only (as a checkpointed EfficientNet block runs it); returns
    (y, the gradients of sum(y * cot) for x, weight and bias)."""
    from stereoscene_torch.models.layers import checkpoint_region

    x = x.clone().requires_grad_()
    y = checkpoint_region(bn, bn, x) if checkpointed else bn(x)
    gx, gw, gb = torch.autograd.grad((y * cot).sum(),
                                     [x, bn.weight, bn.bias])
    return y.detach(), gx, gw, gb


def units(rank, world, url, data):
    """The parallel building blocks on this rank's rows of the global
    numpy inputs in ``data`` (tests/test_torch_parallel.py ``_data``);
    with ``world`` 1 and no group, the one-process results. Gradients of
    parameters are summed over the ranks (``sum_tensors``), those of a
    rank's inputs are its own."""
    from stereoscene_torch import metrics
    from stereoscene_torch.losses import (
        bce_depth_loss,
        ce_ssc_loss,
        class_weights_from_frequencies,
        geo_scal_loss,
        sem_scal_loss,
    )
    from stereoscene_torch.models import layers
    from stereoscene_torch.models.efficientnet import InvertedResidual

    def rows(a, groups=1):
        a = torch.from_numpy(a)
        n = a.shape[0] // (groups * world)
        a = a.reshape(groups, world * n, *a.shape[1:])
        return a[:, rank * n:(rank + 1) * n].reshape(-1, *a.shape[2:])

    out = {}
    # all_sum: forward and backward, with gradients that differ by rank
    x = rows(data["x"]).requires_grad_()
    y = parallel.all_sum(x ** 2)
    (gx,) = torch.autograd.grad((y * rows(data["u"])).sum(), [x])
    out["all_sum"] = (y.detach(), gx)

    # BatchNorm, plain and checkpointed, 4-D and 5-D
    for key in ("bn4", "bn5"):
        for cp in (False, True):
            bn = layers.BatchNorm(data[key].shape[1], momentum=0.1)
            bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                                data["bn_state"].items()}, strict=False)
            bn.train()
            yb, gxb, gw, gb = _bn_run(bn, rows(data[key]),
                                      rows(data[key + "_cot"]), cp)
            gw, gb = parallel.sum_tensors([gw, gb])
            out[f"{key}_cp{int(cp)}"] = dict(
                y=yb, gx=gxb, gw=gw, gb=gb, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())

    # the pooled losses: value and the gradient of this rank's logits
    logits = rows(data["logits"]).requires_grad_()
    target = rows(data["target"])
    for name, fn in (("ce_ssc_loss", lambda lg, t: ce_ssc_loss(
            lg, t, class_weights_from_frequencies())),
            ("sem_scal_loss", sem_scal_loss),
            ("geo_scal_loss", geo_scal_loss)):
        value = fn(logits, target)
        out[name] = (value.detach(), torch.autograd.grad(value, [logits])[0])
    probs = rows(data["depth_probs"]).requires_grad_()  # [b * cams + cam]
    value = bce_depth_loss(rows(data["depth"]), probs, 4, (2.0, 10.0, 0.5))
    out["bce_depth_loss"] = (value.detach(),
                             torch.autograd.grad(value, [probs])[0])

    # keep masks: the global draw, this rank's rows
    for key, shape, groups in (("mask_eyes", (4,), 2),
                               ("mask_maps", (2, 3, 5, 5), 1)):
        local = (shape[0] // world,) + shape[1:]
        gen = torch.Generator().manual_seed(11)
        out[key] = layers.keep_mask(local, 0.6, gen, "cpu", groups)

    # a checkpointed EfficientNet block with drop path, eye-major batch
    torch.manual_seed(0)
    block = InvertedResidual(8, 8, 3, 1, 6, 4, drop_path_rate=0.5,
                             with_cp=bool(data["with_cp"]))
    block.load_state_dict({k: torch.from_numpy(v)
                           for k, v in data["block"].items()})
    block.train()
    xb = rows(data["block_x"], groups=2).requires_grad_()
    keep = block.drop_mask(xb, torch.Generator().manual_seed(1), groups=2)
    yb = block(xb, keep)
    params = list(block.parameters())
    grads = torch.autograd.grad((yb * rows(data["block_cot"], 2)).sum(),
                                [xb] + params)
    out["block"] = dict(y=yb.detach(), keep=keep, gx=grads[0],
                        grads=parallel.sum_tensors(list(grads[1:])),
                        state={k: v.clone()
                               for k, v in block.state_dict().items()})

    # the metric state and the broadcast of rank 0's module
    state = {k: v + 10 ** rank for k, v in metrics.empty_state().items()}
    out["metrics"] = metrics.all_processes_state(state)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1.0)
    parallel.broadcast_module(lin)
    out["broadcast"] = lin.weight.detach().clone()
    out["ints"] = [parallel.reduce_ints([rank + 1, -rank], op)
                   for op in ("sum", "min", "max")]
    return out


def train_cli_rank(rank, world, url, runs):
    """The train CLI's runs, one after another, each as rank ``rank`` of
    ``world`` in a group of its own (``--coordinator url-<i>``), or as one
    process without a group when ``url`` is None. ``runs``: (argv,
    sigterm_at) pairs; a hook records every step's logs, and rank 1 sends
    itself SIGTERM after step ``sigterm_at``. Returns each run's logs,
    final step and model state."""
    import signal

    from stereoscene_torch.tools import train as train_cli

    out = []
    for i, (argv, sigterm_at) in enumerate(runs):
        steps = []

        def record(state, epoch, it, logs):
            steps.append({k: float(v) for k, v in logs.items()})
            if rank == 1 and state.step == sigterm_at:
                signal.raise_signal(signal.SIGTERM)

        if url is not None:
            argv = list(argv) + ["--coordinator", f"{url}-{i}",
                                 "--num-processes", str(world),
                                 "--process-id", str(rank)]
        state = train_cli.main(list(argv), hooks=[record])
        out.append({"steps": steps, "step": state.step,
                    "state": {k: v.clone()
                              for k, v in state.model.state_dict().items()}})
    return out


def eval_cli_rank(rank, world, url, argv):
    """The eval CLI as rank ``rank`` of ``world``; returns its metrics."""
    from stereoscene_torch.tools import test as test_cli

    return test_cli.main(list(argv) + [
        "--coordinator", url, "--num-processes", str(world),
        "--process-id", str(rank)])


def ddp_case(rank, world, url, cfg, weights, batch, inputs, aspp_mask,
             loss_kw):
    """tests/test_torch_ddp.py's two runs on this rank: two train steps
    (``train_steps``) and the submodule gradients (``module_grads``), both
    with the ASPP dropout mask ``aspp_mask``."""
    return {"steps": train_steps(rank, world, url, cfg, weights, batch,
                                 loss_kw, 2, aspp_mask),
            "modules": module_grads(rank, world, url, cfg, weights, inputs,
                                    aspp_mask)}


def spatial_case(rank, world, url, space, cfg, weights, batch, loss_kw,
                 steps=1):
    """tests/test_torch_spatial.py's run on rank ``rank`` of a (world //
    ``space``, ``space``) layout (``parallel.init_space``), or in one
    process when ``url`` is None: the port's model (``cfg``, ``weights``)
    on this rank's data index's rows of the numpy ``batch``. Returns the
    eval forward's logits (gathered whole on every space rank), each train
    step's loss terms, the gradients that step 1 applied (after the
    reduction over ranks), and the parameters and buffers at the end."""
    from stereoscene_torch.engine import train
    from stereoscene_torch.engine.loop import step_generator
    from stereoscene_torch.models.detector import BEVDepthOccupancy

    if url is not None and parallel.space_size() != space:
        parallel.init_space(space)
    b = next(iter(batch.values())).shape[0] // parallel.data_size()
    rows = _rows(batch, parallel.data_rank(), b)
    model = BEVDepthOccupancy(cfg, device="cpu")
    model.load_state_dict(weights)
    logits = model({k: v for k, v in rows.items()
                    if not k.startswith("gt_")})["output_voxels"]
    state = train.create_train_state(model, device="cpu")
    applied = []
    apply = train.apply_gradients

    def record(state, grads):
        applied.append([g.clone() for g in grads])
        apply(state, grads)

    step = train.make_train_step(train.LossConfig(**loss_kw))
    logs = []
    with _patched(train, "apply_gradients", record):
        for _ in range(steps):
            _, out = step(state, rows, step_generator(0, state.step, "cpu"))
            logs.append({k: float(v) for k, v in out.items()})
    return {"logits": logits, "logs": logs,
            "grads": dict(zip([n for n, _ in state.trainable], applied[0])),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def spatial_units(rank, world, url, data, model_args):
    """The spatial-sharding building blocks on this rank of a (1, 2)
    layout, each on its X slab (dim 2) of the global numpy inputs in
    ``data`` (tests/test_torch_spatial.py ``_unit_data``); with ``url``
    None, in one process on the whole tensors. Gradients of parameters are
    summed over the ranks (``sum_tensors``), those of the input are the
    slab's. Also the refusals, by message, and ``spatial_case`` on
    ``model_args``."""
    from stereoscene_torch.engine.train import LossConfig, compute_losses
    from stereoscene_torch.models import layers
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.parallel import spatial

    if url is not None:
        parallel.init_space(world)

    def t(key):
        return spatial.shard_voxels(torch.from_numpy(data[key]))

    def run(module, x, cot, params=None):
        params = list(module.parameters()) if params is None else params
        x = x.clone().requires_grad_()
        y = module(x)
        grads = torch.autograd.grad((y * cot).sum(), [x] + params)
        return dict(y=y.detach(), gx=grads[0],
                    gp=parallel.sum_tensors(list(grads[1:])))

    out = {}
    torch.manual_seed(0)
    convs = {
        "s1": layers.Conv3d(8, 6, 3, padding=1, sharded=True),
        "s2": layers.Conv3d(8, 6, 3, stride=2, padding=1, bias=False,
                            sharded=True),
        "k4": layers.Conv3d(64, 64, 3, padding=1, bias=False, kernel=True,
                            sharded=True),
    }
    for name, conv in convs.items():
        conv.load_state_dict({k: torch.from_numpy(v) for k, v in
                              data[f"{name}_w"].items()})
        out[name] = run(conv, t(f"{name}_x"), t(f"{name}_cot"))
    out["k4_gate"] = convs["k4"].k4
    gn = layers.GroupNorm(2, 8, sharded=True)
    gn.load_state_dict({k: torch.from_numpy(v)
                        for k, v in data["gn_w"].items()})
    out["gn"] = run(gn, t("s1_x"), t("gn_cot"))
    # rep_cot [S, ...] holds one cotangent a slab with its two halo planes
    rep_cot = torch.from_numpy(data["rep_cot"])
    if url is not None:
        out["replicate"] = run(
            lambda x: spatial.halo(x, 1, 1, edge="replicate"), t("s1_x"),
            rep_cot[rank], [])
    else:  # each slab's window of the whole tensor, edge planes repeated
        n = data["s1_x"].shape[2] // rep_cot.shape[0]

        def windows(x):
            padded = torch.cat([x[:, :, :1], x, x[:, :, -1:]], 2)
            return torch.stack([padded[:, :, r * n:r * n + n + 2]
                                for r in range(rep_cot.shape[0])])

        out["replicate"] = run(windows, t("s1_x"), rep_cot, [])
    if url is not None:  # the all_reduce route of gloo with CUDA tensors
        with _patched(spatial, "_p2p", lambda _: False):
            out["s1_reduce"] = run(convs["s1"], t("s1_x"), t("s1_cot"))
        out["gathered"] = spatial.gather_slabs(t("s1_x"))
        refusals = {}
        base = model_args[0]
        cfg = DetectorConfig(**{**dataclasses.asdict(base),
                                "xbound": (0.0, 12.0, 1.0)})
        try:
            BEVDepthOccupancy(cfg, device="cpu").check_sharding()
        except ValueError as exc:
            refusals["x"] = str(exc)
        try:
            compute_losses({"output_voxels": torch.zeros(1, 4, 8, 4, 20)},
                           {"gt_occ": torch.zeros(1, 16, 16, 8)},
                           LossConfig(voxel_lovasz=1.0, voxel_ohem=1.0))
        except ValueError as exc:
            refusals["lovasz"] = str(exc)
        try:
            layers.Conv3d(8, 6, 5, padding=2, sharded=True)(t("s1_x"))
        except ValueError as exc:
            refusals["conv5"] = str(exc)
        out["refusals"] = refusals
    out["model"] = spatial_case(rank, world, url, world, *model_args)
    return out


def loss_units(rank, world, url, units):
    """tests/test_torch_spatial_branches.py's loss-level cases on this
    rank's X slab (dim 1) of each case's numpy logits [B, X, Y, Z, C] and
    labels [B, X, Y, Z], or whole in one process (``url`` None): the loss
    and its gradient with respect to the (slab of the) logits, divided by
    the ranks (each rank's objective is the global loss, so its gradient
    is ``world`` times its share, as ``reduce_gradients`` takes it). Each
    case is (function name in ``losses``, logits, labels, keywords)."""
    from stereoscene_torch import losses
    from stereoscene_torch.parallel import spatial

    if url is not None and parallel.space_size() != world:
        parallel.init_space(world)
    out = {}
    for name, (fn, logits, labels, kw) in units.items():
        x = spatial.shard_voxels(torch.from_numpy(logits), dim=1)
        x = x.clone().requires_grad_()
        t = spatial.shard_voxels(torch.from_numpy(labels), dim=1)
        weights = losses.class_weights_from_frequencies()
        loss = getattr(losses, fn)(x, t, weights, **kw)
        (grad,) = torch.autograd.grad(loss, [x])
        out[name] = {"loss": float(loss.detach()), "grad": grad / world}
    return out


def spatial_branches(rank, world, url, cases, units):
    """tests/test_torch_spatial_branches.py's run on rank ``rank`` of a
    (1, ``world``) layout, or in one process when ``url`` is None: every
    model case through ``spatial_case`` (cfg, weights, batch, loss
    keywords), then the loss-level ``loss_units``, and the refusal of the
    voxel Lovasz term, by message."""
    from stereoscene_torch.engine.train import LossConfig, compute_losses

    out = {name: spatial_case(rank, world, url, world, *args)
           for name, args in cases.items()}
    out["units"] = loss_units(rank, world, url, units)
    if url is not None:
        try:
            compute_losses({"output_voxels": torch.zeros(1, 4, 8, 4, 20)},
                           {"gt_occ": torch.zeros(1, 16, 16, 8)},
                           LossConfig(voxel_lovasz=1.0, voxel_ohem=1.0,
                                      voxel_dice=1.0, voxel_lga=1.0))
        except ValueError as exc:
            out["refusal"] = str(exc)
    return out
