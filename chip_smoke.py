"""Drive the PyTorch / CUDA port (``stereoscene_torch``) once on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the script exits nonzero:

0. the card: ``torch.cuda.is_available()`` or raise; name and power limit
   as ``nvidia-smi`` reports them;
1. build the hand-written kernels of ``stereoscene_torch/csrc`` with nvcc,
   one process per source, all at once;
2. K1 (fused GWC + depth warp) against its plain PyTorch version at the
   flagship shapes, fp32 and bf16, plus boundary positions; then its
   autograd Function's gradients against plain autograd (fp32, 1e-5);
   its bf16 time as a share of its bound;
3. K3 (fused lift + splat) and K2 (sorted splat) against their plain
   versions on the real group-8 splat plan of the flagship calibration
   (1e-4 of max|ref|), two launches of each bitwise equal; the chunk
   size, the number of chunks, of voxels across chunks and of their
   partial sums, the longest voxel; K3 timed beside ``F.embedding_bag``
   over the same plan (held to the same tolerance), K2 beside
   ``index_add_``, each as a share of its bound; K3 with fp32 tables
   (eval's dtype: the kernels-line entry, as in earlier PRs) and bf16
   tables (serving's dtype; held to the plain version and to the kernel
   on their fp32 copies); K3's gathered feature bytes (L2 traffic) and
   their rate at the kernel's time, for each;
4. K4 (implicit-GEMM conv3d) against its plain version at the three
   flagship shapes, fp32 (1e-4 of max|ref|) and bf16 (2e-2 of max|ref|);
   per shape and per forward: bf16 kernel, plain and cuDNN ms, the bound,
   the kernel's share of it and its TFLOP/s;
4b. P1 (the DCN gather) at the flagship DepthNet DCN [1, 48, 160, 640],
   G = 4, with the Pallas probe's offsets (randn * 1.5), the seeded offset
   head's and serving's (the bf16 head output as a permuted NCHW view, read
   in place): the kernel against its plain version (fp32 1e-5, bf16 2e-2
   of max|ref|), two launches bitwise equal, the whole z-gather route
   against the plain gather DCN (fp32, 1e-5), and its autograd Function's
   gradients (x, offsets, weights) against plain autograd (fp32, 1e-5 of
   each gradient's max); timed beside ``F.embedding_bag`` on the corner
   tables (held to the same tolerances); its bare C entry's device time and
   share of the bound;
4c. P2 (the row gather) at the Pallas probe's shapes, feat [7680, 128], for
   the three index layouts [1024, 128], [1024, 1] and [1024]: bitwise
   equal to its plain version; its whole call timed beside
   ``torch.take_along_dim``'s, and its kernel's device time
   (torch.profiler);
5. the flagship forward (EfficientNet-b7, 384x1280, D = 112, the 64x64x8
   grid of 0.8 m voxels) in fp32 with and without the kernels, seeded
   random weights;
6. serving: the bf16 model answers three requests (different images, one
   calibration) through ``BEVDepthOccupancy.infer`` -> [256, 256, 32]
   class maps; per-stage and per-frame milliseconds;
7. training: one synthetic labelled batch from the seed; (a) one fp32 step
   built with the kernels (K1, P1, K4) and one without, losses within 1e-4
   and every gradient leaf within 2% of its scale (floor 1e-4 of the global
   scale); (b) six bf16 steps with the kernels: finite, falling losses, ms
   per step and peak memory;
8. eval: a full-size SemanticKITTI tree (four seeded val frames and four
   train frames: 376x1241 stereo PNGs, calib.txt, voxel labels
   [256, 256, 32] with ignore labels, a 120,000-point velodyne sweep and
   its lidarseg labels per frame) and a checkpoint of the seeded fp32
   flagship, written under TMPDIR; the
   eval CLI ``stereoscene_torch.tools.test.main`` on the card writes the
   ``.label`` / ``.npy`` predictions, then scores; the same checkpoint
   through ``engine.loop.run_evaluation`` without the kernels: predictions
   agree on at least 99.99% of voxels, every ``semkitti_*`` metric within
   0.01 points, each ``.label`` file is ``inv_map`` of its ``.npy``;
   frames per second and ``eval_time_s``, PNG decoding included;
9. training from data: the train CLI ``stereoscene_torch.tools.train.main``
   on the card with the flagship config (B = 2, bf16, two epochs of the
   four train frames, the LiDAR depth branch on), then its eval after
   epoch 2 over the four val frames: the gt_depth pixels per eye and one
   frame's LiDAR products' host ms, every step's loss terms (all finite,
   the depth term nonzero), ms per step, the peak memory, the steps left in
   ``ckpts/``, the launches (K1, P1 and K3 at least once); then the eval
   CLI on ``ckpts/`` gives the loop's eval metrics within 0.01 points.

Then one JSON line with each kernel (its launches in the serving, bf16
training, eval and train CLI runs, each counted from 0 just before its
run, its
error, its times and its bound from phases 2-4c; the
bound is the larger of the bytes it must move over 3.35 TB/s and its
operations over the H100 SXM datasheet's peak for their type, 989 TFLOP/s
bf16 dense, 67 TFLOP/s fp32) and, last, the ok line. Every time is
measured in this run on this card. No JAX is imported.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

SEED = 0
FX, BASELINE = 707.0, 0.54  # bench.py:55-82 flagship calibration
N_REQUESTS = 3
N_TRAIN_STEPS = 6
N_EVAL_FRAMES = 4
N_TRAIN_FRAMES = 4  # sequence 00 of the phase 8-9 tree
N_LIDAR_POINTS = 120_000  # about one HDL-64 sweep
CLI_EPOCHS = 2  # the flagship config evaluates every 2 epochs
LABEL_SHAPE = (256, 256, 32)
EVAL_CONFIG = "stereoscene_semantickitti.py"  # the flagship's config file
# H100 SXM datasheet peaks (dense, without sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the flagship's K4 convs: (Ci, D, H, W, Co) and launches per forward
K4_SHAPES = {"hourglass conv2": ((64, 56, 24, 80, 64), 4),
             "hourglass conv4": ((128, 28, 12, 40, 128), 4),
             "resnet3d stage 1": ((128, 64, 64, 8, 128), 4)}


def cuda_ms(fn, iters: int = 20, reps: int = 1) -> float:
    """Median device time of ``reps`` back-to-back calls of ``fn`` over
    ``iters`` CUDA-event runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, name: str, calls: int = 20):
    """Device ms per call of the kernels whose name holds ``name`` among
    those ``fn`` launches, by torch.profiler over ``calls`` calls after one
    warm-up: a kernel's own time where the call's host side outlasts it.
    None when the profiler records no device time for them."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", 0.0)
             for ev in prof.key_averages() if name in ev.key)
    return us / 1e3 / calls if us else None


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if got.shape != want.shape or not bool((err <= limit).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with plain: shape {tuple(got.shape)} "
            f"vs {tuple(want.shape)}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def flagship_batch(cfg, seed: int, device) -> dict:
    """One stereo frame at the flagship calibration (bench.py:55-82) with
    seeded random images, as the JAX package's batch dict."""
    gen = torch.Generator().manual_seed(seed)
    h, w = cfg.input_size
    intrin = torch.zeros(1, 2, 3, 4)
    intrin[..., 0, 0] = FX
    intrin[..., 1, 1] = FX
    intrin[..., 0, 2] = w / 2.0
    intrin[..., 1, 2] = h / 2.0
    intrin[..., 2, 2] = 1.0
    rot = torch.tensor([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    batch = {
        "imgs": torch.randn(1, 2, h, w, 3, generator=gen),
        "rots": rot.expand(1, 2, 3, 3).clone(),
        "trans": torch.zeros(1, 2, 3),
        "intrins": intrin,
        "post_rots": torch.eye(3).expand(1, 2, 3, 3).clone(),
        "post_trans": torch.zeros(1, 2, 3),
        "bda": torch.eye(3).expand(1, 3, 3).clone(),
        "calib": torch.full((1,), FX * BASELINE),
    }
    return {k: v.to(device) for k, v in batch.items()}


def phase_gwc(cfg, dev, gwc) -> dict:
    """K1 at the flagship: match features [1, fH, fW, 64], G = 32, D = K."""
    from stereoscene_torch.geometry import disparity_positions

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    fh, fw = cfg.feature_size
    d = cfg.num_depth
    left = torch.randn(1, fh, fw, 64, generator=gen, device=dev)
    right = torch.randn(1, fh, fw, 64, generator=gen, device=dev)
    pos = disparity_positions(torch.full((1,), FX * BASELINE, device=dev), d)

    def run(l, r, p, out_dtype, use_kernel):
        return gwc.fused_gwc_warp(l, r, p, d, 32, out_dtype=out_dtype,
                                  use_kernel=use_kernel)

    err32 = check_close("gwc fp32", run(left, right, pos, torch.float32, True),
                        run(left, right, pos, torch.float32, False),
                        1e-5, 1e-5)
    edge = torch.tensor([-1.5, -0.4, 0.0, 0.6, d - 1.0, float(d), 8.2],
                        device=dev)
    edge = torch.cat([edge, pos[0, :d - len(edge)]])[None]
    err_edge = check_close(
        "gwc boundary", run(left, right, edge, torch.float32, True),
        run(left, right, edge, torch.float32, False), 1e-5, 1e-5)
    lb, rb = left.bfloat16(), right.bfloat16()
    err16 = check_close("gwc bf16", run(lb, rb, pos, torch.bfloat16, True),
                        run(lb, rb, pos, torch.bfloat16, False), 2e-2, 2e-2)
    ms = cuda_ms(lambda: run(lb, rb, pos, torch.bfloat16, True))
    plain_ms = cuda_ms(lambda: run(lb, rb, pos, torch.bfloat16, False))
    ms32 = cuda_ms(lambda: run(left, right, pos, torch.float32, True))
    plain_ms32 = cuda_ms(lambda: run(left, right, pos, torch.float32, False))
    out = run(lb, rb, pos, torch.bfloat16, True)
    # two lerp taps of a C-channel product each, then the lerp
    ops = 2 * 2 * out.numel() * left.shape[-1] // 32 + 3 * out.numel()
    k1 = dict(max_abs_err=max(err32, err_edge), ms=ms, plain_ms=plain_ms,
              library_ms=None,
              **bound(nbytes(lb, rb, pos, out), ops, torch.bfloat16))
    print(f"phase 2 K1 gwc_warp [1, {d}, {fh}, {fw}, 32]: max abs err fp32 "
          f"{err32:.3e} boundary {err_edge:.3e} bf16 {err16:.3e}; median of "
          f"20: bf16 kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
          f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}; the kernel at "
          f"{k1['bound_ms'] / ms:.1%} of it), fp32 kernel "
          f"{ms32:.4f} ms plain {plain_ms32:.4f} ms", flush=True)

    g = torch.randn(out.shape, generator=gen, device=dev)
    ins = [t.clone().requires_grad_() for t in (left, right)]
    (run(*ins, pos, torch.float32, True) * g).sum().backward()
    ref = [t.clone().requires_grad_() for t in (left, right)]
    (gwc.gwc_warp_plain(*ref, pos, d, 32) * g).sum().backward()
    errs = [check_close(f"gwc backward d{name}", a.grad, b.grad, 1e-5, 1e-5)
            for name, a, b in zip(("left", "right"), ins, ref)]
    print(f"phase 2 K1 backward (autograd Function, fp32): max abs err "
          f"dleft {errs[0]:.3e} dright {errs[1]:.3e} vs plain autograd",
          flush=True)
    return k1


def splat_library(dp, feat, order, bounds, group):
    """K3's function as one PyTorch call: ``F.embedding_bag`` in sum mode,
    one bag per voxel (rows ``bounds[v] * group`` up to the next voxel's),
    each plan row weighted by its depth probability (0 for pad rows); the
    indices and weights are prepared outside the timed call. Timed, never
    used by the port."""
    p_total = dp.numel()
    od = order.long()
    odc = od.clamp(max=p_total - 1)
    idx = odc % feat.shape[0]
    weights = dp[odc] * (od < p_total)
    offsets = bounds.long() * group
    return lambda: torch.nn.functional.embedding_bag(
        idx, feat, offsets, mode="sum", per_sample_weights=weights,
        include_last_offset=True)


def chunk_partition(bounds, group: int, rows: int, chunk_rows: int) -> dict:
    """How csrc/splat.cu splits a plan: bounds [num_voxels + 1] (voxel v
    owns rows [bounds[v]*group, bounds[v+1]*group)), ``rows`` plan rows in
    chunks of ``chunk_rows``. Per voxel: its ``first`` and ``last`` chunk,
    ``direct`` (its chunk writes it), ``crossing`` (the fix-up adds its
    partials, the tail slot of ``first`` then the head slots of
    ``first + 1 .. last``) and ``empty`` (the fix-up writes zeros); and
    ``n_chunks``, ``n_partials`` and ``longest`` (rows of the longest
    voxel)."""
    b = np.asarray(bounds, np.int64) * group
    begin, end = b[:-1], b[1:]
    empty = end <= begin
    first = begin // chunk_rows
    last = np.where(empty, first, (end - 1) // chunk_rows)
    crossing = ~empty & (last > first)
    return dict(first=first, last=last, empty=empty,
                direct=~empty & ~crossing, crossing=crossing,
                n_chunks=-(-rows // chunk_rows), chunk_rows=chunk_rows,
                n_partials=int((last - first + 1)[crossing].sum()),
                longest=int((end - begin).max(initial=0)))


def splat_inputs(model, cpu_batch, dev) -> dict:
    """Phase 3's inputs: the flagship calibration's group-8 plan (``order``,
    ``bounds``) with seeded fp32 tables ``dp`` [D*fH*fW] and ``feat``
    [fH*fW, C] for K3; for K2 the lifted rows ``vals`` of the group-1 plan
    of the same points, their sorted ranks ``ranks1`` and bounds
    ``bounds1``. The plans depend on the geometry only, not on the
    weights."""
    from stereoscene_torch.ops import splat_plan

    cfg = model.cfg
    nvox = int(np.prod(cfg.grid_shape))
    planned = model.attach_plan(cpu_batch)
    points = model.compute_ranks(cpu_batch)[0].numpy()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    fh, fw = cfg.feature_size
    dp = torch.softmax(torch.randn(cfg.num_depth, fh * fw, generator=gen,
                                   device=dev), 0).reshape(-1)
    feat = torch.randn(fh * fw, cfg.numC_Trans, generator=gen, device=dev)
    order1, rs1 = splat_plan.build_plan(points, nvox, group=1)
    o1 = torch.from_numpy(order1).to(dev).long()
    ranks1 = torch.from_numpy(rs1).to(dev)
    vals = (dp[o1][:, None] * feat[o1 % (fh * fw)]
            * (ranks1 < nvox).float()[:, None])
    return dict(dp=dp, feat=feat, group=cfg.splat_group, nvox=nvox,
                order=planned["splat_order"][0].to(dev),
                bounds=planned["splat_bounds"][0].to(dev),
                ranks8=planned["splat_ranks"][0], points=points, vals=vals,
                ranks1=ranks1, bounds1=splat_plan.plan_bounds(rs1, nvox))


def phase_splat(model, cpu_batch, dev, pool):
    """K3 and K2 on the flagship calibration's real plans."""
    x = splat_inputs(model, cpu_batch, dev)
    dp, feat, order, bounds = x["dp"], x["feat"], x["order"], x["bounds"]
    group, nvox, c = x["group"], x["nvox"], feat.shape[1]
    points = x["points"]

    def fused(use_kernel, tables=(dp, feat)):
        return pool.lift_splat_fused(*tables, order, bounds, group, nvox,
                                     use_kernel=use_kernel)

    want = fused(False)
    scale = float(want.abs().max())
    got = fused(True)
    err3 = check_close("splat fused", got, want, 1e-4 * scale, 0.0)
    if not torch.equal(got, fused(True)):
        raise AssertionError("splat fused: two launches differ")
    library = splat_library(dp, feat, order, bounds, group)
    err3_lib = check_close("splat fused embedding_bag", library(), want,
                           1e-4 * scale, 0.0)
    # serving's dtype: bf16 tables, widened exactly in the kernel
    t16 = (dp.bfloat16(), feat.bfloat16())
    got16 = fused(True, t16)
    want16 = fused(False, t16)
    err3_16 = check_close("splat fused bf16", got16, want16,
                          1e-4 * float(want16.abs().max()), 0.0)
    if not torch.equal(got16, fused(True, t16)):
        raise AssertionError("splat fused bf16: two launches differ")
    # the same sums over their fp32 copies, in another order
    err3_16c = check_close("splat fused bf16 vs fp32 copies", got16,
                           fused(True, tuple(t.float() for t in t16)),
                           1e-4 * float(want16.abs().max()), 0.0)
    # fp32 tables (eval's dtype) make the kernels-line entry, as in
    # earlier PRs; bf16 tables are timed beside them
    ms3, plain3 = cuda_ms(lambda: fused(True)), cuda_ms(lambda: fused(False))
    ms3_16 = cuda_ms(lambda: fused(True, t16))
    lib3 = cuda_ms(library)

    vals, ranks1 = x["vals"], x["ranks1"]

    def sorted_(use_kernel):
        return pool.splat_sorted(vals, ranks1, nvox, use_kernel=use_kernel)

    want2 = sorted_(False)
    got2 = sorted_(True)
    err2 = check_close("splat sorted", got2, want2,
                       1e-4 * float(want2.abs().max()), 0.0)
    if not torch.equal(got2, sorted_(True)):
        raise AssertionError("splat sorted: two launches differ")
    ms2, plain2 = cuda_ms(lambda: sorted_(True)), cuda_ms(
        lambda: sorted_(False))
    overflow = ranks1.long().clamp(max=nvox)  # pad rows -> a dropped bucket
    acc = torch.zeros(nvox + 1, c, device=dev)
    lib2 = cuda_ms(lambda: acc.index_add_(0, overflow, vals))
    rows8 = int((x["ranks8"] < nvox).sum())
    part3 = chunk_partition(x["bounds"].cpu().numpy(), group, len(order),
                            pool.CHUNK_ROWS)
    part2 = chunk_partition(x["bounds1"], 1, len(ranks1), pool.CHUNK_ROWS)
    # K3's live rows: each gathers a feature row from the L2-resident
    # table and takes C multiply-adds
    live = int((order < dp.numel()).sum())
    gathered, gathered16 = live * nbytes(feat[0]), live * nbytes(t16[1][0])
    k3 = dict(max_abs_err=err3, ms=ms3, plain_ms=plain3, library_ms=lib3,
              **bound(nbytes(dp, feat, order, bounds, want), 2 * live * c,
                      torch.float32))
    k2 = dict(max_abs_err=err2, ms=ms2, plain_ms=plain2, library_ms=lib2,
              **bound(nbytes(vals, ranks1, want2), vals.numel(),
                      torch.float32))

    def chunks(part):
        return (f"chunks of {part['chunk_rows']} rows: {part['n_chunks']}, "
                f"{int(part['crossing'].sum())} voxels across chunks with "
                f"{part['n_partials']} partials, {int(part['empty'].sum())} "
                f"empty, longest voxel {part['longest']} rows")

    print(f"phase 3 K3 lift_splat_fused: group-{group} plan of "
          f"{len(order)} rows ({rows8} in voxels = {rows8 // group} groups, "
          f"{int((points < nvox).sum())} in-bounds points) -> [{nvox}, {c}]; "
          f"{chunks(part3)}; max abs err {err3:.3e} (max|ref| {scale:.3e}; "
          f"embedding_bag {err3_lib:.3e}); two launches bitwise equal; "
          f"median of 20, fp32 tables: kernel {ms3:.4f} ms plain "
          f"{plain3:.4f} ms embedding_bag {lib3:.4f} ms bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']}, the kernel at "
          f"{k3['bound_ms'] / ms3:.1%} of it); L2 gather {gathered / 1e6:.1f} "
          f"MB of feature rows from a {nbytes(feat) / 1e6:.2f} MB table, "
          f"{gathered / ms3 / 1e9:.2f} TB/s at the kernel's time; bf16 "
          f"tables (serving's dtype): max abs err {err3_16:.3e} (vs the "
          f"kernel on their fp32 copies {err3_16c:.3e}), bitwise equal "
          f"twice, kernel {ms3_16:.4f} ms, L2 gather {gathered16 / 1e6:.1f} "
          f"MB, {gathered16 / ms3_16 / 1e9:.2f} TB/s | K2 splat_sorted: "
          f"group-1 plan of {len(ranks1)} rows; {chunks(part2)}; max abs err "
          f"{err2:.3e}; two launches bitwise equal; kernel {ms2:.4f} ms "
          f"plain {plain2:.4f} ms index_add_ {lib2:.4f} ms bound "
          f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}, the kernel at "
          f"{k2['bound_ms'] / ms2:.1%} of it)", flush=True)
    return k3, k2


def phase_conv3d(dev, conv3d) -> dict:
    """K4 at the flagship's three conv shapes, fp32 and bf16; times in
    bf16 (the training step's dtype) for the kernel on a channels-last
    input, its plain version and cuDNN's ``F.conv3d`` on channels-last
    tensors, each shape's four launches of a forward timed back to back.
    The kernels-line entry sums the 12 launches of a forward."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    worst, parts, moved, ops = 0.0, [], 0, 0
    torch.backends.cudnn.allow_tf32 = False
    for name, ((ci, d, h, w, co), count) in K4_SHAPES.items():
        x = torch.randn(1, ci, d, h, w, generator=gen, device=dev)
        wt = torch.randn(co, ci, 3, 3, 3, generator=gen, device=dev)
        wt = wt * ci ** -0.5
        errs = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            xd, wd = x.to(dtype), wt.to(dtype)
            want = conv3d.conv3d_s1_plain(xd, wd)
            got = conv3d.conv3d_s1(xd, wd, use_kernel=True)
            errs[dtype] = check_close(
                f"conv3d {name} {dtype}", got, want,
                tol * float(want.float().abs().max()), 0.0)
        xp, wb = x.bfloat16(), wt.bfloat16()
        xb = xp.contiguous(memory_format=torch.channels_last_3d)
        wcl = wb.contiguous(memory_format=torch.channels_last_3d)
        # a forward's `count` launches of the shape back to back, per launch
        ms = cuda_ms(lambda: conv3d.conv3d_s1(xb, wb, use_kernel=True),
                     reps=count) / count
        plain = cuda_ms(lambda: conv3d.conv3d_s1_plain(xp, wb),
                        reps=count) / count
        lib = cuda_ms(lambda: torch.nn.functional.conv3d(xb, wcl, padding=1),
                      reps=count) / count
        y = conv3d.conv3d_s1(xb, wb, use_kernel=True)
        flop = 2 * y.numel() * 27 * ci
        b = bound(nbytes(xb, wb, y), flop, torch.bfloat16)
        for key, value in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib)):
            total[key] += count * value
        moved += count * nbytes(xb, wb, y)
        ops += count * flop
        worst = max(worst, *errs.values())
        parts.append(f"{name} [{ci}->{co} at {d}x{h}x{w}, tile "
                     f"{conv3d.BLOCK_M}x{conv3d.tile_n(co)}] "
                     f"x{count}: max abs err fp32 {errs[torch.float32]:.3e} "
                     f"bf16 {errs[torch.bfloat16]:.3e}; bf16 kernel {ms:.4f} "
                     f"ms ({flop / ms / 1e9:.1f} TFLOP/s, "
                     f"{b['bound_ms'] / ms:.1%} of the bound) plain "
                     f"{plain:.4f} ms cuDNN {lib:.4f} ms "
                     f"({flop / lib / 1e9:.1f} TFLOP/s) bound "
                     f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    total.update(bound(moved, ops, torch.bfloat16))
    print("phase 4 K4 conv3d_s1 (median of 20): " + " | ".join(parts)
          + f" | per forward ({ops / 1e9:.1f} GFLOP): kernel "
          f"{total['ms']:.3f} ms ({ops / total['ms'] / 1e9:.1f} TFLOP/s, "
          f"{total['bound_ms'] / total['ms']:.1%} of the bound, "
          f"{total['ms'] / total['library_ms']:.2f}x cuDNN), cuDNN "
          f"{total['library_ms']:.3f} ms "
          f"({ops / total['library_ms'] / 1e9:.1f} TFLOP/s), plain {total['plain_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms ({total['bound_by']})", flush=True)
    return dict(max_abs_err=worst, **total)


def dcn_library(z, idx, wgt):
    """P1's function as one PyTorch call, ``F.embedding_bag`` in sum mode
    over z's rows with the corner tables as bags of 4 * K samples (the
    weights in z's dtype, as the probe casts them); timed, never used by
    the port."""
    k, n, c = z.shape
    flat = (idx.long() + (torch.arange(k, device=z.device) * n)[None, :, None]
            ).reshape(n, -1)
    table, per_sample = z.reshape(k * n, c), wgt.reshape(n, -1).to(z.dtype)
    return lambda: torch.nn.functional.embedding_bag(
        flat, table, per_sample_weights=per_sample, mode="sum")


def dcn_inputs(model, dev) -> dict:
    """Phase 4b's inputs at the flagship DepthNet DCN: x [1, fH, fW, 640]
    from the seed, the seeded model's tap weights ``taps`` [9, C / G, C]
    and ``groups``; offsets [1, fH, fW, 18] at the Pallas probe's scale
    (``probe``, randn * 1.5), from the seeded offset head (``seeded``, fp32,
    contiguous) and as serving hands them to P1 (``serving``: the bf16
    head's NCHW output seen through ``permute(0, 2, 3, 1)``, not copied);
    z of every tap in bf16 (``zb``) and fp32 (``z32``)."""
    from stereoscene_torch.ops import deform_conv

    dcn = model.img_view_transformer.depth_net.depth_conv[4]
    fh, fw = model.cfg.feature_size
    c, groups = dcn.weight.shape[0], dcn.groups
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn(1, fh, fw, c, generator=gen, device=dev)
    taps = (dcn.weight.detach().reshape(c, c // groups, 9).permute(2, 1, 0)
            .contiguous())
    head = dcn.conv_offset
    with torch.no_grad():
        x_nchw = x.permute(0, 3, 1, 2).contiguous()  # as the ASPP hands it
        seeded = head(x_nchw).permute(0, 2, 3, 1)
        serving = torch.nn.functional.conv2d(
            x_nchw.bfloat16(), head.weight.bfloat16(),
            head.bias.bfloat16(), padding=1).permute(0, 2, 3, 1)
    offsets = {"probe": torch.randn(1, fh, fw, 18, generator=gen,
                                    device=dev) * 1.5,
               "seeded": seeded.contiguous(), "serving": serving}
    return dict(x=x, taps=taps, groups=groups, offsets=offsets,
                zb=deform_conv.dcn_z(x.bfloat16(), taps.bfloat16(), groups),
                z32=deform_conv.dcn_z(x, taps, groups))


def phase_dcn(model, dev, deform_conv) -> dict:
    """P1 at the flagship DepthNet DCN: x [1, fH, fW, 640], G = 4, the
    seeded model's tap weights; offsets at the probe's scale, from the
    seeded offset head and as serving hands them (bf16, permuted). Times in
    bf16 (serving's dtype); the kernels-line entry takes the seeded fp32
    offsets, as earlier PRs timed it."""
    from stereoscene_torch import _build

    inputs = dcn_inputs(model, dev)
    x, taps, groups = inputs["x"], inputs["taps"], inputs["groups"]
    offsets, zb, z32 = inputs["offsets"], inputs["zb"], inputs["z32"]
    fh, fw, c = x.shape[1:]
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs = {}
    for name, off in offsets.items():
        idx, wgt = deform_conv.dcn_corner_tables(off, fh, fw)
        for z, tol in ((z32, 1e-5), (zb, 2e-2)):
            want = deform_conv.dcn_gather_plain(z, off)
            limit = tol * float(want.float().abs().max())
            got = deform_conv.dcn_gather_kernel(z, off)
            errs[name, z.dtype] = check_close(
                f"dcn gather {name} {z.dtype}", got, want, limit, 0.0)
            if not torch.equal(got, deform_conv.dcn_gather_kernel(z, off)):
                raise AssertionError(f"dcn gather {name} {z.dtype}: two "
                                     "launches differ")
            errs[name, z.dtype, "library"] = check_close(
                f"dcn embedding_bag {name} {z.dtype}",
                dcn_library(z, idx, wgt)(), want, limit, 0.0)
        with torch.no_grad():
            want = deform_conv.deform_conv2d_plain(x, off, taps, groups)
            errs[name, "route"] = check_close(
                f"dcn route {name}",
                deform_conv.deform_conv2d(x, off, taps, groups,
                                          use_kernel=True),
                want, 1e-5 * float(want.abs().max()), 0.0)

    g = torch.randn(1, fh, fw, c, generator=gen, device=dev)
    ins = [t.clone().requires_grad_() for t in (x, offsets["probe"], taps)]
    (deform_conv.deform_conv2d(*ins, groups, use_kernel=True) * g).sum() \
        .backward()
    ref = [t.clone().requires_grad_() for t in (x, offsets["probe"], taps)]
    (deform_conv.deform_conv2d_plain(*ref, groups) * g).sum().backward()
    grad_errs = [check_close(f"dcn backward d{n}", a.grad, b.grad,
                             1e-5 * float(b.grad.abs().max()), 0.0)
                 for n, a, b in zip(("x", "offsets", "weights"), ins, ref)]
    if float(ins[1].grad.abs().max()) == 0.0:
        raise AssertionError("dcn backward: zero offset gradient")
    del ins, ref, g

    off, serving = offsets["seeded"], offsets["serving"]
    idx, wgt = deform_conv.dcn_corner_tables(off, fh, fw)
    xb, tb = x.bfloat16(), taps.bfloat16()
    ms = cuda_ms(lambda: deform_conv.dcn_gather_kernel(zb, off))
    ms_serving = cuda_ms(lambda: deform_conv.dcn_gather_kernel(zb, serving))
    plain = cuda_ms(lambda: deform_conv.dcn_gather_plain(zb, off))
    lib = cuda_ms(dcn_library(zb, idx, wgt))
    ms32 = cuda_ms(lambda: deform_conv.dcn_gather_kernel(z32, off))
    lib32 = cuda_ms(dcn_library(z32, idx, wgt))
    zms = cuda_ms(lambda: deform_conv.dcn_z(xb, tb, groups))
    with torch.no_grad():
        route = cuda_ms(lambda: deform_conv.deform_conv2d(
            xb, off, tb, groups, use_kernel=True))
        route_plain = cuda_ms(lambda: deform_conv.deform_conv2d_plain(
            xb, off, tb, groups))
    out = deform_conv.dcn_gather_kernel(zb, off)
    # the bare C entry, 20 calls back to back: device time without the
    # wrapper's host side
    bare, entry = {}, _build.load_kernels().stereoscene_dcn_gather
    stream = _build.stream_ptr(dev)
    for name, o in (("seeded", off), ("serving", serving)):
        args = deform_conv.dcn_gather_args(zb, o)
        bare[name] = cuda_ms(lambda: _build.check(entry(
            zb.data_ptr(), o.data_ptr(), out.data_ptr(), *args, stream),
            "stereoscene_dcn_gather"), reps=20) / 20
    # z, the offsets and the output; 36 fp32 multiply-adds per output value
    moved = nbytes(zb, off, out)
    p1 = dict(max_abs_err=max(v for k, v in errs.items()
                              if k[1] == torch.float32 and len(k) == 2),
              ms=ms, plain_ms=plain, library_ms=lib,
              **bound(moved, 2 * 36 * out.numel(), torch.float32))
    share = p1["bound_ms"] / bare["seeded"]
    print(f"phase 4b P1 dcn_gather [1, {fh}, {fw}, {c}] G {groups}: max abs "
          f"err kernel vs plain fp32 probe {errs['probe', torch.float32]:.3e} "
          f"seeded {errs['seeded', torch.float32]:.3e} serving "
          f"{errs['serving', torch.float32]:.3e}, bf16 probe "
          f"{errs['probe', torch.bfloat16]:.3e} seeded "
          f"{errs['seeded', torch.bfloat16]:.3e} serving (bf16 offsets, "
          f"permuted NCHW view) {errs['serving', torch.bfloat16]:.3e}; two "
          f"launches bitwise equal for each; embedding_bag vs plain fp32 "
          f"{errs['seeded', torch.float32, 'library']:.3e} bf16 "
          f"{errs['seeded', torch.bfloat16, 'library']:.3e}; route vs plain "
          f"gather DCN fp32 probe {errs['probe', 'route']:.3e} seeded "
          f"{errs['seeded', 'route']:.3e} serving "
          f"{errs['serving', 'route']:.3e}; backward dx {grad_errs[0]:.3e} "
          f"doffsets {grad_errs[1]:.3e} dweights {grad_errs[2]:.3e}; median "
          f"of 20, bf16: kernel {ms:.4f} ms (serving offsets {ms_serving:.4f}"
          f" ms) plain {plain:.4f} ms embedding_bag {lib:.4f} ms bound "
          f"{p1['bound_ms']:.4f} ms ({p1['bound_by']}, {moved / 1e6:.1f} MB);"
          f" bare C entry (20 back to back) {bare['seeded']:.4f} ms, "
          f"{share:.1%} of the bound (serving offsets "
          f"{bare['serving']:.4f} ms); fp32: kernel {ms32:.4f} ms "
          f"embedding_bag {lib32:.4f} ms; whole DCN bf16: z-gather route "
          f"{route:.4f} ms (z {zms:.4f} ms), plain gather DCN "
          f"{route_plain:.4f} ms", flush=True)
    return p1


def take_rows_inputs(dev) -> tuple:
    """Phase 4c's inputs, the Pallas probe's shapes: feat [7680, 128] fp32
    and int32 indices for each of the three layouts, [1024, 128] per
    element, [1024, 1] per row and [1024] flat -> (feat, {layout: idx})."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows, c, m = 7680, 128, 1024
    feat = torch.randn(rows, c, generator=gen, device=dev)
    layouts = {name: torch.randint(0, rows, shape, generator=gen, device=dev,
                                   dtype=torch.int32)
               for name, shape in (("per element", (m, c)),
                                   ("per row", (m, 1)), ("flat", (m,)))}
    return feat, layouts


def phase_take_rows(dev, gather) -> dict:
    """P2 at the probe's shapes for its three index layouts; the
    kernels-line entry sums the three (one launch each). The bound counts
    the table rows this run's indices touch, not the whole table. The
    kernel's own device time comes from torch.profiler: a call's host side
    outlasts it."""
    feat, layouts = take_rows_inputs(dev)
    (rows, c), m = feat.shape, layouts["flat"].shape[0]
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    moved, parts = 0, []
    for name, idx in layouts.items():
        shape = tuple(idx.shape)
        got = gather.take_along_rows(feat, idx, use_kernel=True)
        want = gather.take_along_rows(feat, idx, use_kernel=False)
        idx64 = idx.long().reshape(m, -1)
        lib_out = torch.take_along_dim(feat, idx64, dim=0)
        if not (torch.equal(got, want) and torch.equal(lib_out, want)):
            raise AssertionError(f"take_rows {name}: not bitwise equal")
        ms = cuda_ms(lambda: gather.take_along_rows(feat, idx,
                                                    use_kernel=True))
        plain = cuda_ms(lambda: gather.take_along_rows(feat, idx,
                                                       use_kernel=False))
        lib = cuda_ms(lambda: torch.take_along_dim(feat, idx64, dim=0))
        device = kernel_ms(lambda: gather.take_along_rows(feat, idx),
                           "take_rows")
        if idx64.shape[1] == 1:
            touched = int(torch.unique(idx64).numel()) * c * 4
        else:  # distinct (row, column) elements
            cols = torch.arange(c, device=dev)
            touched = int(torch.unique(idx64 * c + cols).numel()) * 4
        b = nbytes(idx, got) + touched
        moved += b
        for key, value in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib)):
            total[key] += value
        kernel = "not measured" if device is None else f"{device:.4f} ms"
        parts.append(f"{name} idx {list(shape)}: whole call {ms:.4f} ms "
                     f"(the kernel's device time {kernel}) plain "
                     f"{plain:.4f} ms take_along_dim {lib:.4f} ms, "
                     f"{b / 1e6:.2f} MB")
    total.update(bound(moved, 0, torch.float32))
    print(f"phase 4c P2 take_rows feat [{rows}, {c}] -> [{m}, {c}], bitwise "
          f"equal to plain in all three layouts (median of 20): "
          + " | ".join(parts) + f" | sum bound {total['bound_ms']:.5f} ms "
          "(bytes; launch latency dominates at this size)", flush=True)
    return dict(max_abs_err=0.0, **total)


def lidar_scan(rng, n: int, raw_ids) -> tuple:
    """A seeded velodyne sweep of ``n`` points (x forward, y left, z up,
    reflectance; float32 [n, 4]) and its lidarseg labels (uint32: a raw id
    of ``raw_ids`` below an instance id). 80% lie in the camera's view (3-58
    m ahead, |y| < 0.85 x, |z| < 0.25 x); 10% repeat some of those 1.05-1.6x
    farther along the same ray, so several points land on one pixel; 10%
    lie anywhere within 60 m, behind the car and outside the image
    included."""
    n_dup = n_out = n // 10
    n_in = n - n_dup - n_out
    x = rng.uniform(3.0, 58.0, n_in)
    seen = np.stack([x, x * rng.uniform(-0.85, 0.85, n_in),
                     x * rng.uniform(-0.25, 0.25, n_in)], axis=1)
    dup = seen[rng.integers(0, n_in, n_dup)] * rng.uniform(1.05, 1.6,
                                                           (n_dup, 1))
    out = np.stack([rng.uniform(-60.0, 60.0, n_out),
                    rng.uniform(-60.0, 60.0, n_out),
                    rng.uniform(-3.0, 3.0, n_out)], axis=1)
    xyz = np.concatenate([seen, dup, out])
    pts = np.concatenate([xyz, rng.random((n, 1))], axis=1)
    labels = (rng.choice(raw_ids, n).astype(np.uint32)
              | (rng.integers(0, 64, n).astype(np.uint32) << 16))
    return pts.astype(np.float32), labels


def write_semkitti_tree(root: str, n_frames: int, n_train: int) -> tuple:
    """A SemanticKITTI tree at full size under ``root``: sequence 08 (the
    val split) with ``n_frames`` frames and sequence 00 (train) with
    ``n_train``: seeded 376x1241 stereo PNG pairs, a calib.txt of the
    flagship calibration (fx 707, baseline 0.54 m, the velodyne axes of
    bench.py's rotation), ``voxels/*.bin`` frame markers, voxel labels
    [256, 256, 32] uint8 (60% empty, 10% ignore 255), and per frame a
    ``velodyne/*.bin`` sweep of ``N_LIDAR_POINTS`` points (an HDL-64
    sweep's size) with its ``labels/*.label`` lidarseg file
    -> (data_root, ann_file, lidar_root), the lidar root also the lidarseg
    root."""
    from PIL import Image

    from stereoscene_torch.data.labels import LEARNING_MAP

    lidar_root = os.path.join(root, "dataset", "sequences")
    ann = os.path.join(root, "labels")
    p2 = f"{FX} 0 620.5 0 0 {FX} 188.0 0 0 0 1 0"
    p3 = f"{FX} 0 620.5 {-FX * BASELINE} 0 {FX} 188.0 0 0 0 1 0"
    rng = np.random.default_rng(SEED + 100)
    ramp = np.linspace(0, 160, 1241)[None, :, None]
    for seq_id, count in (("08", n_frames), ("00", n_train)):
        seq = os.path.join(lidar_root, seq_id)
        for sub in ("image_2", "image_3", "voxels", "velodyne", "labels"):
            os.makedirs(os.path.join(seq, sub))
        os.makedirs(os.path.join(ann, seq_id))
        with open(os.path.join(seq, "calib.txt"), "w") as f:
            f.write(f"P0: {p2}\nP1: {p3}\nP2: {p2}\nP3: {p3}\n"
                    "Tr: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        for i in range(count):
            fid = f"{i:06d}"
            for cam in ("image_2", "image_3"):
                img = ramp + rng.integers(0, 96, (376, 1241, 3))
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(seq, cam, fid + ".png"))
            with open(os.path.join(seq, "voxels", fid + ".bin"), "wb") as f:
                f.write(b"\0")
            occ = rng.integers(1, 20, LABEL_SHAPE)
            occ[rng.random(LABEL_SHAPE) < 0.6] = 0
            occ[rng.random(LABEL_SHAPE) < 0.1] = 255
            np.save(os.path.join(ann, seq_id, f"{fid}_1_1.npy"),
                    occ.astype(np.uint8))
            pts, labels = lidar_scan(rng, N_LIDAR_POINTS,
                                     sorted(LEARNING_MAP))
            pts.tofile(os.path.join(seq, "velodyne", fid + ".bin"))
            labels.tofile(os.path.join(seq, "labels", fid + ".label"))
    return root, ann, lidar_root


def phase_eval(dev, build, card: str, seeded_init_, tmp: str,
               tree: tuple) -> dict:
    """The eval CLI (``stereoscene_torch.tools.test.main``) on the card
    over the full-size SemanticKITTI ``tree``, with a seeded checkpoint
    written under ``tmp``: once writing predictions, once scoring; then the
    same checkpoint through ``run_evaluation`` without the kernels. Returns
    the launches of the scoring run."""
    import stereoscene_torch
    from stereoscene_torch.config import Config, merge_from_options
    from stereoscene_torch.data.labels import inv_map
    from stereoscene_torch.engine.eval import make_eval_step
    from stereoscene_torch.engine.loop import run_evaluation
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.tools import test as cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                          "configs", EVAL_CONFIG)
    t0 = time.perf_counter()
    root, ann, _ = tree
    opts = [f"data.val.data_root={root}", f"data.val.ann_file={ann}"]
    cfg = Config.fromfile(config)
    merge_from_options(cfg, opts)
    model = BEVDepthOccupancy(DetectorConfig.from_config(cfg),
                              device=dev, label_shape=LABEL_SHAPE)
    seeded_init_(model, SEED)
    ckpt = os.path.join(tmp, "seeded.pth")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    setup_s = time.perf_counter() - t0
    argv = [config, "--checkpoint", ckpt, "--device", dev.type]
    sub, pred_dir = os.path.join(tmp, "submission"), os.path.join(
        tmp, "pred")
    cli.main(argv + ["--submission-dir", sub, "--save-pred-dir",
                     pred_dir, "--cfg-options", *opts])
    build.launch_counts.clear()
    res_k = cli.main(argv + ["--cfg-options", *opts])
    launches = dict(build.launch_counts)

    index, loader = cli.make_loader(cfg, "val", 1)
    eval_step, preds = make_eval_step(LABEL_SHAPE), []

    def step(model, batch, state, use_kernel=None):
        pred, state = eval_step(model, batch, state, use_kernel)
        preds.append(pred.to(torch.uint8).cpu().numpy())
        return pred, state

    build.launch_counts.clear()
    res_p = run_evaluation(model, step, loader, use_kernel=False,
                           progress=False)
    if build.launch_counts:
        raise AssertionError(f"eval without kernels launched "
                             f"{dict(build.launch_counts)}")
    pred_p = np.concatenate(preds)
    lut, pred_k = inv_map(), []
    for frame in index.frames:
        name = f"{frame.sequence}_{frame.frame_id}"
        pred_k.append(np.load(os.path.join(pred_dir, name + ".npy")))
        raw = np.fromfile(os.path.join(
            sub, "sequences", frame.sequence, "predictions",
            frame.frame_id + ".label"), np.uint16)
        if raw.size != int(np.prod(LABEL_SHAPE)) or not np.array_equal(
                raw, lut[pred_k[-1].reshape(-1)]):
            raise AssertionError(f"eval .label file of {name}: "
                                 f"{raw.size} values, not the inv_map "
                                 "of its .npy prediction")
    pred_k = np.stack(pred_k)
    if res_k["eval_frames"] != N_EVAL_FRAMES or pred_k.shape != (
            N_EVAL_FRAMES,) + LABEL_SHAPE or pred_p.shape != pred_k.shape:
        raise AssertionError(f"eval: {res_k['eval_frames']} frames, "
                             f"predictions {pred_k.shape} / {pred_p.shape}")
    agree = float((pred_k == pred_p).mean())
    diffs = {k: abs(res_k[k] - res_p[k]) for k in res_k
             if k.startswith("semkitti_")}
    bad = {k: v for k, v in diffs.items() if not v <= 0.01
           and not (math.isnan(res_k[k]) and math.isnan(res_p[k]))}
    if agree < 0.9999 or bad:
        raise AssertionError(f"eval kernels vs plain: voxel agreement "
                             f"{agree:.6f} (limit 0.9999), metrics off by "
                             f"more than 0.01: {bad}")
    keys = ("semkitti_SC_IoU", "semkitti_SSC_mIoU")
    print(f"phase 8 fp32 eval CLI on {card}: {N_EVAL_FRAMES} frames of "
          f"376x1241 stereo PNGs -> {cfg['data_config']['input_size']}, "
          f"gt_occ {list(LABEL_SHAPE)} (checkpoint written in "
          f"{setup_s:.1f} s); tools.test.main with the kernels eval_time_s "
          f"{res_k['eval_time_s']:.3f} "
          f"({N_EVAL_FRAMES / res_k['eval_time_s']:.3f} frames/s), "
          f"run_evaluation without {res_p['eval_time_s']:.3f} "
          f"({N_EVAL_FRAMES / res_p['eval_time_s']:.3f} frames/s), loading "
          f"and decoding included; voxel agreement {agree:.6f}; "
          f"{', '.join(f'{k} {res_k[k]}' for k in keys)}; largest metric "
          f"difference {max(diffs.values()):.4f} points; {N_EVAL_FRAMES} "
          f".label files equal to inv_map of the .npy predictions; launches "
          f"{launches}", flush=True)
    return launches


def phase_train_cli(dev, build, card: str, tmp: str, tree: tuple) -> dict:
    """The train CLI (``stereoscene_torch.tools.train.main``) on the card:
    the flagship config at its ``samples_per_gpu`` (B = 2) in bf16 for
    ``CLI_EPOCHS`` epochs over the tree's train frames with LiDAR depth,
    then the loop's eval over the val frames; then the eval CLI on the
    run's ``ckpts/``. Returns the launches of the training run, its eval
    included."""
    import stereoscene_torch
    from stereoscene_torch.config import Config, merge_from_options
    from stereoscene_torch.data import (
        PipelineConfig,
        SemanticKittiIndex,
        SemanticKittiPipeline,
    )
    from stereoscene_torch.engine.checkpoint import CheckpointManager
    from stereoscene_torch.engine.loop import to_device
    from stereoscene_torch.tools import test as test_cli
    from stereoscene_torch.tools import train as train_cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                          "configs", EVAL_CONFIG)
    root, ann, lidar_root = tree
    val_opts = [f"data.val.data_root={root}", f"data.val.ann_file={ann}"]
    opts = val_opts + [
        f"data.train.data_root={root}", f"data.train.ann_file={ann}",
        f"lidar_root={lidar_root}", f"lidarseg_root={lidar_root}"]
    cfg = Config.fromfile(config)
    merge_from_options(cfg, list(opts))

    # one train frame's LiDAR products, as the CLI's pipeline makes them
    dcfg = cfg["data_config"]
    pipe = SemanticKittiPipeline(PipelineConfig(
        input_size=tuple(dcfg["input_size"]), resize=tuple(dcfg["resize"]),
        rot=tuple(dcfg["rot"]), flip=dcfg["flip"],
        crop_h=tuple(dcfg["crop_h"]), is_train=True, load_lidar_depth=True,
        point_cloud_range=tuple(cfg["point_cloud_range"])))
    frame = SemanticKittiIndex(data_root=root, ann_file=ann, split="train",
                               lidar_root=lidar_root,
                               lidarseg_root=lidar_root).frames[0]
    sample = pipe(frame, seed=SEED)
    hits = [int((sample["gt_depth"][eye] > 0).sum()) for eye in range(2)]
    lidar_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe._lidar_products(frame, sample)
        lidar_ms.append((time.perf_counter() - t0) * 1e3)
    if min(hits) < N_LIDAR_POINTS // 2:
        raise AssertionError(f"LiDAR products: gt_depth pixels per eye "
                             f"{hits} of {N_LIDAR_POINTS} points")

    steps, peaks = [], []

    def record(state, epoch, it, logs):
        steps.append({k: float(v) for k, v in logs.items()})
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)

    work_dir = os.path.join(tmp, "train_cli")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    state = train_cli.main(
        [config, "--work-dir", work_dir, "--device", dev.type, "--bf16",
         "--profile", "--max-epochs", str(CLI_EPOCHS), "--cfg-options",
         *opts],
        hooks=[record])
    run_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)

    batch_size = cfg["data"]["samples_per_gpu"]
    n_steps = CLI_EPOCHS * (N_TRAIN_FRAMES // batch_size)
    if len(steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"train CLI: {len(steps)} steps logged, state "
                             f"step {state.step}, want {n_steps}")
    for i, logs in enumerate(steps):
        if not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"train CLI step {i}: {logs}")
        if not logs.get("loss_depth", 0.0) > 0.0:
            raise AssertionError(f"train CLI step {i}: no depth loss {logs}")
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        evals = [r["eval"] for r in map(json.loads, f) if "eval" in r]
    if len(evals) != 1 or evals[0]["eval_frames"] != N_EVAL_FRAMES:
        raise AssertionError(f"train CLI: evals {evals}")
    for name in ("gwc_warp", "dcn_gather", "lift_splat_fused"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"train CLI: {name} never launched "
                                 f"({launches})")
    ckpts = os.path.join(work_dir, "ckpts")
    left = sorted(os.listdir(ckpts))
    latest = CheckpointManager(ckpts).latest_step
    saved = torch.load(os.path.join(ckpts, f"{latest}.pth"),
                       map_location="cpu", weights_only=True)["state_dict"]
    trained = state.model.state_dict()
    if latest != n_steps or saved.keys() != trained.keys() or not all(
            torch.equal(saved[k], trained[k].cpu()) for k in saved):
        raise AssertionError(f"train CLI: ckpts/ step {latest} does not "
                             "hold the trained weights")
    bad = [k for k, v in trained.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    # the trained model on the first val frame, as the loop's eval runs it
    state.model.eval()
    batch = to_device(next(iter(test_cli.make_loader(cfg, "val", 1)[1])), dev)
    logits = state.model(batch)["output_voxels"].float()
    if bad or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"train CLI: non-finite trained tensors {bad[:5]}"
                             f" or eval logits")
    empty = float((logits.argmax(-1) == 0).float().mean())
    del saved, trained, state, batch, logits

    build.launch_counts.clear()
    res = test_cli.main([config, "--checkpoint", ckpts, "--device", dev.type,
                         "--cfg-options", *val_opts])
    loop = evals[0]
    diffs = {k: abs(res[k] - loop[k]) for k in loop
             if k.startswith("semkitti_")}
    largest = max((v for v in diffs.values() if not math.isnan(v)),
                  default=0.0)
    bad = {k: v for k, v in diffs.items() if not v <= 0.01
           and not (math.isnan(res[k]) and math.isnan(loop[k]))}
    if len(diffs) < 20 or bad:
        raise AssertionError(f"eval CLI on ckpts vs the loop's eval: off by "
                             f"more than 0.01 points: {bad}")
    ms = [logs["step_time_s"] * 1e3 for logs in steps]
    terms = [{k: round(v, 5) for k, v in logs.items()
              if k.startswith("loss")} for logs in steps]
    print(f"phase 9 bf16 train CLI on {card}: {EVAL_CONFIG} B = "
          f"{batch_size}, {CLI_EPOCHS} epochs of {N_TRAIN_FRAMES} frames "
          f"with {N_LIDAR_POINTS}-point LiDAR sweeps; gt_depth pixels per "
          f"eye {hits} (points_count {int(sample['points_count'])}), one "
          f"frame's LiDAR products on the host "
          f"{statistics.median(lidar_ms):.2f} ms (median of 5; samples "
          f"{', '.join(f'{t:.2f}' for t in lidar_ms)}); losses per step "
          f"{terms}; ms per step {statistics.median(ms[1:]):.1f} (median of "
          f"the last {n_steps - 1}; samples "
          f"{', '.join(f'{t:.1f}' for t in ms)}); peak memory in training "
          f"{max(peaks):.2f} GiB; whole run {run_s:.1f} s; ckpts/ holds "
          f"{left}, the latest equal to the trained weights; the trained "
          f"model's fp32 logits on val frame 0 finite, {empty:.4f} of the "
          f"voxel grid predicted empty; eval CLI on "
          f"ckpts vs the loop's eval: largest metric difference "
          f"{largest:.4f} points over {len(diffs)} metrics "
          f"({sum(math.isnan(v) for v in diffs.values())} NaN in both), "
          f"semkitti_SC_IoU "
          f"{res['semkitti_SC_IoU']}, semkitti_SSC_mIoU "
          f"{res['semkitti_SSC_mIoU']}; launches {launches}", flush=True)
    return launches


def phase_fp32_forward(model, batch, build) -> None:
    """Flagship forward in fp32 with and without the kernels."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.launch_counts.clear()
    with_k = model(batch, use_kernel=True)
    counts = dict(build.launch_counts)
    without = model(batch, use_kernel=False)
    torch.cuda.synchronize()
    if any(counts.get(k) != 1 for k in ("gwc_warp", "lift_splat_fused",
                                        "dcn_gather")):
        raise AssertionError(f"fp32 forward launch counts {counts}")
    if build.launch_counts != counts:
        raise AssertionError("use_kernel=False launched a kernel")
    dp_err = max_err(with_k["depth_prob"], without["depth_prob"])
    ref = without["output_voxels"]
    scale = float(ref.abs().max())
    logit_err = max_err(with_k["output_voxels"], ref) / scale
    for name, out in with_k.items():
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"fp32 forward: non-finite {name}")
    if dp_err > 2e-4 or logit_err > 2e-3:
        raise AssertionError(
            f"fp32 forward: kernels vs plain depth_prob {dp_err:.3e} (limit "
            f"2e-4), logits / max|ref| {logit_err:.3e} (limit 2e-3)")
    print(f"phase 5 fp32 flagship forward: output_voxels "
          f"{list(ref.shape)}, depth_prob {list(without['depth_prob'].shape)}"
          f"; kernels vs plain: depth_prob max abs err {dp_err:.3e}, logits "
          f"max abs err / max|ref| {logit_err:.3e}; launches {counts}",
          flush=True)


def phase_serve(model, cfg, dev, build, card: str,
                requests: int = N_REQUESTS) -> tuple:
    """bf16 serving: one warm-up request, then ``requests`` timed ones.
    Returns the kernels' launches and the host ms of the timed requests."""
    torch.backends.cudnn.allow_tf32 = True
    model.to(torch.bfloat16)
    marks = {}

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name] = ev
        return hook

    finite = []
    hooks = [
        model.img_backbone.register_forward_pre_hook(mark("images")),
        model.img_view_transformer.register_forward_pre_hook(mark("view")),
        model.img_bev_encoder_backbone.register_forward_pre_hook(mark("bev")),
        model.pts_bbox_head.register_forward_hook(
            lambda _m, _i, out: finite.append(torch.isfinite(out).all())),
    ]
    batches = [flagship_batch(cfg, SEED + 10 + i, dev)
               for i in range(requests + 1)]
    stages, frames = [], []
    build.launch_counts.clear()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        classes = model.infer(batch)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        if classes.shape != (1, 256, 256, 32):
            raise AssertionError(f"request {i}: class map {classes.shape}")
        lo, hi = int(classes.min()), int(classes.max())
        if lo < 0 or hi >= cfg.out_channel:
            raise AssertionError(f"request {i}: classes in [{lo}, {hi}]")
        if i:  # request 0 is the warm-up
            frames.append(frame_ms)
            stages.append((
                marks["images"].elapsed_time(marks["view"]),
                marks["view"].elapsed_time(marks["bev"]),
                marks["bev"].elapsed_time(end)))
    launches = dict(build.launch_counts)
    for h in hooks:
        h.remove()
    if not all(bool(f) for f in finite):
        raise AssertionError("serving: non-finite logits")
    if model.plan_cache.misses != 1:
        raise AssertionError(
            f"serving: {model.plan_cache.misses} plans built for one "
            "calibration")
    med = [statistics.median(s[j] for s in stages) for j in range(3)]
    print(f"phase 6 bf16 serving on {card}: {requests} requests (+1 "
          f"warm-up) {cfg.input_size[0]}x{cfg.input_size[1]} stereo -> "
          f"[256, 256, 32] class maps in "
          f"[0, {cfg.out_channel}); median device ms images {med[0]:.3f} "
          f"view {med[1]:.3f} bev+upsample+argmax {med[2]:.3f}; host ms per "
          f"frame {statistics.median(frames):.3f} "
          f"(samples {', '.join(f'{f:.3f}' for f in frames)}); plan cache "
          f"hits {model.plan_cache.hits} misses {model.plan_cache.misses}; "
          f"launches {launches}", flush=True)
    return launches, frames


def train_batch(cfg, seed: int, dev) -> dict:
    """The flagship frame with seeded labels: gt_occ [1, 256, 256, 32] in
    [0, 20) with 10% ignore (255), and a sparse LiDAR-like gt_depth
    [1, 1, 384, 1280] (7% of pixels, depths in the model's range)."""
    gen = torch.Generator().manual_seed(seed)
    batch = flagship_batch(cfg, seed, "cpu")
    occ = torch.randint(0, 20, (1, 256, 256, 32), generator=gen)
    ignore = torch.rand(occ.shape, generator=gen) < 0.1
    batch["gt_occ"] = torch.where(ignore, 255, occ).to(torch.int32)
    h, w = cfg.input_size
    hit = torch.rand(1, 1, h, w, generator=gen) < 0.07
    lo, hi, _ = cfg.dbound
    depth = lo + (hi - lo) * torch.rand(1, 1, h, w, generator=gen)
    batch["gt_depth"] = depth * hit
    return {k: v.to(dev) for k, v in batch.items()}


def phase_train(cfg, dev, build, train, seeded_init_, model_cls) -> dict:
    """(a) fp32 loss and gradients with the kernels and without; (b) six
    bf16 steps with the kernels. Returns the launches of (b)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    loss_cfg = train.LossConfig()
    batch = train_batch(cfg, SEED + 20, dev)
    runs = []
    for kernels in (True, False):
        model = model_cls(cfg, conv3d_kernel=kernels)
        seeded_init_(model, SEED)
        state = train.create_train_state(model)
        build.launch_counts.clear()
        total, losses, grads = train.loss_and_grads(
            state, batch, loss_cfg, use_kernel=kernels,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        runs.append((total, losses, grads, dict(build.launch_counts),
                     [n for n, _ in state.trainable]))
        del model, state
    (tk, lk, gk, ck, names), (tp, lp, gp, cp, _) = runs
    if (ck.get("gwc_warp") != 1 or ck.get("dcn_gather") != 1
            or ck.get("conv3d_s1", 0) < 12 or cp):
        raise AssertionError(f"fp32 step launches: kernels {ck}, plain {cp}")
    if not (torch.isfinite(tk)
            and abs(float(tk - tp)) <= 1e-4 * abs(float(tp))):
        raise AssertionError(f"fp32 step: loss {float(tk)} with the kernels, "
                             f"{float(tp)} without")
    scale = max(float(g.abs().max()) for g in gp)
    bad = []
    for name, a, b in zip(names, gk, gp):
        leaf = max(float(a.abs().max()), float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        if not (math.isfinite(err) and err <= max(2e-2 * leaf, 1e-4 * scale)):
            bad.append((name, err / leaf))
    if bad:
        worst = sorted(bad, key=lambda b: -b[1])[:5]
        raise AssertionError(f"fp32 step: {len(bad)} of {len(names)} grad "
                             f"leaves off, worst {worst}")
    terms = {k: round(float(v), 5) for k, v in lk.items()}
    print(f"phase 7a fp32 train step, kernels vs plain: loss {float(tk):.6f} "
          f"vs {float(tp):.6f} ({terms}); "
          f"{len(names)} grad leaves within 2% (floor {1e-4 * scale:.2e}); "
          f"launches {ck}", flush=True)
    del runs, gk, gp

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    model = model_cls(cfg, conv3d_kernel=True)
    seeded_init_(model, SEED)
    state = train.create_train_state(model)
    step = train.make_train_step(loss_cfg, bf16=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    build.launch_counts.clear()
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        # the same dropout and drop-path masks every step: one batch, so
        # the loss must fall
        state, logs = step(state, batch,
                           torch.Generator(device=dev).manual_seed(SEED))
        losses.append(float(logs["loss_total"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"bf16 steps: losses {losses}")
    per_step = {k: v / N_TRAIN_STEPS for k, v in launches.items()}
    if (per_step.get("gwc_warp") != 1 or per_step.get("dcn_gather") != 1
            or per_step.get("conv3d_s1", 0) < 12):
        raise AssertionError(f"bf16 steps: launches {launches}")
    print(f"phase 7b bf16 training, {N_TRAIN_STEPS} steps of B = 1 at "
          f"{cfg.input_size[0]}x{cfg.input_size[1]}, EfficientNet-"
          f"{cfg.backbone_arch} with_cp {cfg.backbone_with_cp}: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; ms per step "
          f"{statistics.median(times[1:]):.1f} (median of the last "
          f"{N_TRAIN_STEPS - 1}; samples "
          f"{', '.join(f'{t:.1f}' for t in times)}); peak memory {peak:.2f} GiB; launches {launches}", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    from stereoscene_torch import _build
    from stereoscene_torch.engine import train
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.ops import (
        conv3d,
        deform_conv,
        gather,
        gwc,
        voxel_pool,
    )
    from stereoscene_torch.utils.weights import seeded_init_

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    print(f"phase 0 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device_count {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    _build.load_kernels()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "wgmma" in ln]
    nvcc = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds
            else "library already built from these sources")
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({nvcc}); "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    cfg = DetectorConfig(backbone_with_cp=False)
    k1 = phase_gwc(cfg, dev, gwc)

    model = BEVDepthOccupancy(cfg)
    seeded_init_(model, SEED)
    k3, k2 = phase_splat(model, flagship_batch(cfg, SEED, "cpu"), dev,
                         voxel_pool)
    k4 = phase_conv3d(dev, conv3d)
    p1 = phase_dcn(model, dev, deform_conv)
    p2 = phase_take_rows(dev, gather)

    phase_fp32_forward(model, flagship_batch(cfg, SEED, dev), _build)
    serving, _ = phase_serve(model, cfg, dev, _build, card)
    del model
    torch.cuda.empty_cache()

    training = phase_train(DetectorConfig(), dev, _build, train,
                           seeded_init_, BEVDepthOccupancy)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_semkitti_tree(os.path.join(tmp, "semkitti"),
                                   N_EVAL_FRAMES, N_TRAIN_FRAMES)
        evaluation = phase_eval(dev, _build, card, seeded_init_, tmp, tree)
        torch.cuda.empty_cache()
        train_cli = phase_train_cli(dev, _build, card, tmp, tree)
    for path, counts, needs in (
            ("serving", serving, ("gwc_warp", "dcn_gather",
                                  "lift_splat_fused")),
            ("training", training, ("gwc_warp", "dcn_gather", "conv3d_s1")),
            ("eval", evaluation, ("gwc_warp", "dcn_gather",
                                  "lift_splat_fused")),
            ("train CLI", train_cli, ("gwc_warp", "dcn_gather",
                                      "lift_splat_fused"))):
        for name in needs:
            if counts.get(name, 0) < 1:
                raise AssertionError(f"{name} never launched in {path}")
    kernels = [
        dict(name="gwc_warp", source="stereoscene_torch/csrc/gwc_warp.cu",
             replaces="stereoscene_tpu/ops/pallas_gwc.py:144", **k1),
        dict(name="splat_sorted", source="stereoscene_torch/csrc/splat.cu",
             replaces="stereoscene_tpu/ops/pallas_splat.py:95", **k2),
        dict(name="lift_splat_fused",
             source="stereoscene_torch/csrc/splat.cu",
             replaces="stereoscene_tpu/ops/pallas_splat_fused.py:104", **k3),
        dict(name="conv3d_s1", source="stereoscene_torch/csrc/conv3d.cu",
             replaces="stereoscene_tpu/ops/pallas_conv3d.py:102", **k4),
        dict(name="dcn_gather", source="stereoscene_torch/csrc/dcn.cu",
             replaces="tools/probe_pallas_dcn.py:125", **p1),
        dict(name="take_rows", source="stereoscene_torch/csrc/gather.cu",
             replaces="tools/probe_gather.py:27", **p2),
    ]
    for k in kernels:
        k["route"] = "cuda"
        k["launches"] = sum(run.get(k["name"], 0)
                            for run in (serving, training, evaluation,
                                        train_cli))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
