"""Time K1-K4, P1 and P2 of a ``stereoscene_torch`` tree, one bf16 serving
request and its bf16 train step.

Compares two versions of the port on one card: run it once per tree, in
turns (old, new, new, old), inside one command:

    python tools/bench_torch_kernels.py --tree DIR [--label NAME] [--steps 6]

``--tree`` is the root of a checkout (for example an older commit unpacked
with ``git archive``); its ``stereoscene_torch`` is imported. The inputs,
the library calls and the serving loop come from the ``chip_smoke.py`` of
the checkout this script lives in, so every tree is timed by one recipe.
Prints phase 6's line, then one JSON line:

- ``k1_ms``: K1 bf16 at the flagship shapes (left / right [1, 48, 160, 64],
  D = K = 112, G = 32), the whole ``fused_gwc_warp`` call, median of 20
  CUDA-event runs;
- ``k4_ms``: per flagship forward, the bf16 kernel's 12 launches over its
  three conv shapes (channels-last input), each shape's four launches
  timed back to back, median of 20;
  ``k4_cudnn_ms`` the same for cuDNN's channels-last ``F.conv3d``;
- ``k3_ms``: K3 at the flagship calibration's group-8 plan (547,840 rows,
  860,160 depth weights, feat [7680, 128] fp32), the whole
  ``lift_splat_fused`` call, median of 20; ``k3_bf16_ms`` the same with
  bf16 tables (null where the tree's K3 takes fp32 only);
  ``k3_embedding_bag_ms`` the same function as one ``F.embedding_bag``
  call (chip_smoke.py phase 3);
- ``k2_ms``: K2 on the lifted rows of the group-1 plan (456,704 rows of
  128 fp32), the whole ``splat_sorted`` call, median of 20;
  ``k2_index_add_ms`` ``index_add_`` into an overflow bucket;
- ``p1_ms``: P1 bf16 at the flagship DepthNet DCN (z [9, 7680, 640], the
  seeded offset head's fp32 offsets; chip_smoke.py phase 4b), the whole
  ``dcn_gather_kernel`` call, median of 20; ``p1_serving_ms`` the same
  with the offsets as serving hands them (bf16, a permuted NCHW view);
  ``p1_embedding_bag_ms`` the same function as one ``F.embedding_bag``
  call on the corner tables;
- ``p2_ms``: P2's whole ``take_along_rows`` call for each index layout
  (per element, per row, flat; feat [7680, 128], 1,024 rows; phase 4c),
  median of 20; ``p2_take_along_dim_ms`` ``torch.take_along_dim`` on the
  same inputs;
- ``serve_ms``: host ms of a bf16 serving request of ``DetectorConfig()``
  through ``BEVDepthOccupancy.infer`` (chip_smoke.py ``phase_serve``),
  median over ``--requests`` after one warm-up, and its samples;
- ``step_ms``: bf16 train steps of ``DetectorConfig()`` built with
  ``conv3d_kernel=True`` (host wall clock per step; the first step, cuDNN's
  set-up, is left out of the median), and their losses.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX, BASELINE = 707.0, 0.54
K4_SHAPES = ((64, 56, 24, 80, 64), (128, 28, 12, 40, 128),
             (128, 64, 64, 8, 128))  # (Ci, D, H, W, Co), 4 launches each


def load_chip_smoke():
    """The chip_smoke.py of this script's checkout, whichever tree is
    benched: its inputs and its serving loop time every tree alike."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cuda_ms(fn, iters: int = 20, reps: int = 1) -> float:
    """Median over ``iters`` CUDA-event runs of ``reps`` back-to-back
    calls, after one warm-up."""
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


def bench_splats(chip_smoke, voxel_pool, x) -> dict:
    """K3 and K2 on phase 3's inputs ``x`` (``chip_smoke.splat_inputs``),
    beside their library calls; K3 with bf16 tables where the tree takes
    them."""
    def k3(dp, feat):
        return voxel_pool.lift_splat_fused(dp, feat, x["order"], x["bounds"],
                                           x["group"], x["nvox"],
                                           use_kernel=True)

    out = {"k3_ms": cuda_ms(lambda: k3(x["dp"], x["feat"]))}
    dp16, feat16 = x["dp"].bfloat16(), x["feat"].bfloat16()
    try:
        out["k3_bf16_ms"] = cuda_ms(lambda: k3(dp16, feat16))
    except TypeError:  # a tree whose K3 takes fp32 tables only
        out["k3_bf16_ms"] = None
    out["k3_embedding_bag_ms"] = cuda_ms(chip_smoke.splat_library(
        x["dp"], x["feat"], x["order"], x["bounds"], x["group"]))
    out["k2_ms"] = cuda_ms(lambda: voxel_pool.splat_sorted(
        x["vals"], x["ranks1"], x["nvox"], use_kernel=True))
    overflow = x["ranks1"].long().clamp(max=x["nvox"])
    acc = torch.zeros(x["nvox"] + 1, x["vals"].shape[1], device=x["dp"].device)
    out["k2_index_add_ms"] = cuda_ms(
        lambda: acc.index_add_(0, overflow, x["vals"]))
    return out


def bench_gathers(chip_smoke, deform_conv, gather, model, dev) -> dict:
    """P1 on phase 4b's inputs, P2 on phase 4c's, beside their library
    calls."""
    x = chip_smoke.dcn_inputs(model, dev)
    zb, off = x["zb"], x["offsets"]["seeded"]
    idx, wgt = deform_conv.dcn_corner_tables(off, *off.shape[1:3])
    out = {"p1_ms": cuda_ms(lambda: deform_conv.dcn_gather_kernel(zb, off)),
           "p1_serving_ms": cuda_ms(lambda: deform_conv.dcn_gather_kernel(
               zb, x["offsets"]["serving"])),
           "p1_embedding_bag_ms": cuda_ms(chip_smoke.dcn_library(zb, idx,
                                                                  wgt)),
           "p2_ms": [], "p2_take_along_dim_ms": []}
    feat, layouts = chip_smoke.take_rows_inputs(dev)
    for ids in layouts.values():
        ids64 = ids.long().reshape(ids.shape[0], -1)
        out["p2_ms"].append(cuda_ms(lambda: gather.take_along_rows(feat,
                                                                   ids)))
        out["p2_take_along_dim_ms"].append(cuda_ms(
            lambda: torch.take_along_dim(feat, ids64, dim=0)))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True)
    parser.add_argument("--label", default=None)
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--requests", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch_kernels.py needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    chip_smoke = load_chip_smoke()
    import stereoscene_torch
    from stereoscene_torch import _build
    from stereoscene_torch.engine import train
    from stereoscene_torch.geometry import disparity_positions
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

    if not stereoscene_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {stereoscene_torch.__file__}, not "
                           f"the package under {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _build.load_kernels()

    gen = torch.Generator(device=dev).manual_seed(1)
    left, right = (torch.randn(1, 48, 160, 64, generator=gen, device=dev)
                   .bfloat16() for _ in range(2))
    pos = disparity_positions(torch.full((1,), FX * BASELINE, device=dev),
                              112)
    k1 = cuda_ms(lambda: gwc.fused_gwc_warp(
        left, right, pos, 112, 32, out_dtype=torch.bfloat16,
        use_kernel=True))

    torch.backends.cudnn.allow_tf32 = False
    k4, cudnn, per_shape = 0.0, 0.0, []
    for ci, d, h, w, co in K4_SHAPES:
        x = torch.randn(1, ci, d, h, w, generator=gen, device=dev).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last_3d)
        wt = (torch.randn(co, ci, 3, 3, 3, generator=gen, device=dev)
              * ci ** -0.5).bfloat16()
        wcl = wt.contiguous(memory_format=torch.channels_last_3d)
        # a forward's four launches of the shape, back to back
        ms = cuda_ms(lambda: conv3d.conv3d_s1(x, wt, use_kernel=True),
                     reps=4)
        lib = cuda_ms(lambda: torch.nn.functional.conv3d(x, wcl, padding=1),
                      reps=4)
        per_shape.append(ms / 4)
        k4 += ms
        cudnn += lib
    del x, wt, wcl

    cfg = DetectorConfig(backbone_with_cp=False)
    model = BEVDepthOccupancy(cfg)
    seeded_init_(model, 0)
    splat = bench_splats(chip_smoke, voxel_pool, chip_smoke.splat_inputs(
        model, chip_smoke.flagship_batch(cfg, 0, "cpu"), dev))
    gathers = bench_gathers(chip_smoke, deform_conv, gather, model, dev)
    _, serve_samples = chip_smoke.phase_serve(model, cfg, dev, _build, card,
                                              args.requests)
    del model
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True
    cfg = DetectorConfig()
    batch = chip_smoke.train_batch(cfg, 20, dev)
    model = BEVDepthOccupancy(cfg, conv3d_kernel=True)
    seeded_init_(model, 0)
    state = train.create_train_state(model)
    step = train.make_train_step(train.LossConfig(), bf16=True)
    times, losses = [], []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = step(state, batch,
                           torch.Generator(device=dev).manual_seed(0))
        losses.append(float(logs["loss_total"]))
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "label": args.label or tree, "card": card, "k1_ms": k1,
        "k4_ms": k4, "k4_shape_ms": per_shape, "k4_cudnn_ms": cudnn,
        **splat, **gathers, "serve_ms": statistics.median(serve_samples),
        "serve_samples_ms": serve_samples,
        "step_ms": statistics.median(times[1:]), "step_samples_ms": times,
        "losses": losses}), flush=True)


if __name__ == "__main__":
    main()
