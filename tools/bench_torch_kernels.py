"""Time K1 and K4 of a ``stereoscene_torch`` tree, and its bf16 train step.

Compares two versions of the port on one card: run it once per tree, in
turns (old, new, new, old), inside one command:

    python tools/bench_torch_kernels.py --tree DIR [--label NAME] [--steps 6]

``--tree`` is the root of a checkout (for example an older commit unpacked
with ``git archive``); its ``stereoscene_torch`` and ``chip_smoke.py`` are
imported, whichever tree this script lives in. Prints one JSON line:

- ``k1_ms``: K1 bf16 at the flagship shapes (left / right [1, 48, 160, 64],
  D = K = 112, G = 32), the whole ``fused_gwc_warp`` call, median of 20
  CUDA-event runs;
- ``k4_ms``: per flagship forward, the bf16 kernel's 12 launches over its
  three conv shapes (channels-last input), each shape's four launches
  timed back to back, median of 20;
  ``k4_cudnn_ms`` the same for cuDNN's channels-last ``F.conv3d``;
- ``step_ms``: bf16 train steps of ``DetectorConfig()`` built with
  ``conv3d_kernel=True`` (host wall clock per step; the first step, cuDNN's
  set-up, is left out of the median), and their losses.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

FX, BASELINE = 707.0, 0.54
K4_SHAPES = ((64, 56, 24, 80, 64), (128, 28, 12, 40, 128),
             (128, 64, 64, 8, 128))  # (Ci, D, H, W, Co), 4 launches each


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True)
    parser.add_argument("--label", default=None)
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch_kernels.py needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke
    import stereoscene_torch
    from stereoscene_torch import _build
    from stereoscene_torch.engine import train
    from stereoscene_torch.geometry import disparity_positions
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.ops import conv3d, gwc
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
        "step_ms": statistics.median(times[1:]), "step_samples_ms": times,
        "losses": losses}), flush=True)


if __name__ == "__main__":
    main()
