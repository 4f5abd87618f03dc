"""One card's 1/N share of the spatially sharded high-resolution config,
the port's counterpart of ``tools/highres_slice.py``:

    python -m stereoscene_torch.tools.highres_slice [--shards 4] [--train] \\
        [--iters 5] [--stream-chunks 16] [--no-bev-cp] [--no-backbone-cp] \\
        [--device cuda]

Measures what one card of an N-way spatially sharded highres step
(``configs/stereoscene_highres.py``: a 256x256x32 grid, 512x512x64
labels) holds and how long it takes, without N cards: the image side,
which every space rank runs whole, runs at full size, and the voxel
grid's X axis is cut to 1/N (``xbound`` to ``(x0, x0 + step * X / N,
step)``). That is one card's workload minus the halo exchanges; frustum
points beyond the cut fall out of bounds, and the static splat plan is
built for the cut grid. An X extent that ``--shards`` does not divide is
refused. Seeded weights (``utils.weights.seeded_init_``) and the JAX
tool's frame, ``__graft_entry__._make_batch`` (``_frames.slice_frame``:
fx = W / 2, calib = W x 0.54, images and targets at twice the cut grid
from ``RandomState(0)``). It runs on the card unless ``--device cpu``.

- Forward (the default): the three stages ``encode_images``,
  ``view_transform`` (the kernels' route over the static plan) and
  ``bev_encode`` + argmax, in serving's bf16 policy (the model cast to
  bf16; ``--bf16`` is accepted and always on, as in the JAX tool), 2
  warm-up requests, then ``--iters`` requests back to back closed by one
  host fetch. ``value`` is the mean of the last request's logits.
- ``--train``: the bf16 train step (``bench_train.time_steps``) with
  backbone and voxel-side checkpointing (``--no-backbone-cp``,
  ``--no-bev-cp`` take them off) and the streaming voxel losses over
  ``--stream-chunks`` Y-slabs (the largest divisor of Y not above it; 0
  upsamples the logits whole): a first step, 2 warm-up steps, then
  ``--iters`` steps closed by one host fetch of ``loss_total``, which is
  ``value``.

One JSON line with the JAX tool's keys: ``mode``, ``shards``, ``grid``,
``step_ms``, ``value``, and the card's memory in GiB, ``hbm_peak_gb``
(``torch.cuda.max_memory_allocated`` from the first step or warm-up
request on, reset before it: allocated, not reserved), ``hbm_in_use_gb``
(``memory_allocated`` at the end) and ``hbm_limit_gb`` (the card's total
memory), null on the CPU; and ``analyzed_tflops``, ``FlopCounterMode``'s
count on the plain route (``use_kernel=False``, as ``bench_train``'s
``fwd_gflop``) of one request (forward) or of one more step after the
timed ones (train: forward, backward and the checkpointed regions'
recompute): aten matrix products and convolutions. The JAX tool's
``hbm_stage_max_gb`` and ``analyzed_gbytes`` are XLA's compile-time
memory and cost analyses, which have no counterpart here, and are left
out. The kernels' launches from the first step or warm-up request on go
to stderr as ``# launches`` and a JSON object; the counted call is
outside them and outside the peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from .. import _build
from ..config import Config
from ..engine.flops import count_flops
from ..engine.loop import step_generator
from ..engine.train import LossConfig, make_train_step
from ..models.detector import BEVDepthOccupancy, DetectorConfig
from ..utils.weights import seeded_init_
from ._frames import slice_frame
from .bench_train import WARMUP, peak_gib, reset_peak, time_steps, timed

HIGHRES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "stereoscene_highres.py")
WARMUP = 2


def slice_config(full: DetectorConfig, shards: int, train: bool = False,
                 bev_cp: bool = True, backbone_cp: bool = True
                 ) -> DetectorConfig:
    """``full`` with its grid's X cut to 1/``shards``; checkpointing on in
    training where asked for, off for the forward."""
    x, y, z = full.grid_shape
    if shards < 1 or x % shards:
        raise ValueError(f"--shards {shards} does not divide the grid's X "
                         f"extent {x}")
    x0, _, step = full.xbound
    cut = dataclasses.replace(
        full, xbound=(x0, x0 + step * (x // shards), step),
        backbone_with_cp=train and backbone_cp,
        bev_with_cp=train and bev_cp)
    if cut.grid_shape != (x // shards, y, z):
        raise ValueError(f"the cut grid is {cut.grid_shape}, not "
                         f"{(x // shards, y, z)}")
    return cut


def stream_chunks(cfg: DetectorConfig, chunks: int) -> int:
    """The largest divisor of the grid's Y not above ``chunks`` (0 stays
    0: the whole upsample)."""
    y = cfg.grid_shape[1]
    return max(d for d in range(1, chunks + 1) if y % d == 0) if chunks else 0


def memory(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"hbm_peak_gb": None, "hbm_in_use_gb": None,
                "hbm_limit_gb": None}
    return {"hbm_peak_gb": peak_gib(device),
            "hbm_in_use_gb": torch.cuda.memory_allocated(device) / 2**30,
            "hbm_limit_gb": torch.cuda.get_device_properties(
                device).total_memory / 2**30}


def run_forward(model: BEVDepthOccupancy, batch: Dict, iters: int,
                device: torch.device) -> Dict:
    """Serving's staged bf16 forward: one request counted on the plain
    route, then 2 warm-ups and ``iters`` timed requests on the kernels'."""
    model.to(torch.bfloat16)
    batch = model.attach_plan({k: v for k, v in batch.items()
                               if not k.startswith("gt_")})
    imgs = batch["imgs"].to(torch.bfloat16)

    @torch.no_grad()
    def request(_=None, use_kernel=None):
        left, right = model.encode_images(imgs)
        voxels, _ = model.view_transform(left, right, batch,
                                         use_kernel=use_kernel)
        logits = model.bev_encode(voxels).float()
        logits.argmax(1)  # the request's class map, as serving ends
        return logits.mean()

    flops = count_flops(request, use_kernel=False)[0]
    reset_peak(device)
    _build.launch_counts.clear()
    ms, value = timed(request, iters)
    return {"step_ms": ms, "value": value, **memory(device),
            "analyzed_tflops": flops / 1e12}


def run_train(model: BEVDepthOccupancy, batch: Dict, iters: int,
              chunks: int, device: torch.device, seed: int) -> Dict:
    """The train step timed by ``bench_train.time_steps``, the memory
    read, then one more step counted on the plain route (``FlopCounterMode``
    moves the bf16 backward's rounding, so no timed step runs under it)."""
    cfg = model.cfg
    loss_cfg = LossConfig(downsample=cfg.downsample, dbound=cfg.dbound,
                          stream_voxel_chunks=stream_chunks(cfg, chunks))
    state, ms, value = time_steps(model, batch, loss_cfg, iters,
                                  steps_per_epoch=10, device=device,
                                  seed=seed)
    record = {"step_ms": ms, "value": value, **memory(device)}
    plain = make_train_step(loss_cfg, bf16=True, use_kernel=False)
    flops = count_flops(plain, state, batch, step_generator(
        seed, 1 + WARMUP + iters, device))[0]
    return dict(record, analyzed_tflops=flops / 1e12)


def run(full: DetectorConfig, shards: int = 4, train: bool = False,
        iters: int = 5, chunks: int = 16, bev_cp: bool = True,
        backbone_cp: bool = True, device="cuda", seed: int = 0) -> Dict:
    """Time one card's share of ``full`` cut to 1/``shards`` of its X;
    returns the JSON record."""
    device = torch.device(device)
    cfg = slice_config(full, shards, train, bev_cp, backbone_cp)
    x, y, z = cfg.grid_shape
    print(f"# slice: grid {cfg.grid_shape} (X 1/{shards} of {x * shards}), "
          f"occ {(2 * x, 2 * y, 2 * z)}, input {cfg.input_size}, "
          f"D={cfg.num_depth}", file=sys.stderr, flush=True)
    model = BEVDepthOccupancy(cfg, device=device)
    seeded_init_(model, seed)
    batch = slice_frame(cfg, device)
    if train:
        measured = run_train(model, batch, iters, chunks, device, seed)
    else:
        measured = run_forward(model, batch, iters, device)
    return {"mode": "train" if train else "forward", "shards": shards,
            "grid": list(cfg.grid_shape), **measured}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--train", action="store_true",
                   help="time the whole train step (default: the forward)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--bf16", action="store_true", default=True,
                   help="kept for the JAX tool's command line: both modes "
                        "run in bf16")
    p.add_argument("--stream-chunks", type=int, default=16,
                   help="streaming voxel loss Y-slabs (0: the whole "
                        "upsample); --train only")
    p.add_argument("--no-bev-cp", action="store_true",
                   help="train without voxel-side checkpointing")
    p.add_argument("--no-backbone-cp", action="store_true",
                   help="train without backbone checkpointing")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Print the JSON line; returns the record."""
    args = parse_args(argv)
    full = DetectorConfig.from_config(Config.fromfile(HIGHRES))
    record = run(full, args.shards, args.train, args.iters,
                 args.stream_chunks, not args.no_bev_cp,
                 not args.no_backbone_cp, args.device)
    print(f"# launches {json.dumps(dict(_build.launch_counts))}",
          file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
