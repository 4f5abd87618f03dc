"""Train-step throughput at flagship shapes, the port's counterpart of
``tools/bench_train.py``:

    python -m stereoscene_torch.tools.bench_train [--batches 1,2] \\
        [--iters 5] [--with-cp | --no-with-cp] [--bev-cp] [--accum 1] \\
        [--device cuda]

Times the whole train step (forward, losses, backward, the clip and
AdamW) of the flagship ``DetectorConfig()`` (EfficientNet-b7, 384x1280,
D = 112, the 64x64x8 grid) with seeded weights
(``utils.weights.seeded_init_``) in the bf16 policy (fp32 masters), for
each batch size: a first step (its seconds on stderr; on the card it
holds cuDNN's set-up), 2 warm-up steps, then ``--iters`` steps back to
back, closed by one host fetch of ``loss_total``. Each batch size starts
from the same seeded weights. It runs on the card unless ``--device
cpu``. Frames are seeded with the flagship calibration and the JAX tool's
targets (``_frames.train_frame``).

One JSON line per batch size with the JAX tool's keys (``metric``,
``batch``, ``step_ms``, ``steps_per_sec``, ``frames_per_sec``, ``mfu``,
``loss``, ``with_cp``, ``bev_cp``, ``accum``) and three more:

- ``fwd_gflop``: GFLOP a frame of one forward of this model on this
  batch, counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
  eval forward on the plain route, as ``flops_table`` counts (aten matrix
  products and convolutions at 2 FLOPs a multiply-add). A step is not
  counted: its checkpointed regions would count their recompute.
- ``device``: the card's name (``cpu`` on the CPU).
- ``peak_gib``: ``torch.cuda.max_memory_allocated`` (allocated, not
  reserved) over the steps, reset before the first; null on the CPU.

``mfu`` is 3 x ``fwd_gflop`` x B over the step time and the card's dense
bf16 peak (``PEAK_BF16``, keyed by ``torch.cuda.get_device_name``): the
forward and a backward of about twice its work. It is null on the CPU and
on a card the table does not name.

The kernels' launches over the steps go to stderr as ``# launches`` and
a JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import _build
from ..engine.flops import count_flops
from ..engine.loop import step_generator
from ..engine.train import (LossConfig, TrainState, create_train_state,
                            make_train_step)
from ..models.detector import BEVDepthOccupancy, DetectorConfig
from ..utils.weights import seeded_init_
from ._frames import train_frame

# dense bf16 tensor-core peak by torch.cuda.get_device_name (the H100 SXM5
# datasheet: 989.4 TFLOP/s without sparsity)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989.4e12}
WARMUP = 2


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def peak_flops(device: torch.device) -> Optional[float]:
    """The card's dense bf16 peak FLOP/s, or None (the CPU, or a card
    that ``PEAK_BF16`` does not name)."""
    if device.type != "cuda":
        return None
    return PEAK_BF16.get(torch.cuda.get_device_name(device))


@torch.no_grad()
def forward_flops(model: BEVDepthOccupancy, batch: Dict) -> int:
    """FLOPs of one eval forward of ``model`` on ``batch`` on the plain
    route, its static splat plan made on the host outside the count (as
    ``flops_table``); leaves the model in the mode it found it in."""
    training = model.training
    model.eval()
    try:
        return count_flops(model, model.attach_plan(batch),
                           use_kernel=False)[0]
    finally:
        model.train(training)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def timed(fn, iters: int, first: int = 0) -> Tuple[float, float]:
    """``fn(i)`` for the ``WARMUP`` warm-up calls from ``i = first`` on,
    then ``iters`` calls back to back closed by one host fetch of the
    last call's value; -> (ms a call, that value as a float)."""
    for i in range(first, first + WARMUP):
        out = fn(i)
    float(out)
    t0 = time.perf_counter()
    for i in range(first + WARMUP, first + WARMUP + iters):
        out = fn(i)
    value = float(out)
    return (time.perf_counter() - t0) / iters * 1e3, value


def time_steps(model: BEVDepthOccupancy, batch: Dict, loss_cfg: LossConfig,
               iters: int, accum: int = 1, steps_per_epoch: int = 100,
               device="cuda", seed: int = 0, label: str = ""
               ) -> Tuple[TrainState, float, float]:
    """Time the bf16 train step of ``model`` on ``batch``: a first step
    (its seconds on stderr), ``WARMUP`` warm-up steps, then ``iters``
    steps back to back closed by one host fetch of ``loss_total``. Step
    ``i`` (the first step is 0) draws its DropPath and dropout from
    ``engine.loop.step_generator(seed, i)``. The peak memory and
    ``_build.launch_counts`` are reset before the first step. -> (the
    state after the steps, ms a step, the last ``loss_total``)."""
    device = torch.device(device)
    state = create_train_state(model, steps_per_epoch=steps_per_epoch,
                               accumulate_steps=accum, device=device)
    step = make_train_step(loss_cfg, bf16=True)

    def loss(i):
        logs = step(state, batch, step_generator(seed, i, device))[1]
        return logs["loss_total"]

    reset_peak(device)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    float(loss(0))
    print(f"# {label}first step: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    ms, value = timed(loss, iters, first=1)
    return state, ms, value


def run(cfg: DetectorConfig, b: int, iters: int = 5, accum: int = 1,
        device="cuda", seed: int = 0) -> Dict:
    """Time the bf16 train step of ``cfg``'s model at batch size ``b``
    (``time_steps``); returns the JSON record."""
    device = torch.device(device)
    model = BEVDepthOccupancy(cfg, device=device)
    seeded_init_(model, seed)
    batch = train_frame(cfg, device, seed, b)
    fwd_gflop = forward_flops(model, batch) / b / 1e9
    _, ms, loss = time_steps(
        model, batch, LossConfig(downsample=cfg.downsample,
                                 dbound=cfg.dbound),
        iters, accum, device=device, seed=seed, label=f"B={b} ")
    dt = ms / 1e3

    peak = peak_flops(device)
    return {
        "metric": "train_step", "batch": b,
        "step_ms": ms,
        "steps_per_sec": 1.0 / dt,
        "frames_per_sec": b / dt,
        "mfu": None if peak is None else 3.0 * fwd_gflop * 1e9 * b / dt / peak,
        "loss": loss,
        "with_cp": cfg.backbone_with_cp,
        "bev_cp": cfg.bev_with_cp,
        "accum": accum,
        "fwd_gflop": fwd_gflop,
        "device": device_name(device),
        "peak_gib": peak_gib(device),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", default="1,2")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--with-cp", action="store_true", default=True,
                   help="checkpoint the backbone blocks (training default)")
    p.add_argument("--no-with-cp", dest="with_cp", action="store_false")
    p.add_argument("--bev-cp", action="store_true",
                   help="also checkpoint the voxel side (bev_with_cp)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation steps; each timed step is "
                        "ONE microbatch step, so frames/sec stays "
                        "comparable with --accum 1")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Print one JSON line per batch size; returns the records."""
    args = parse_args(argv)
    cfg = DetectorConfig(backbone_with_cp=args.with_cp,
                         bev_with_cp=args.bev_cp)
    records = []
    for b in (int(x) for x in args.batches.split(",")):
        records.append(run(cfg, b, args.iters, args.accum, args.device))
        print(f"# launches {json.dumps(dict(_build.launch_counts))}",
              file=sys.stderr, flush=True)
        print(json.dumps(records[-1]), flush=True)
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
