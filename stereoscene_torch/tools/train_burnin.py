"""Multi-step training burn-in, the port's counterpart of
``tools/train_burnin.py``.

Runs N (default 60) consecutive bf16 train steps at B = 1 against one
FIXED synthetic batch (the flagship frame of the JAX tool's
``make_flagship_batch``: seeded images and the flagship calibration; voxel
labels of class bands with a road floor, a vegetation block, empty upper
layers and 10% ignore; 5% of pixels with a LiDAR depth), with
``debug_grads``. The JAX tool draws its labels uniformly at random under
the floor and the block; at the flagship that noise holds the loss above
0.78x of its first value at every learning rate tried (PERF.md §6), so
the 0.7x check below could not tell a working optimizer from a broken
one, and the port's labels are the bands the JAX tool's comment
describes, with no random class. Because the batch never changes, a
correct forward / backward / optimizer chain drives the loss down; a NaN
or Inf in a loss or a gradient, or a flat or rising loss curve, shows a
fault that a single step's comparison can miss.

Checks (all printed; the exit code is nonzero when one fails):
  - every step's loss and gradient norm finite,
  - no nonfinite gradient entry at any step (``grad_nonfinite`` 0),
  - the mean of the last 10 losses below the mean of the first 10,
  - the last loss below 0.7x the first.

    python -m stereoscene_torch.tools.train_burnin [--steps 60] \\
        [--accum 1] [--lr 1e-4] [--config CONFIG] [--device cuda] \\
        [--seed 0] [--out summary.json]

The model is the flagship ``DetectorConfig()`` with backbone
checkpointing, or the model of ``--config`` (a python config of the
reference schema, e.g. ``stereoscene_torch/configs/stereoscene_tiny.py``
for a run in seconds on the CPU), with seeded random weights
(``utils.weights.seeded_init_``). It runs on the card unless ``--device
cpu``. It prints a per-step trace and, last, one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..engine.loop import step_generator
from ..engine.train import LossConfig, create_train_state, make_train_step
from ..models.detector import BEVDepthOccupancy, DetectorConfig
from ..utils.weights import seeded_init_


def burnin_batch(cfg: DetectorConfig, device, b: int = 1) -> dict:
    """The fixed batch: the JAX tool's flagship frame (bench.py:55-82,
    images from ``RandomState(0)``) and labels at twice the model's grid:
    eight bands of classes 1-8 along X, shifted by 8 classes in the upper
    half of Y, a road floor (class 9) in the lowest quarter of the layers,
    a vegetation block (15) in the next two quarters of the first quarter
    of X, empty (0) in the top quarter (at the flagship: layers 0-3,
    4-11 and 12-15, the JAX tool's floor and block), 10% ignore
    (``RandomState(1)``, as the JAX tool's); gt_depth on 5% of the pixels
    of both eyes, as the JAX tool's."""
    h, w = cfg.input_size
    rng = np.random.RandomState(0)
    intrin = np.zeros((b, 2, 3, 4), np.float32)
    intrin[..., 0, 0] = 707.0
    intrin[..., 1, 1] = 707.0
    intrin[..., 0, 2] = w / 2.0
    intrin[..., 1, 2] = h / 2.0
    intrin[..., 2, 2] = 1.0
    r = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    eye3 = np.broadcast_to(np.eye(3, dtype=np.float32), (b, 2, 3, 3))
    batch = {
        "imgs": rng.randn(b, 2, h, w, 3).astype(np.float32),
        "rots": np.broadcast_to(r, (b, 2, 3, 3)).copy(),
        "trans": np.zeros((b, 2, 3), np.float32),
        "intrins": intrin,
        "post_rots": eye3.copy(),
        "post_trans": np.zeros((b, 2, 3), np.float32),
        "bda": np.broadcast_to(np.eye(3, dtype=np.float32),
                               (b, 3, 3)).copy(),
        "calib": np.full((b,), 707.0 * 0.54, np.float32),
    }
    rng = np.random.RandomState(1)
    x, y, z = cfg.grid_shape
    xs = np.arange(2 * x)[:, None, None] * 8 // (2 * x)
    ys = np.arange(2 * y)[None, :, None] * 2 // (2 * y)
    gt = np.broadcast_to(1 + xs + 8 * ys,
                         (b, 2 * x, 2 * y, 2 * z)).copy()
    q = 2 * z // 4
    gt[..., :q] = 9
    gt[:, :x // 2, :, q:3 * q] = 15
    gt[..., 3 * q:] = 0
    gt[rng.rand(*gt.shape) < 0.1] = 255
    batch["gt_occ"] = gt.astype(np.int32)
    batch["gt_depth"] = ((rng.rand(b, 2, h, w) < 0.05)
                         * (rng.rand(b, 2, h, w) * 50.0 + 2.5)
                         ).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def check(losses: Sequence[float], grad_norms: Sequence[float],
          nonfinite: Sequence[float]) -> dict:
    """The four checks of the module docstring."""
    losses = np.asarray(losses)
    return {
        "all_loss_finite": bool(np.isfinite(losses).all()),
        "all_grad_finite": bool(np.isfinite(grad_norms).all()
                                and max(nonfinite) == 0),
        "trend_down": bool(losses[-10:].mean() < losses[:10].mean()),
        "optimizes": bool(losses[-1] < 0.7 * losses[0]),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="bf16 training burn-in")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4,
                   help="peak AdamW lr (reference recipe 1e-4)")
    p.add_argument("--config", default=None,
                   help="a python config (default: the flagship "
                        "DetectorConfig() with backbone checkpointing)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON summary here")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the burn-in; returns the summary (and exits nonzero when a check
    fails, if run as a script)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = (DetectorConfig.from_config(Config.fromfile(args.config))
           if args.config else DetectorConfig(backbone_with_cp=True))
    model = BEVDepthOccupancy(cfg, device=device)
    seeded_init_(model, args.seed)
    state = create_train_state(model, lr=args.lr, steps_per_epoch=1000,
                               accumulate_steps=args.accum, device=device)
    step = make_train_step(
        LossConfig(downsample=cfg.downsample, dbound=cfg.dbound), bf16=True,
        debug_grads=True)
    batch = burnin_batch(cfg, device)

    trace = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        if i == 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            print(f"# step 0 (with set-up): {t1 - t0:.1f} s",
                  file=sys.stderr, flush=True)
        state, logs = step(state, batch,
                           step_generator(args.seed, state.step, device))
        trace.append((logs["loss_total"], logs["grad_norm"],
                      logs["grad_nonfinite"]))
    losses = [float(t[0]) for t in trace]
    step_ms = ((time.perf_counter() - t1) * 1e3 / (args.steps - 1)
               if args.steps > 1 else float("nan"))
    gnorms = [float(t[1]) for t in trace]
    nonfin = [int(t[2]) for t in trace]
    for i in range(0, args.steps, 5):
        print(f"step {i:4d}  loss {losses[i]:9.4f}  grad_norm "
              f"{gnorms[i]:9.3f}  nonfinite {nonfin[i]}", flush=True)
    checks = check(losses, gnorms, nonfin)
    losses_a = np.asarray(losses)
    summary = {
        "metric": "train_burnin",
        "steps": args.steps,
        "accum": args.accum,
        "lr": args.lr,
        "step_ms": step_ms,
        "loss_first": losses[0],
        "loss_first10_mean": float(losses_a[:10].mean()),
        "loss_last10_mean": float(losses_a[-10:].mean()),
        "loss_last": losses[-1],
        "grad_norm_first": gnorms[0],
        "grad_norm_last": gnorms[-1],
        "nonfinite_grad_steps": sum(1 for n in nonfin if n),
        "checks": checks,
        "ok": all(checks.values()),
        "loss_trace": losses,
        "grad_norm_trace": gnorms,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
