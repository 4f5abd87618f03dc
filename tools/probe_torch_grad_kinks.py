"""How far the port's whole-detector gradient moves under tiny weight noise.

At the tests' TINY configuration, builds the port's detector with seeded
weights, takes the training loss's gradient (the active recipe, fixed ASPP
dropout mask) at the weights w and at w * (1 + eps * noise), and prints,
for each eps (0: the same weights run again), the largest change of a
gradient leaf relative to its scale and how many leaves move by more than
the 2% parity limit (floor 1e-4 of the global gradient scale). A smooth
loss moves its gradient by about eps; moves far larger than eps mean kinks
within reach of rounding, so two fp32 implementations of the same detector
cannot agree leaf by leaf at 2%.

Run from the repository root:

    python tools/probe_torch_grad_kinks.py [--seed 7] [--eval] [--device cpu]

``--eval`` puts BatchNorm on its running statistics (still with autograd).
``--device`` (default ``cuda``, where the kernels run) picks where the
detector is built and run. The finding recorded in PERF.md was made on the
CPU: rerun it with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stereoscene_torch.engine import train  # noqa: E402
from stereoscene_torch.models import layers  # noqa: E402
from stereoscene_torch.models.detector import (  # noqa: E402
    BEVDepthOccupancy,
    DetectorConfig,
)
from stereoscene_torch.utils.weights import seeded_init_  # noqa: E402

# tests/test_models.py TINY
TINY = DetectorConfig(
    input_size=(64, 128), xbound=(0.0, 8.0, 1.0), ybound=(-4.0, 4.0, 1.0),
    zbound=(-2.0, 2.0, 1.0), dbound=(2.0, 10.0, 0.5), backbone_arch="b0",
    backbone_drop_path_rate=0.0, backbone_with_cp=False,
    neck_in_channels=(24, 40, 112, 320, 1280),
    neck_out_channels=(16, 16, 16, 16, 16), numC_Trans=8,
    voxel_channels=(8, 16, 32), voxel_out_channels=(8, 8, 8),
    attention_chunk=64, norm_groups=4)


def tiny_batch(rng: np.random.RandomState, b: int = 2) -> dict:
    """The tests' TINY stereo batch with labels (tests/test_torch_train.py)."""
    h, w = TINY.input_size
    intrin = np.zeros((b, 2, 3, 4), np.float32)
    intrin[..., 0, 0] = intrin[..., 1, 1] = 50.0
    intrin[..., 0, 2], intrin[..., 1, 2], intrin[..., 2, 2] = w / 2, h / 2, 1
    rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    x, y, z = TINY.grid_shape
    batch = {
        "imgs": rng.randn(b, 2, h, w, 3).astype(np.float32),
        "rots": np.broadcast_to(rot, (b, 2, 3, 3)).copy(),
        "trans": np.zeros((b, 2, 3), np.float32),
        "intrins": intrin,
        "post_rots": np.broadcast_to(np.eye(3, dtype=np.float32),
                                     (b, 2, 3, 3)).copy(),
        "post_trans": np.zeros((b, 2, 3), np.float32),
        "bda": np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)).copy(),
        "calib": np.full((b,), 20.0, np.float32),
        "gt_occ": np.where(rng.rand(b, 2 * x, 2 * y, 2 * z) < 0.1, 255,
                           rng.randint(0, 20, (b, 2 * x, 2 * y, 2 * z))
                           ).astype(np.int32),
        "gt_depth": ((rng.rand(b, 2, h, w) < 0.07)
                     * (rng.rand(b, 2, h, w) * 7.5 + 2.1)).astype(np.float32),
    }
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def gradients(seed: int, eps: float, eval_bn: bool, batch, device) -> dict:
    model = BEVDepthOccupancy(TINY, device=device)
    seeded_init_(model, seed)
    noise = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + eps * torch.randn(p.shape, generator=noise).to(device))
    state = train.create_train_state(model, device=device)
    if eval_bn:
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.eval()
    _, _, grads = train.loss_and_grads(
        state, batch, train.LossConfig(downsample=TINY.downsample,
                                       dbound=TINY.dbound))
    return {n: g for (n, _), g in zip(state.trainable, grads)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dev = torch.device(args.device)
    rng = np.random.RandomState(5)
    batch = {k: v.to(dev) for k, v in tiny_batch(rng).items()}
    shape = (2, sum(TINY.neck_out_channels)) + TINY.feature_size
    mask = torch.from_numpy(rng.rand(*shape) < 0.5).to(dev)
    layers.keep_mask = lambda *a: mask  # one fixed ASPP dropout mask
    base = gradients(args.seed, 0.0, args.eval, batch, dev)
    floor = 1e-4 * max(float(g.abs().max()) for g in base.values())
    for eps in (0.0, 1e-8, 1e-7, 1e-6):
        moved = gradients(args.seed, eps, args.eval, batch, dev)
        rel = {n: float((moved[n] - g).abs().max())
               / max(float(g.abs().max()), floor) for n, g in base.items()}
        worst = max(rel, key=rel.get)
        over = sum(v > 2e-2 for v in rel.values())
        print(f"eps {eps:.0e}: worst leaf moves {rel[worst]:.3e} of its "
              f"scale ({worst}); {over} of {len(rel)} leaves move > 2%",
              flush=True)


if __name__ == "__main__":
    main()
