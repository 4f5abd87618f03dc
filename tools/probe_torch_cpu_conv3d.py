#!/usr/bin/env python
"""Does a bf16 ``Conv3d`` on the CPU give the same output on every call?

Runs a seeded 3x3x3 bf16 conv (16 -> 32 channels, an 8x8 plane) at
stride 1 and 2 on input depths 1-6, ``--calls`` times each, with NaN
written to freed memory before every call, with oneDNN (``torch.backends.
mkldnn``) on and off; prints, per setting, how many calls differ from the
first and how many hold a NaN. Then takes one seeded bf16 loss and
gradient of the TINY detector (``configs/stereoscene_tiny.py``, Z = 4
planes, and the same with Z = 8) ``--steps`` times in this process and
prints the losses. One thread; the CPU only:

    python tools/probe_torch_cpu_conv3d.py [--calls 20] [--steps 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402


def scribble() -> None:
    """Leave NaN in freed blocks of many sizes, fp32 and bf16, for the
    next allocations to find."""
    for bits in range(8, 21, 2):
        junk = torch.full((1 << bits,), float("nan"))
        del junk
        junk = torch.full((1 << bits,), float("nan"), dtype=torch.bfloat16)
        del junk


def conv_repeats(depth: int, stride: int, calls: int) -> tuple:
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 8, 8, depth, generator=gen).bfloat16()
    w = torch.randn(32, 16, 3, 3, 3, generator=gen).bfloat16() / 20
    outs = []
    for _ in range(calls):
        scribble()
        outs.append(torch.nn.functional.conv3d(x, w, None, stride, 1))
    differ = sum(not torch.equal(outs[0], o) for o in outs[1:])
    nan = sum(bool(torch.isnan(o).any()) for o in outs)
    return differ, nan


def tiny_losses(zbound, steps: int) -> list:
    from stereoscene_torch.config import Config
    from stereoscene_torch.engine.loop import step_generator
    from stereoscene_torch.engine.train import (LossConfig,
                                                create_train_state,
                                                loss_and_grads)
    from stereoscene_torch.models.detector import (BEVDepthOccupancy,
                                                   DetectorConfig)
    from stereoscene_torch.tools._frames import train_frame
    from stereoscene_torch.utils.weights import seeded_init_

    path = os.path.join(os.path.dirname(__file__), "..", "stereoscene_torch",
                        "configs", "stereoscene_tiny.py")
    cfg = dataclasses.replace(
        DetectorConfig.from_config(Config.fromfile(path)), zbound=zbound)
    batch = train_frame(cfg, "cpu")
    loss_cfg = LossConfig(downsample=cfg.downsample, dbound=cfg.dbound)
    losses = []
    for _ in range(steps):
        scribble()
        model = BEVDepthOccupancy(cfg, device="cpu")
        seeded_init_(model, 0)
        state = create_train_state(model, device="cpu")
        total = loss_and_grads(state, batch, loss_cfg, True, None,
                               step_generator(0, 0, "cpu"))[0]
        losses.append(float(total))
    return losses


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(1)
    print(f"torch {torch.__version__}")
    for onednn in (True, False):
        with torch.backends.mkldnn.flags(enabled=onednn):
            for stride in (1, 2):
                for depth in range(1, 7):
                    differ, nan = conv_repeats(depth, stride, args.calls)
                    print(f"oneDNN {onednn} stride {stride} depth {depth}: "
                          f"{differ} of {args.calls - 1} calls differ from "
                          f"the first, {nan} hold NaN")
    for zbound in ((-2.0, 2.0, 1.0), (-2.0, 6.0, 1.0)):
        print(f"TINY zbound {zbound}: bf16 losses of one seeded step "
              f"{tiny_losses(zbound, args.steps)}")


if __name__ == "__main__":
    main()
