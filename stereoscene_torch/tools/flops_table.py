"""Per-stage FLOP table of the detector's eval forward, the port's
counterpart of ``tools/flops_table.py``:

    python -m stereoscene_torch.tools.flops_table [CONFIG] [--device cuda]

CONFIG defaults to the flagship's ``configs/stereoscene_semantickitti.py``.
The model is built for inference, as the JAX tool builds it (no backbone
checkpointing, no drop path), with seeded weights, on the card unless
``--device cpu``; one frame at the flagship calibration with seeded
images goes through its three stages, ``encode_images`` (both eyes),
``view_transform`` (stereo, mono, MIE and the splat over the frame's
static plan, made on the host outside the count) and ``bev_encode`` (the
3D encoder, its neck and the head), each on the plain route
(``use_kernel=False``) under ``torch.utils.flop_counter.FlopCounterMode``
(``engine.flops.count_flops``): the aten matrix products and convolutions
at 2 FLOPs a multiply-add. The stages sum to the eval CLI's ``--flops``
count of the same forward (whose upsample and argmax count nothing).

The JAX tool reports XLA's cost analysis of the lowered stage graphs,
which counts elementwise work and reductions too, so its numbers are not
this table's and this table does not claim to match them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch

from ..config import Config
from ..engine.flops import count_flops, param_count
from ..models.detector import BEVDepthOccupancy, DetectorConfig
from ._frames import frame

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "stereoscene_semantickitti.py")
STAGES = ("image encoder (both eyes)",
          "view transform (stereo+mono+MIE+splat)", "bev encoder + head")


@torch.no_grad()
def stage_flops(model: BEVDepthOccupancy, batch: Dict) -> Dict[str, int]:
    """FLOPs of each eval stage on ``batch`` (plain route)."""
    model.eval()
    batch = model.attach_plan(batch)
    left, right = model.encode_images(batch["imgs"])
    voxels, _ = model.view_transform(left, right, batch, use_kernel=False)
    calls = ((model.encode_images, (batch["imgs"],), {}),
             (model.view_transform, (left, right, batch),
              {"use_kernel": False}),
             (model.bev_encode, (voxels,), {}))
    return {name: count_flops(fn, *args, **kw)[0]
            for name, (fn, args, kw) in zip(STAGES, calls)}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Print the table; returns the FLOPs by stage and ``TOTAL``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", nargs="?", default=FLAGSHIP)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    cfg = DetectorConfig.from_config(Config.fromfile(args.config))
    cfg = dataclasses.replace(cfg, backbone_with_cp=False,
                              backbone_drop_path_rate=0.0)
    device = torch.device(args.device)
    torch.manual_seed(0)
    model = BEVDepthOccupancy(cfg, device=device)
    flops = stage_flops(model, frame(cfg, device))
    flops["TOTAL"] = sum(flops.values())
    print(f"config: {os.path.basename(args.config)}  input "
          f"{cfg.input_size}, D={cfg.num_depth}, grid {cfg.grid_shape}, "
          f"params {param_count(model) / 1e6:.1f}M (aten matmul and conv "
          f"FLOPs of the plain route, torch FlopCounterMode)")
    for name in STAGES:
        print(f"  {name:45s} {flops[name] / 1e9:10.2f} GFLOP")
    print(f"  {'TOTAL forward':45s} {flops['TOTAL'] / 1e9:10.2f} GFLOP")
    return flops


if __name__ == "__main__":
    main()
