"""FLOPs of one forward of the plain reference at a cell's shapes, counted
by ``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only, no memory, no device): the matrix products, convolutions and their
transposes at 2 FLOPs a multiply-add. Whatever implements the program, the
work a frame or a step is credited with stays this count."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import model as reference


def forward_flops(model_cfg: Dict, batch: int) -> int:
    """FLOPs of one eval forward of ``batch`` frames, the voxel ranks of
    the frustum (a function of the calibration alone, which the program
    builds once on the host) made outside the count."""
    m = model_cfg
    h, w = m["input_size"]
    with torch.device("meta"):
        net = reference.build(m, "meta")
        inputs = {"imgs": torch.empty(batch, 2, h, w, 3),
                  "rots": torch.empty(batch, 2, 3, 3),
                  "trans": torch.empty(batch, 2, 3),
                  "intrins": torch.empty(batch, 2, 3, 4),
                  "post_rots": torch.empty(batch, 2, 3, 3),
                  "post_trans": torch.empty(batch, 2, 3),
                  "bda": torch.empty(batch, 3, 3),
                  "calib": torch.empty(batch)}
        ranks = net.ranks(inputs)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(inputs, ranks=ranks)
    return int(counter.get_total_flops())
