"""FLOPs of one forward of the plain reference at a cell's shapes, counted
by ``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only, no memory, no device): the matrix products, convolutions and their
transposes at 2 FLOPs a multiply-add. Whatever implements the program, the
work a frame or a step is credited with stays this count."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import families


def forward_flops(config: Dict, batch: int) -> int:
    """FLOPs of one eval forward of ``batch`` frames of the configuration
    file ``config``'s model, on the inputs its family gives
    (``flop_inputs``)."""
    family, m = families.of(config), config["model"]
    with torch.device("meta"):
        net = family.build_reference(m, "meta")
        args, kwargs = family.flop_inputs(net, m, batch)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(*args, **kwargs)
    return int(counter.get_total_flops())
