"""mfu.serve: the counted FLOPs of one forward of the plain reference at
the cell's shapes, times the frames answered in the window, over the
window's seconds and the card's dense bf16 peak, in %."""

import torch

from ssc_bench.flops import forward_flops
from ssc_bench.roofline import peaks


def read(ctx):
    peak = peaks(torch.cuda.get_device_name(ctx["device"]))
    if peak is None or not ctx["frames"]:
        return None
    flops = forward_flops(ctx["cell"].config, 1)
    return 100.0 * flops * ctx["frames"] / ctx["window_s"] \
        / peak["bf16_flop_per_s"]
