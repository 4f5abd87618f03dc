"""P1_roofline: the bound time of the window's ``dcn_gather``
launches (csrc/dcn.cu) over their device time, in %. Bytes and operations
from the DepthNet DCN's shapes (``roofline.p1``): z of 9 taps and the
output in the serving precision, the offsets as the bf16 offset head gives
them."""

import torch

from ssc_bench import roofline


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    peak = roofline.peaks(torch.cuda.get_device_name(ctx["device"]))
    if t is None or peak is None:
        return None
    seconds, calls = t.device_seconds("dcn_gather")
    if not calls:
        return None
    m = cell.config["model"]
    fh, fw = (n // m["downsample"] for n in m["input_size"])
    size = 2 if cell.config["precision"] == "bfloat16" else 4
    work = roofline.p1(fh * fw, sum(m["neck_out_channels"]), 9, size, size)
    bound = roofline.bound_s(work["bytes"], work["ops"], peak, work["rate"])
    return 100.0 * calls * bound / seconds
