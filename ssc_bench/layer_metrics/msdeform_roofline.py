"""msdeform_roofline: the bound time of the window's 3D deformable
attention calls over the device time of the operations launched under
the program's ``stereoscene.msdeform`` span, in %. The bound of a call
(``msdeform_work.msdeform_call``) is the larger of its bytes over the
card's memory rate and its operations over its peak; the calls are the
span's ranges opened in the window. None where the program opens no such
span."""

import torch

from ssc_bench import program_spans, roofline
from ssc_bench.layer_metrics.msdeform_work import msdeform_call

SPAN = "stereoscene.msdeform"


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    peak = roofline.peaks(torch.cuda.get_device_name(ctx["device"]))
    if t is None or peak is None:
        return None
    ws, we = t.window
    calls = sum(1 for name, start, _ in t.ranges
                if name == SPAN and ws <= start < we)
    ops = program_spans.launched(t, (SPAN,))
    seconds = sum(op.end - op.start for op in ops) / 1e9
    if not calls or seconds <= 0:
        return None
    work = msdeform_call(cell.config["model"], cell.config["precision"])
    bound = roofline.bound_s(work["bytes"], work["ops"], peak, work["rate"])
    return 100.0 * calls * bound / seconds
