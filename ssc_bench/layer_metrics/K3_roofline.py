"""K3_roofline: the bound time of the window's ``lift_splat_fused``
calls (csrc/splat.cu: ``splat_chunks`` then ``splat_fixup``) over their
device time, in %. The bytes and operations come from the benchmark's own
count of the cell's plan (``roofline.k3``, ``roofline.splat_plan``)."""

import torch

from ssc_bench import roofline


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    peak = roofline.peaks(torch.cuda.get_device_name(ctx["device"]))
    if t is None or peak is None:
        return None
    chunks, calls = t.device_seconds("splat_chunks")
    fixup, _ = t.device_seconds("splat_fixup")
    if not calls:
        return None
    m = cell.config["model"]
    plan = roofline.splat_plan(m, cell.traffic, m["splat_group"])
    fh, fw = (n // m["downsample"] for n in m["input_size"])
    lo, hi, step = m["dbound"]
    work = roofline.k3(fh * fw, int(round((hi - lo) / step)), m["numC_Trans"],
                       plan["num_voxels"], plan["padded"], plan["live"],
                       2 if cell.config["precision"] == "bfloat16" else 4)
    bound = roofline.bound_s(work["bytes"], work["ops"], peak, work["rate"])
    return 100.0 * calls * bound / (chunks + fixup)
