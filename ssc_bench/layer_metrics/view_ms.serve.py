"""view_ms.serve: mean device ms a traced frame of the view layer, the
stereo volume, DepthNet, MIE and the splat, from the view transformer's
forward pre-hook to the voxel encoder's (CUDA events)."""

import statistics


def read(ctx):
    values = ctx["spans"].get("view")
    return statistics.fmean(values) if values else None
