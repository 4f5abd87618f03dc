"""bev_ms.serve: mean device ms a traced frame of the bev layer, the voxel
encoder, its neck, the head, the upsample and the argmax, from the voxel
encoder's forward pre-hook to the class map (CUDA events)."""

import statistics


def read(ctx):
    values = ctx["spans"].get("bev")
    return statistics.fmean(values) if values else None
