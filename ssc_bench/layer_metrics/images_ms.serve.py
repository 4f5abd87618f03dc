"""images_ms.serve: mean device ms a traced frame of the images layer, the
EfficientNet and SECONDFPN over both eyes, from the image backbone's
forward pre-hook to the view transformer's (CUDA events)."""

import statistics


def read(ctx):
    values = ctx["spans"].get("images")
    return statistics.fmean(values) if values else None
