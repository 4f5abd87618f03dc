"""images_idle_ms.serve: device idle ms a traced frame while the program's
``stereoscene.images`` span is open: EfficientNet and SECONDFPN over
both eyes."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("stereoscene.images",), "frames")
