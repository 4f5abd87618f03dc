"""view_idle_ms.serve: device idle ms a traced frame while the program's
``stereoscene.view`` span is open: the stereo volume, DepthNet, MIE and
the splat."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("stereoscene.view",), "frames")
