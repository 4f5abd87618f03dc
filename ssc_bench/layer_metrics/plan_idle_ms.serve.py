"""plan_idle_ms.serve: device idle ms a traced frame while the program's
``stereoscene.plan`` span is open: the splat plan's lookup (the geometry's
copy to the host, its hash) and the plan's copy to the card, with the
build on a plan-cache miss."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("stereoscene.plan",), "frames")
