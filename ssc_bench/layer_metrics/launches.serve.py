"""launches.serve: device operations (kernels, copies, fills) a traced
frame launched inside the program's ``stereoscene.infer`` span."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.launches(ctx, ("stereoscene.infer",), "frames")
