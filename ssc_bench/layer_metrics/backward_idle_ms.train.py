"""backward_idle_ms.train: device idle ms a traced step while the
program's ``stereoscene.backward`` span is open."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("stereoscene.backward",), "steps")
