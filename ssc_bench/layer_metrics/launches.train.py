"""launches.train: device operations (kernels, copies, fills) a traced
step launched inside the program's ``stereoscene.forward``,
``stereoscene.backward`` or ``stereoscene.optimizer`` span."""

from ssc_bench import program_spans

PHASES = ("stereoscene.forward", "stereoscene.backward",
          "stereoscene.optimizer")


def read(ctx):
    return program_spans.launches(ctx, PHASES, "steps")
