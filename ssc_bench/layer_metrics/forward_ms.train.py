"""forward_ms.train: device ms a traced step of the operations launched
inside the program's ``stereoscene.forward`` span: the bf16 copies of the
parameters, the model and the losses."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("stereoscene.forward",), "steps")
