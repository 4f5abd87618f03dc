"""backward_ms.train: device ms a traced step of the operations launched
inside the program's ``stereoscene.backward`` span (``torch.autograd.grad``
with the checkpointed blocks' recompute), autograd's device thread
included."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("stereoscene.backward",), "steps")
