"""head_idle_ms.serve: device idle ms a traced frame while the program's
``stereoscene.head.encoder`` or ``stereoscene.head.decoder`` span is
open: the Mask2Former head's pixel decoder and query decoder."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.idle_ms(
        ctx, ("stereoscene.head.encoder", "stereoscene.head.decoder"),
        "frames")
