"""bev_idle_ms.serve: device idle ms a traced frame while the program's
``stereoscene.bev`` or ``stereoscene.classmap`` span is open: the voxel
encoder, its neck and the head, then the upsample and the argmax (the
extent of ``bev_ms.serve``)."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.idle_ms(
        ctx, ("stereoscene.bev", "stereoscene.classmap"), "frames")
