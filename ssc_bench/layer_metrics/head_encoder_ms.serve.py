"""head_encoder_ms.serve: device ms a traced frame of the operations
launched inside the program's ``stereoscene.head.encoder`` span: the
Mask2Former head's pixel decoder, from its input projections to the mask
features (the deformable encoder and the FPN fuse)."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("stereoscene.head.encoder",),
                                   "frames")
