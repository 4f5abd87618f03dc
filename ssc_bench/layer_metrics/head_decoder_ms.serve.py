"""head_decoder_ms.serve: device ms a traced frame of the operations
launched inside the program's ``stereoscene.head.decoder`` span: the
Mask2Former head's query decoder, its predictions (class logits, mask
products, attention masks) and its masked-attention layers."""

from ssc_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("stereoscene.head.decoder",),
                                   "frames")
