"""The work of one 3D multi-scale deformable attention call of the
Mask2Former pixel decoder (``msdeform_attn_3d``), counted from the
configuration's shapes, whatever implements it (the yardstick of
``msdeform_roofline``).

The call samples, for every token of the encoder's levels, each head's
``points`` locations on every level, at the 8 corners of a trilinear
sample, and sums them under the attention weights. Bytes: each level's
values read once, the sampling locations (float32, three coordinates) and
the attention weights read once, the output written once, values, weights
and output in the configuration's precision. Operations: a multiply-add a
corner and a channel of a head: tokens x heads x levels x points x 8 x
(channels / heads) x 2, at the peak rate of that precision.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from ssc_bench.reference import geometry


def encoder_levels(model_cfg: Dict) -> List[Tuple[int, int, int]]:
    """The (X, Y, Z) of the levels the deformable encoder attends: the
    coarsest ``num_feat_levels`` (of ``mask_head``) of the 3D encoder's
    stages in
    ``voxel_out_indices`` (a stride-2 stage halves each axis, rounding
    up)."""
    m = model_cfg
    _, _, nx = geometry.gen_dx_bx(m["xbound"], m["ybound"], m["zbound"])
    shape, stages = [int(n) for n in nx], []
    for stride in m["voxel_strides"]:
        shape = [-(-n // stride) for n in shape]
        stages.append(tuple(shape))
    levels = [stages[i] for i in m["voxel_out_indices"]]
    return levels[len(levels) - m["mask_head"]["num_feat_levels"]:]


def msdeform_call(model_cfg: Dict, precision: str,
                  points: int = 4) -> Dict:
    """bytes, ops and the peak rate's key of one call."""
    m = model_cfg
    tokens = sum(math.prod(s) for s in encoder_levels(m))
    head = m["mask_head"]
    c, heads, levels = head["embed_dim"], head["num_heads"], \
        head["num_feat_levels"]
    size = 2 if precision == "bfloat16" else 4
    samples = tokens * heads * levels * points
    nbytes = (tokens * c * size          # the values
              + samples * 3 * 4          # the locations, float32
              + samples * size           # the attention weights
              + tokens * c * size)       # the output
    return {"bytes": nbytes, "ops": samples * 8 * (c // heads) * 2,
            "rate": "bf16_flop_per_s" if size == 2 else "fp32_flop_per_s"}
