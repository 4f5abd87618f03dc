"""The faults of the ``stereoscene_m2f`` family's serving comparison:
``calibrate.py``'s program readings with the program's Mask2Former head
broken underneath (its ``--seeds`` lines are then the fault's readings).

    python3 ssc_bench/m2f_faults.py skip_last|mask CALIBRATE_ARGS...

- ``skip_last``: the last decoder layer hands its queries on unchanged,
  so the last prediction is the one before it;
- ``mask``: every masked cross-attention ignores its attention mask and
  attends everywhere.

Run from the root of a checkout on a machine with a CUDA card, as
``calibrate.py``.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def break_head(fault: str) -> None:
    """Break the program's head class in place (this process only)."""
    import torch

    from stereoscene_torch.models import mask2former_occ as head

    if fault == "skip_last":
        init = head.Mask2FormerOccHead.__init__

        def built(self, *args, **kwargs):
            init(self, *args, **kwargs)
            getattr(self, f"layer{self.num_layers - 1}").forward = \
                lambda queries, *rest: queries

        head.Mask2FormerOccHead.__init__ = built
    elif fault == "mask":
        forward = head.MaskedCrossAttention.forward

        def unmasked(self, queries, query_pos, feats, feat_pos, attn_mask):
            return forward(self, queries, query_pos, feats, feat_pos,
                           torch.zeros_like(attn_mask))

        head.MaskedCrossAttention.forward = unmasked
    else:
        raise SystemExit(f"unknown fault {fault!r} (skip_last or mask)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from ssc_bench import calibrate

    break_head(argv[0])
    return calibrate.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
