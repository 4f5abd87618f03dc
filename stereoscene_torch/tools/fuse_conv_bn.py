"""Fold BatchNorms into their convolutions in a saved checkpoint, port of
``tools/misc/fuse_conv_bn.py`` (the reference's tool of that name).

    python -m stereoscene_torch.tools.fuse_conv_bn CHECKPOINT CONFIG \\
        --out FUSED.pth [--device cuda]

``CHECKPOINT`` is a checkpoint the port loads (``tools.test.
load_checkpoint``: the port's own, a reference one or a fused one);
``CONFIG`` builds the model whose conv -> BN pairs are folded
(``utils.fuse_bn``). The output holds ``{"state_dict": ...}`` in the same
key layout, each folded BN the identity affine, and loads wherever the
input did. Prints the number of pairs folded. The model is built on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..config import Config
from ..models.detector import BEVDepthOccupancy, DetectorConfig
from ..utils.fuse_bn import fuse_conv_bn
from .test import load_checkpoint


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the tool; returns the number of pairs folded."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint")
    p.add_argument("config")
    p.add_argument("--out", required=True, help="the fused checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    model = BEVDepthOccupancy(
        DetectorConfig.from_config(Config.fromfile(args.config)),
        device=torch.device(args.device))
    load_checkpoint(model, args.checkpoint)
    fused, n = fuse_conv_bn(model)
    torch.save({"state_dict": {k: v.cpu() for k, v in fused.items()}},
               args.out)
    print(f"fused {n} conv+bn pairs")
    print(f"wrote fused checkpoint to {args.out}")
    return n


if __name__ == "__main__":
    main()
