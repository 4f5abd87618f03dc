"""Convert a reference checkpoint (``.pth``) into one of the port, port of
``tools/convert_checkpoint.py``.

    python -m stereoscene_torch.tools.convert_checkpoint REF.pth CONFIG \\
        --out PORT.pth [--prefix backbone.] [--no-strict] [--device cuda]

The reference file holds a ``state_dict`` entry or is the bare dict;
``--prefix`` strips a prefix from its keys. The port's modules carry the
reference's keys and layouts, so the conversion is a check
(``utils.convert_reference``): every key of the model must be present,
with its shape, and every key of the file used, ``num_batches_tracked``
and checkpoint bookkeeping aside; a file saved after the reference's
``fuse_conv_bn`` is adapted. ``--no-strict`` converts a partial file (a
pretrained backbone) and reports the keys left out on either side; the
model's own seeded values stand for the missing ones. The output,
``{"state_dict": ...}``, loads into the port's eval CLI (``--checkpoint``).
``CONFIG`` builds the model, on the card unless ``--device cpu``, at any
ResNet3D depth the JAX package builds (10, 18, 34, 50, 101: the keys of
the Bottleneck depths carry ``conv3`` / ``bn3``); another depth raises by
name.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..config import Config
from ..models.detector import BEVDepthOccupancy, DetectorConfig
from ..utils.convert_reference import load_reference
from .test import read_state_dict


def main(argv: Optional[Sequence[str]] = None):
    """Run the tool; returns (missing keys, unexpected keys)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("torch_ckpt")
    p.add_argument("config")
    p.add_argument("--out", required=True, help="the port's checkpoint")
    p.add_argument("--prefix", default="",
                   help="strip this prefix from the file's keys (e.g. "
                        "'backbone.')")
    p.add_argument("--no-strict", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    sd = read_state_dict(args.torch_ckpt, args.prefix)
    print(f"loaded {len(sd)} tensors")
    torch.manual_seed(0)
    model = BEVDepthOccupancy(
        DetectorConfig.from_config(Config.fromfile(args.config)),
        device=torch.device(args.device))
    missing, unexpected = load_reference(model, sd,
                                         strict=not args.no_strict)
    if missing or unexpected:
        print(f"{len(missing)} model keys not in the file (seeded values "
              f"kept), first 10: {missing[:10]}; {len(unexpected)} file "
              f"keys not in the model, first 10: {unexpected[:10]}")
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()}}, args.out)
    print(f"wrote converted checkpoint to {args.out}")
    return missing, unexpected


if __name__ == "__main__":
    main()
