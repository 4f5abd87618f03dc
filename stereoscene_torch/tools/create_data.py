"""Dataset preparation dispatcher, the port's counterpart of
``tools/create_data.py`` (the reference tools/create_data.py shape), with
its arguments:

    python -m stereoscene_torch.tools.create_data DATASET --root ROOT \\
        --out OUT [--scales 1_1 ...] [--extra-tag TAG]

- ``semantickitti``: the packed voxel labels of every sequence under
  ``ROOT/dataset/sequences`` into ``OUT/labels/<seq>/<frame>_<scale>.npy``
  (``data.preprocess``, the native host library where it builds);
- ``nuscenes``: checks ``ROOT/nuscenes_infos_train.pkl`` (mmdet3d info
  pickles, made with the nuScenes devkit offline) and counts its samples
  (``data.nuscenes``);
- ``kitti``, ``lyft``, ``waymo``: the repo's ``tools/data_converter``
  (detection info pickles and FOV-reduced clouds; the Lyft SDK adapter;
  TFRecord to KITTI, which needs tensorflow and waymo_open_dataset), as
  the JAX tool calls it: that package imports nothing of either model
  package, and is run from a checkout of the repo.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _converters():
    """``tools.data_converter`` of the checkout this package sits in."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import tools.data_converter as converters

    return converters


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("dataset", choices=["semantickitti", "nuscenes", "kitti",
                                       "lyft", "waymo"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scales", nargs="*", default=["1_1"])
    p.add_argument("--extra-tag", default=None)
    args = p.parse_args(argv)

    if args.dataset == "semantickitti":
        from ..data.preprocess import process_sequences

        n = process_sequences(args.root, args.out, scales=args.scales)
        print(f"wrote {n} label files")
    elif args.dataset == "kitti":
        _converters()
        from tools.data_converter.kitti_converter import (
            create_kitti_info_file,
            create_reduced_point_cloud,
        )

        written = create_kitti_info_file(
            args.root, pkl_prefix=args.extra_tag or "kitti",
            save_path=args.out)
        for split, path in written.items():
            print(f"kitti info {split}: {path}")
        for split in ("train", "val"):
            if split in written:
                n = create_reduced_point_cloud(args.root, written[split])
                print(f"reduced clouds ({split}): {n}")
    elif args.dataset == "lyft":
        raise SystemExit(
            "lyft: pass a devkit adapter to tools.data_converter."
            "lyft_converter.create_lyft_infos (the SDK is an offline-host "
            "dep; see that module's docstring)")
    elif args.dataset == "waymo":
        _converters()
        from tools.data_converter.waymo_converter import Waymo2KITTI

        Waymo2KITTI(args.root, args.out).convert()
    else:
        from ..data.nuscenes import NuScenesIndex

        info = os.path.join(args.root, "nuscenes_infos_train.pkl")
        if not os.path.exists(info):
            raise SystemExit(
                f"missing {info}; generate info pickles with the nuScenes "
                "devkit offline (mmdet3d create_data format)")
        idx = NuScenesIndex(info)
        print(f"validated {len(idx)} samples in {info}")


if __name__ == "__main__":
    main()
