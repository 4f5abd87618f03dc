"""Offline SemanticKITTI voxel-label preprocessing CLI, the port's
counterpart of ``tools/preprocess_kitti.py`` (the same arguments).

Equivalent of the reference ``process_kitti.sh`` ->
``semantic_kitti_preprocess.py``: unpack packed voxel labels + invalid
masks, remap raw ids to the 20 train classes, write <frame>_1_1.npy files
(optionally majority-pooled multiscale variants) under
``<out-root>/labels/<seq>/``, the ``ann_file`` layout the train and eval
CLIs read.

    python -m stereoscene_torch.tools.preprocess_kitti \\
        --kitti-root KITTI --out-root OUT [--sequences 00 01] \\
        [--scales 1_1 1_2]
"""

from __future__ import annotations

import argparse

from ..data.preprocess import ALL_SEQUENCES, process_sequences


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kitti-root", required=True,
                   help="dir containing dataset/sequences/<seq>/voxels")
    p.add_argument("--out-root", required=True)
    p.add_argument("--sequences", nargs="*", default=None)
    p.add_argument("--scales", nargs="*", default=["1_1"],
                   help="e.g. 1_1 1_2 1_4 (majority-pooled downscales)")
    args = p.parse_args(argv)

    n = process_sequences(
        args.kitti_root,
        args.out_root,
        sequences=args.sequences or ALL_SEQUENCES,
        scales=args.scales,
    )
    print(f"wrote {n} label files to {args.out_root}")


if __name__ == "__main__":
    main()
