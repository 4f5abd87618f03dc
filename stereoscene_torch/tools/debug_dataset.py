"""Dataset smoke test and debug dumps, the port's counterpart of
``tools/debug_dataset.py`` (the reference tools/debug_dataset.py): runs the
first frames of a split through the pipeline, prints each key's shape,
dtype and range, and with ``--out`` saves each frame's left image (above
its LiDAR depth overlay) as a PNG.

    python -m stereoscene_torch.tools.debug_dataset CONFIG \\
        [--split train] [--num-frames 3] [--out DIR]

The same arguments and lines as the JAX tool, and one more line first
where the config loads LiDAR: the route of the depth scatter (``native``,
the g++ host library, or ``numpy``; ``data.pipeline.lidar_route``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..data import PipelineConfig, SemanticKittiIndex, SemanticKittiPipeline
from ..data.pipeline import IMG_MEAN, IMG_STD, lidar_route


def build(cfg, split: str, is_train: bool):
    """(the split's index, its pipeline) from a reference-schema config,
    as the JAX tools build them."""
    data_cfg = cfg["data"][split]
    index = SemanticKittiIndex(
        data_root=data_cfg["data_root"], ann_file=data_cfg["ann_file"],
        split=split, lidar_root=cfg.get("lidar_root"),
        lidarseg_root=cfg.get("lidarseg_root"))
    pipe = SemanticKittiPipeline(PipelineConfig(
        input_size=tuple(cfg["data_config"]["input_size"]),
        is_train=is_train,
        load_lidar_depth=cfg.get("lidar_root") is not None,
        point_cloud_range=tuple(cfg["point_cloud_range"])))
    return index, pipe


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--split", default="train")
    p.add_argument("--num-frames", type=int, default=3)
    p.add_argument("--out", default=None, help="save overlay PNGs here")
    args = p.parse_args(argv)

    cfg = Config.fromfile(args.config)
    index, pipe = build(cfg, args.split, args.split == "train")
    if cfg.get("lidar_root") is not None:
        print(f"LiDAR depth route: {lidar_route()}")
    print(f"{len(index)} frames in split {args.split}")
    if len(index) == 0:
        return
    for i in range(min(args.num_frames, len(index))):
        sample = pipe(index[i])
        print(f"--- frame {index[i].sequence}/{index[i].frame_id}")
        for k, v in sample.items():
            v = np.asarray(v)
            print(f"  {k}: {v.shape} {v.dtype} [{v.min():.3f}, "
                  f"{v.max():.3f}]" if v.size else f"  {k}: {v.shape}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            from PIL import Image

            img = sample["imgs"][0] * IMG_STD + IMG_MEAN
            img = np.clip(img, 0, 255).astype(np.uint8)
            if "gt_depth" in sample:
                overlay = img.copy()
                overlay[sample["gt_depth"][0] > 0] = [255, 0, 0]
                img = np.concatenate([img, overlay], axis=0)
            path = os.path.join(args.out, f"{index[i].frame_id}.png")
            Image.fromarray(img).save(path)
            print(f"  wrote {path}")


if __name__ == "__main__":
    main()
