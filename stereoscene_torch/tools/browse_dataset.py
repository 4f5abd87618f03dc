"""Browse pipeline outputs as pictures, the port's counterpart of
``tools/misc/browse_dataset.py`` (the reference tools/misc/
browse_dataset.py): one PNG a frame with the left and right inputs, the
LiDAR depth over the left image and the voxel labels seen from above.

    python -m stereoscene_torch.tools.browse_dataset CONFIG \\
        [--split train] [--num-frames 5] [--out browse]

The same arguments, figure and file names as the JAX tool (matplotlib,
Agg backend); the pipeline runs in eval mode, as there.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..data.pipeline import IMG_MEAN, IMG_STD
from .debug_dataset import build

# the official SemanticKITTI class colours (a copy of tools/visualize.py's,
# ref tools/visualization.py:138-160)
PALETTE = np.array([
    [0, 0, 0], [100, 150, 245], [100, 230, 245], [30, 60, 150],
    [80, 30, 180], [100, 80, 250], [255, 30, 30], [255, 40, 200],
    [150, 30, 90], [255, 0, 255], [255, 150, 255], [75, 0, 75],
    [175, 0, 75], [255, 200, 0], [255, 120, 50], [0, 175, 0],
    [135, 60, 0], [150, 240, 80], [255, 240, 150], [255, 0, 0],
], dtype=np.float32) / 255.0


def _denorm(img: np.ndarray) -> np.ndarray:
    return np.clip(img * IMG_STD + IMG_MEAN, 0, 255).astype(np.uint8)


def render_frame(sample: dict, out_path: str) -> None:
    """The 2 x 2 figure of one sample, saved to ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(14, 8), dpi=100)
    left = _denorm(np.asarray(sample["imgs"][0]))
    right = _denorm(np.asarray(sample["imgs"][1]))
    axes[0, 0].imshow(left)
    axes[0, 0].set_title("left")
    axes[0, 1].imshow(right)
    axes[0, 1].set_title("right")
    axes[1, 0].imshow(left)
    depth = np.asarray(sample.get("gt_depth", np.zeros(left.shape[:2])))
    if depth.ndim == 3:
        depth = depth[0]
    ys, xs = np.nonzero(depth > 0)
    axes[1, 0].scatter(xs, ys, c=depth[ys, xs], s=1, cmap="turbo")
    axes[1, 0].set_title("lidar depth overlay")
    gt = sample.get("gt_occ")
    if gt is not None and np.asarray(gt).ndim == 3:
        gt = np.asarray(gt)
        bev = np.where((gt > 0) & (gt != 255), gt, 0).max(axis=2)
        axes[1, 1].imshow(PALETTE[bev % 20].transpose(1, 0, 2),
                          origin="lower")
        axes[1, 1].set_title("voxel GT (BEV max)")
    for ax in axes.flat:
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--split", default="train")
    p.add_argument("--num-frames", type=int, default=5)
    p.add_argument("--out", default="browse")
    args = p.parse_args(argv)

    index, pipeline = build(Config.fromfile(args.config), args.split, False)
    os.makedirs(args.out, exist_ok=True)
    for i in range(min(args.num_frames, len(index))):
        out_path = os.path.join(args.out, f"frame{i:04d}.png")
        render_frame(pipeline(index[i]), out_path)
        print("wrote", out_path)


if __name__ == "__main__":
    main()
