"""The one generator of the benchmark's traffic: frames and training
batches from a traffic file's parameters and a seed.

A calibration is a KITTI ``calib.txt`` (P2, P3 and the velodyne-to-camera
``Tr``) with its raw image size. It reaches the model through the test-time
geometry of the SemanticKITTI pipeline: the raw image resized to the
model's input width, cropped from the bottom, no flip and no rotation; the
cameras' rotation and translation from the inverse of ``Tr``; the 3x4 P2 and
P3 as intrinsics; the stereo ``calib`` = fx x baseline, with the baseline
read off P2 and P3 (ref: loading_semkitti.py:138-166,
semantic_kitti_lss_dataset.py:225-229).

Images are seeded normalised pixels, N(0, 1). Labels draw each voxel's
class from the traffic's class frequencies and mark a share of the voxels
ignore (255); LiDAR depth is a sparse map of returns uniform over the
depth bins. Every seed gets the same sizes; only the values differ.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .weights import generator

FRAME_STREAM, BATCH_STREAM, MASK_STREAM = 1, 2, 3


def camera_geometry(calib: Dict, input_size: Sequence[int]) -> Dict:
    """One calibration's geometry tensors for a batch of 1 (CPU, float32)."""
    h_in, w_in = input_size
    raw_h, raw_w = calib["image_size"]
    p2 = np.asarray(calib["P2"], np.float64).reshape(3, 4)
    p3 = np.asarray(calib["P3"], np.float64).reshape(3, 4)
    tr = np.eye(4)
    tr[:3] = np.asarray(calib["Tr"], np.float64).reshape(3, 4)
    resize = float(w_in) / float(raw_w)
    new_h = int(raw_h * resize)
    crop = (int(max(0, int(raw_w * resize) - w_in) / 2), new_h - h_in)
    post_rot = np.eye(3, dtype=np.float32)
    post_rot[:2, :2] = np.eye(2, dtype=np.float32) * resize
    post_tran = np.zeros(3, np.float32)
    post_tran[:2] = -np.asarray(crop, np.float32)
    cam2lidar = np.linalg.inv(tr)
    baseline = p3[0, 3] / -p3[0, 0] - p2[0, 3] / -p2[0, 0]

    def both(a):
        return torch.from_numpy(np.stack([a, a]).astype(np.float32))[None]

    return {
        "rots": both(cam2lidar[:3, :3]),
        "trans": both(cam2lidar[:3, 3]),
        "intrins": torch.from_numpy(np.stack([p2, p3]).astype(np.float32))[
            None],
        "post_rots": both(post_rot),
        "post_trans": both(post_tran),
        "bda": torch.eye(3)[None],
        "calib": torch.tensor([np.float32(p2[0, 0] * baseline)]),
    }


def geometry_batch(traffic: Dict, input_size, batch: int, index: int,
                   device) -> Dict[str, torch.Tensor]:
    """The geometry of request ``index`` (calibrations switch every
    ``switch_every`` requests, 0: never) for ``batch`` frames."""
    cals = traffic["calibrations"]
    every = traffic.get("switch_every", 0)
    cal = cals[(index // every) % len(cals)] if every else cals[0]
    one = camera_geometry(cal, input_size)
    return {k: v.expand((batch,) + tuple(v.shape[1:])).contiguous().to(device)
            for k, v in one.items()}


def calibration_period(traffic: Dict) -> int:
    """Requests after which the calibration sequence repeats."""
    every = traffic.get("switch_every", 0)
    return every * len(traffic["calibrations"]) if every else 1


def frame_pool(traffic: Dict, input_size, seed: int, device) -> List:
    """``pool`` image tensors [batch, 2, H, W, 3], float32, drawn on
    ``device`` from ``seed`` in one call, handed back in pinned host memory
    (the frames a camera would hand over)."""
    n, b = traffic["pool"], traffic["batch"]
    h, w = input_size
    imgs = torch.randn((n, b, 2, h, w, 3), device=device,
                       generator=generator(seed, device, FRAME_STREAM))
    host = imgs.cpu()
    if torch.cuda.is_available() and host.device.type == "cpu" \
            and torch.device(device).type == "cuda":
        host = host.pin_memory()
    return list(host.unbind(0))


def train_batches(traffic: Dict, input_size, label_shape, dbound, seed: int,
                  device) -> List[Dict[str, torch.Tensor]]:
    """``batches`` training batches on ``device``: images, the geometry,
    ``gt_occ`` [B, *label_shape] and a sparse ``gt_depth`` [B, 2, H, W]."""
    gen = generator(seed, device, BATCH_STREAM)
    b, h, w = traffic["batch"], input_size[0], input_size[1]
    freqs = torch.tensor(traffic["label_class_frequencies"],
                         dtype=torch.float64, device=device)
    lo, hi, _ = dbound
    out = []
    for i in range(traffic["batches"]):
        batch = geometry_batch(traffic, input_size, b, i, device)
        batch["imgs"] = torch.randn((b, 2, h, w, 3), device=device,
                                    generator=gen)
        n = b * int(np.prod(label_shape))
        occ = torch.multinomial(freqs, n, replacement=True, generator=gen)
        ignore = torch.rand(n, device=device, generator=gen) \
            < traffic["label_ignore_share"]
        batch["gt_occ"] = torch.where(ignore, 255, occ).to(torch.int32) \
            .reshape((b,) + tuple(label_shape))
        hit = torch.rand((b, 2, h, w), device=device, generator=gen) \
            < traffic["depth_density"]
        depth = lo + (hi - lo) * torch.rand((b, 2, h, w), device=device,
                                            generator=gen)
        batch["gt_depth"] = depth * hit
        out.append(batch)
    return out


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The DropPath and dropout generator of training step ``step``."""
    return generator(seed * 4096 + step, device, MASK_STREAM)
