"""The seeded synthetic batches of the port's tools: stereo frames at the
flagship calibration (the counterpart of ``bench.py:55
make_flagship_batch``) with the training targets that the train-step
bench adds to them (``tools/bench_train.py:63-71``), and the highres
slice's frame (the counterpart of ``__graft_entry__.py:43 _make_batch``).

``frame`` draws its images from a ``torch.Generator`` seeded with
``seed``, ``train_frame`` its targets from ``numpy.random.RandomState``,
as the JAX train bench does. ``slice_frame`` is ``_make_batch`` exactly:
fx = W / 2, calib = W x 0.54, images and targets from one
``RandomState(0)``, a sparse depth of 10 m.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FX, BASELINE = 707.0, 0.54  # the flagship calibration (bench.py:55-82)


def _geometry(b: int, h: int, w: int, fx: float, calib: float) -> Dict:
    """The rig of both makers: a pinhole at focal ``fx`` with its principal
    point at the image's centre, the camera-to-ego rotation, no
    augmentation, the stereo ``calib`` (focal x baseline)."""
    intrin = torch.zeros(b, 2, 3, 4)
    intrin[..., 0, 0] = intrin[..., 1, 1] = fx
    intrin[..., 0, 2], intrin[..., 1, 2] = w / 2.0, h / 2.0
    intrin[..., 2, 2] = 1.0
    rot = torch.tensor([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    return {
        "rots": rot.expand(b, 2, 3, 3).clone(),
        "trans": torch.zeros(b, 2, 3),
        "intrins": intrin,
        "post_rots": torch.eye(3).expand(b, 2, 3, 3).clone(),
        "post_trans": torch.zeros(b, 2, 3),
        "bda": torch.eye(3).expand(b, 3, 3).clone(),
        "calib": torch.full((b,), calib),
    }


def frame(cfg, device, seed: int = 0, b: int = 1) -> Dict[str, torch.Tensor]:
    """``b`` stereo frames at the flagship calibration with seeded images
    [b, 2, H, W, 3], on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    h, w = cfg.input_size
    batch = {"imgs": torch.randn(b, 2, h, w, 3, generator=gen),
             **_geometry(b, h, w, FX, FX * BASELINE)}
    return {k: v.to(device) for k, v in batch.items()}


def train_frame(cfg, device, seed: int = 0, b: int = 1,
                target_seed: int = 1) -> Dict[str, torch.Tensor]:
    """``frame`` with the JAX train bench's targets: ``gt_occ`` [b, 2X, 2Y,
    2Z] of ints in [0, 20) and a sparse ``gt_depth`` [b, 2, H, W] of 20 m
    on 5% of the pixels, both from ``RandomState(target_seed)``."""
    batch = frame(cfg, device, seed, b)
    rng = np.random.RandomState(target_seed)
    x, y, z = cfg.grid_shape
    h, w = cfg.input_size
    gt_occ = rng.randint(0, 20, (b, 2 * x, 2 * y, 2 * z))
    gt_depth = (rng.rand(b, 2, h, w) < 0.05).astype(np.float32) * 20.0
    batch["gt_occ"] = torch.from_numpy(gt_occ).to(device)
    batch["gt_depth"] = torch.from_numpy(gt_depth).to(device)
    return batch


def slice_frame(cfg, device, b: int = 1) -> Dict[str, torch.Tensor]:
    """``__graft_entry__._make_batch``'s frames, which the JAX highres
    slice tool times: fx = W / 2, calib = W x 0.54, then from one
    ``RandomState(0)`` the images, ``gt_occ`` [b, 2X, 2Y, 2Z] of ints in
    [0, 20) and a sparse ``gt_depth`` [b, 2, H, W] of 10 m on 5% of the
    pixels."""
    rng = np.random.RandomState(0)
    h, w = cfg.input_size
    x, y, z = cfg.grid_shape
    imgs = rng.randn(b, 2, h, w, 3).astype(np.float32)
    gt_occ = rng.randint(0, 20, (b, 2 * x, 2 * y, 2 * z))
    gt_depth = (rng.rand(b, 2, h, w) < 0.05).astype(np.float32) * 10.0
    batch = {"imgs": torch.from_numpy(imgs),
             **_geometry(b, h, w, w / 2.0, w * BASELINE),
             "gt_occ": torch.from_numpy(gt_occ),
             "gt_depth": torch.from_numpy(gt_depth)}
    return {k: v.to(device) for k, v in batch.items()}
