"""Augmentations, port of ``stereoscene_tpu/data/augment.py``.

- ``grid_mask``: structured grid dropout on input images
  (ref: models/utils/grid_mask.py:70-124; constructed with rotate=1,
  ratio=0.5, mode=1, prob=0.7 at bevdepth_occupancy.py:36-37 and disabled
  by default), on the device inside the training forward. The JAX package
  draws from ``jax.random``; the port draws the same four quantities
  (apply, d, sx, sy) from a ``torch.Generator``, so the masks match for
  equal draws (``grid_mask_from_draws``), not bit for bit from one seed.
- ``bev_transform_matrix``: the BDA rotation/flip matrix about the grid
  center (ref: datasets/pipelines/loading_semkitti.py:304-356).
- ``bev_transform_labels``: the host-side voxel-label counterpart
  (nearest-neighbour rotate with scipy, then flips).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import parallel


def grid_mask_draws(n: int, generator, device,
                    d_range: Tuple[int, int] = (96, 224),
                    prob: float = 0.7, groups: int = 1):
    """(apply bool, d, sx, sy int64), each [n], drawn from ``generator``
    (on its device). As ``models.layers.keep_mask``: ``n`` is ``groups``
    blocks of this rank's images, and over W ranks the draw is for the
    global batch, of which this rank keeps its slice of each block (the
    data group's: the space ranks of one sample keep the same draws)."""
    gen_device = generator.device if generator is not None else device
    w, r = parallel.data_size(), parallel.data_rank()
    per = n // groups

    def draw(fn):
        out = fn((groups, w * per))
        return out[:, r * per:(r + 1) * per].reshape(n).to(device)

    kw = dict(generator=generator, device=gen_device)
    apply = draw(lambda s: torch.rand(s, **kw) < prob)
    d = draw(lambda s: torch.randint(d_range[0], d_range[1], s, **kw))
    sx = draw(lambda s: torch.randint(0, d_range[1], s, **kw))
    sy = draw(lambda s: torch.randint(0, d_range[1], s, **kw))
    return apply, d, sx, sy


def grid_mask_from_draws(h: int, w: int, apply, d, sx, sy,
                         ratio: float = 0.5, mode: int = 1) -> torch.Tensor:
    """The [B, H, W] bool keep mask for the draws: squares of side
    ceil(ratio * d) of a grid of period d, offset by (sx, sy); mode 1 keeps
    the squares, mode 0 their complement; all True where ``apply`` is
    False."""
    dev = d.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    dd = d[:, None, None]
    keep_len = torch.ceil(ratio * d.float()).long()[:, None, None]
    in_sq = (((ys + sy[:, None, None]) % dd) < keep_len) & (
        ((xs + sx[:, None, None]) % dd) < keep_len)
    mask = in_sq if mode == 1 else ~in_sq
    return torch.where(apply[:, None, None], mask, torch.ones_like(mask))


def grid_mask(imgs: torch.Tensor, generator=None,
              d_range: Tuple[int, int] = (96, 224), ratio: float = 0.5,
              prob: float = 0.7, mode: int = 1,
              groups: int = 1) -> torch.Tensor:
    """Grid dropout on channels-first [B, C, H, W] images, one draw per
    image from ``generator``."""
    b, _, h, w = imgs.shape
    draws = grid_mask_draws(b, generator, imgs.device, d_range, prob, groups)
    mask = grid_mask_from_draws(h, w, *draws, ratio=ratio, mode=mode)
    return imgs * mask[:, None].to(imgs.dtype)


def bev_transform_matrix(
    rotate_deg: float,
    flip_dx: bool,
    flip_dy: bool,
    transform_center: np.ndarray,
) -> np.ndarray:
    """4x4 BDA matrix: translate-to-center, flips, rotation, translate-back
    (ref loading_semkitti.py:304-341)."""
    t_norm = np.eye(4, dtype=np.float32)
    t_norm[:3, 3] = -np.asarray(transform_center, np.float32)
    t_denorm = np.eye(4, dtype=np.float32)
    t_denorm[:3, 3] = np.asarray(transform_center, np.float32)

    a = np.deg2rad(rotate_deg)
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = np.cos(a)
    rot[0, 1] = -np.sin(a)
    rot[1, 0] = np.sin(a)
    rot[1, 1] = np.cos(a)

    flip = np.eye(4, dtype=np.float32)
    if flip_dx:
        flip[0, 0] = -1
    if flip_dy:
        flip[1, 1] = -1

    return t_denorm @ flip @ rot @ t_norm


def bev_transform_labels(
    labels: np.ndarray, rotate_deg: float, flip_dx: bool, flip_dy: bool
) -> np.ndarray:
    """Host-side voxel-label counterpart of the BDA matrix (nearest-neighbor
    rotation about the XY grid center, fill 255; then flips).
    ref loading_semkitti.py:342-356"""
    import scipy.ndimage

    out = labels.astype(np.uint8)
    if not np.isclose(rotate_deg, 0):
        out = scipy.ndimage.rotate(
            out, rotate_deg, axes=(0, 1), reshape=False, order=0,
            mode="constant", cval=255,
        )
    if flip_dy:
        out = out[:, ::-1]
    if flip_dx:
        out = out[::-1]
    return np.ascontiguousarray(out)
