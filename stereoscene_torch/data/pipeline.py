"""Host-side per-frame pipeline: images, augmentation homography, voxel
labels -> the model's batch sample.

Port of ``stereoscene_tpu/data/pipeline.py`` (a copy: the port imports
nothing of the JAX package), the rebuild of the reference stages (numpy and
PIL on the host CPU):

- ``LoadMultiViewImageFromFiles_SemanticKitti``
  (ref: datasets/pipelines/loading_semkitti.py:76-302): resize to the
  configured input size (+ optional train-time jitter), crop, flip, rotate;
  track the 3x3 post-augmentation homography (post_rot/post_tran); both eyes
  share one augmentation draw (ref :248); mmlab mean/std normalization
  (ref: loading_bevdet.py:19-34).
- ``LoadSemKittiAnnotation`` (ref :358-402): voxel labels, with the BEV
  augmentation matrix ``bda`` the identity.

The training-data branches of the JAX pipeline (BEV augmentation, CRP
relation labels, LiDAR depth maps) are not ported yet: a config that turns
one on raises ``NotImplementedError``.

The output dict uses plain numpy arrays; ``loader.BatchLoader`` stacks them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .semantic_kitti import FrameInfo

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)  # RGB
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclasses.dataclass
class PipelineConfig:
    """The JAX package's ``PipelineConfig``: the same fields and defaults."""

    input_size: Tuple[int, int] = (384, 1280)  # (H, W)
    resize: Tuple[float, float] = (0.0, 0.0)
    rot: Tuple[float, float] = (0.0, 0.0)
    flip: bool = False
    crop_h: Tuple[float, float] = (0.0, 0.0)
    resize_test: float = 0.0
    is_train: bool = False
    load_lidar_depth: bool = False
    max_points: int = 65536  # static shape for points_occ/points_uv
    point_cloud_range: Tuple[float, ...] = (0, -25.6, -2, 51.2, 25.6, 4.4)
    apply_bda: bool = False
    bda_rot_lim: Tuple[float, float] = (-22.5, 22.5)
    bda_flip_dx_ratio: float = 0.5
    bda_flip_dy_ratio: float = 0.5
    relation_label_shape: Optional[Tuple[int, int, int]] = None


def sample_augmentation(
    cfg: PipelineConfig, raw_h: int, raw_w: int, rng: np.random.RandomState
):
    """Resize/crop/flip/rotate draw (ref loading_semkitti.py:138-166)."""
    f_h, f_w = cfg.input_size
    if cfg.is_train:
        resize = float(f_w) / float(raw_w) + rng.uniform(*cfg.resize)
        new_w, new_h = int(raw_w * resize), int(raw_h * resize)
        crop_h = int((1 - rng.uniform(*cfg.crop_h)) * new_h) - f_h
        crop_w = int(rng.uniform(0, max(0, new_w - f_w)))
        crop = (crop_w, crop_h, crop_w + f_w, crop_h + f_h)
        flip = bool(cfg.flip and rng.choice([0, 1]))
        rotate = rng.uniform(*cfg.rot)
    else:
        resize = float(f_w) / float(raw_w) + cfg.resize_test
        new_w, new_h = int(raw_w * resize), int(raw_h * resize)
        crop_h = int((1 - np.mean(cfg.crop_h)) * new_h) - f_h
        crop_w = int(max(0, new_w - f_w) / 2)
        crop = (crop_w, crop_h, crop_w + f_w, crop_h + f_h)
        flip, rotate = False, 0.0
    return resize, (new_w, new_h), crop, flip, rotate


def _rot2(deg: float) -> np.ndarray:
    h = deg / 180.0 * np.pi
    return np.array(
        [[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], np.float32
    )


def transform_image(img, resize, resize_dims, crop, flip, rotate):
    """Apply the augmentation to a PIL image and return (img, post_rot2,
    post_tran2) — the 2D homography mapping raw pixels to augmented pixels.
    ref: loading_semkitti.py:106-136
    """
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        from PIL import Image

        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)

    post_rot = np.eye(2, dtype=np.float32) * resize
    post_tran = -np.array(crop[:2], np.float32)
    if flip:
        a = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = a @ post_rot
        post_tran = a @ post_tran + b
    a = _rot2(rotate)
    b = np.array(
        [(crop[2] - crop[0]) / 2.0, (crop[3] - crop[1]) / 2.0], np.float32
    )
    b = a @ (-b) + b
    post_rot = a @ post_rot
    post_tran = a @ post_tran + b
    return img, post_rot, post_tran


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> normalized float32 HWC."""
    return (img.astype(np.float32) - IMG_MEAN) / IMG_STD


class SemanticKittiPipeline:
    """FrameInfo -> model batch sample (numpy dict): imgs [2, H, W, 3]
    normalised, rots / trans / intrins / post_rots / post_trans per eye,
    bda [3, 3], calib, and gt_occ where the frame has labels.

    ``BatchLoader`` runs this from several worker threads and passes a
    deterministic per-sample ``seed``, so every augmentation draw is
    independent of thread scheduling; ``self.rng`` serves direct calls."""

    def __init__(self, cfg: PipelineConfig, seed: int = 0):
        off = [name for name, on in (
            ("apply_bda", cfg.apply_bda and cfg.is_train),
            ("relation_label_shape", cfg.relation_label_shape is not None),
            ("load_lidar_depth", cfg.load_lidar_depth)) if on]
        if off:
            raise NotImplementedError(
                f"stereoscene_torch does not port the training-data "
                f"branches {off} yet")
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)

    def __call__(
        self, frame: FrameInfo, seed: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        rng = self.rng if seed is None else np.random.RandomState(seed)
        img_l = Image.open(frame.img_left_path).convert("RGB")
        img_r = Image.open(frame.img_right_path).convert("RGB")

        # one augmentation draw shared by both eyes (ref :248)
        aug = sample_augmentation(cfg, img_l.height, img_l.width, rng)
        resize, resize_dims, crop, flip, rotate = aug

        imgs, post_rots, post_trans, rots, trans, intrins = [], [], [], [], [], []
        cam2lidar = np.linalg.inv(frame.T_velo_2_cam)
        for img, p_mat in ((img_l, frame.P2), (img_r, frame.P3)):
            img_t, pr2, pt2 = transform_image(
                img, resize, resize_dims, crop, flip, rotate
            )
            post_rot = np.eye(3, dtype=np.float32)
            post_tran = np.zeros(3, np.float32)
            post_rot[:2, :2] = pr2
            post_tran[:2] = pt2
            imgs.append(normalize_image(np.asarray(img_t)))
            post_rots.append(post_rot)
            post_trans.append(post_tran)
            rots.append(cam2lidar[:3, :3].astype(np.float32))
            trans.append(cam2lidar[:3, 3].astype(np.float32))
            intrins.append(p_mat.astype(np.float32))

        sample: Dict[str, np.ndarray] = {
            "imgs": np.stack(imgs),
            "rots": np.stack(rots),
            "trans": np.stack(trans),
            "intrins": np.stack(intrins),
            "post_rots": np.stack(post_rots),
            "post_trans": np.stack(post_trans),
            "bda": np.eye(3, dtype=np.float32),
            "calib": np.float32(frame.calib),
        }
        if frame.voxel_path is not None:
            sample["gt_occ"] = np.load(frame.voxel_path).astype(np.int32)
        return sample
