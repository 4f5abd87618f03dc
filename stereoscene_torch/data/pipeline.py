"""Host-side per-frame pipeline: images, augmentation homography, LiDAR
depth, voxel labels -> the model's batch sample.

Port of ``stereoscene_tpu/data/pipeline.py`` (a copy: the port imports
nothing of the JAX package), the rebuild of the reference stages (numpy and
PIL on the host CPU):

- ``LoadMultiViewImageFromFiles_SemanticKitti``
  (ref: datasets/pipelines/loading_semkitti.py:76-302): resize to the
  configured input size (+ optional train-time jitter), crop, flip, rotate;
  track the 3x3 post-augmentation homography (post_rot/post_tran); both eyes
  share one augmentation draw (ref :248); mmlab mean/std normalization
  (ref: loading_bevdet.py:19-34).
- ``LoadSemKittiAnnotation`` (ref :358-402): voxel labels + BEV aug matrix
  (bda; identity when apply_bda=False as in the active config; with it, a
  4x4 matrix and the labels rotated and flipped to match), and the CRP
  relation labels (ref voxel_labels.py:66 CreateRelationLabels) when
  ``relation_label_shape`` is set.
- ``CreateDepthFromLiDAR`` (ref: datasets/pipelines/occ_to_depth.py:190-345):
  project the velodyne points through each camera, keep the in-image
  points, write them far first so that the NEAREST return wins each pixel,
  and produce the sparse depth map, the labeled point set (points_occ),
  their normalized uv (points_uv) and an image-seg map. Numpy only: the JAX
  package's optional native scatter is not ported.

The output dict uses plain numpy arrays; ``loader.BatchLoader`` stacks them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .augment import bev_transform_labels, bev_transform_matrix
from .labels import (
    compute_cp_mega_matrix,
    downsample_label_monoscene,
    seg_remap_lut,
)
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
    # BEV data augmentation (ref loading_semkitti.py:358-402; apply_bda
    # defaults False in the active config)
    apply_bda: bool = False
    bda_rot_lim: Tuple[float, float] = (-22.5, 22.5)
    bda_flip_dx_ratio: float = 0.5
    bda_flip_dy_ratio: float = 0.5
    # CRP relation-label GT (ref voxel_labels.py:66 CreateRelationLabels):
    # when set, gt_occ is MonoScene-downsampled to this shape and the
    # 4-way voxel<->mega-voxel relation matrix is emitted as
    # sample['cp_mega_matrix'] for the crp_relation_loss.
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


def project_lidar_to_image(
    points: np.ndarray,
    rot: np.ndarray,
    tran: np.ndarray,
    intrin: np.ndarray,
    post_rot: np.ndarray,
    post_tran: np.ndarray,
) -> np.ndarray:
    """LiDAR xyz -> (u, v, depth) in the augmented image.

    ref: occ_to_depth.py:215-233 (ego -> camera via inverse cam2lidar,
    camera -> raw pixels via the 3x4 P-matrix, then the post homography).
    """
    cam = (np.linalg.inv(rot) @ (points - tran).T).T
    homo = np.concatenate([cam, np.ones((len(cam), 1), cam.dtype)], axis=1)
    pix = (intrin @ homo.T).T
    depth = pix[:, 2:3]
    uv = pix[:, :2] / np.maximum(np.abs(depth), 1e-6) * np.sign(depth)
    uv = (post_rot[:2, :2] @ uv.T).T + post_tran[:2]
    return np.concatenate([uv, depth], axis=1)


class SemanticKittiPipeline:
    """FrameInfo -> model batch sample (numpy dict): imgs [2, H, W, 3]
    normalised, rots / trans / intrins / post_rots / post_trans per eye,
    bda ([3, 3] identity, or [4, 4] under ``apply_bda`` in training), calib,
    gt_occ where the frame has labels (with cp_mega_matrix under
    ``relation_label_shape``), and with ``load_lidar_depth`` the LiDAR
    products of ``_lidar_products`` where the frame has a scan.

    ``BatchLoader`` runs this from several worker threads and passes a
    deterministic per-sample ``seed``, so every augmentation draw is
    independent of thread scheduling; ``self.rng`` serves direct calls."""

    def __init__(self, cfg: PipelineConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self._seg_lut = seg_remap_lut()

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

        gt_occ = (
            np.load(frame.voxel_path).astype(np.int32)
            if frame.voxel_path is not None
            else None
        )

        if cfg.apply_bda and cfg.is_train:
            # drawn after the image augmentation, from the same generator
            rot_deg = rng.uniform(*cfg.bda_rot_lim)
            flip_dx = rng.rand() < cfg.bda_flip_dx_ratio
            flip_dy = rng.rand() < cfg.bda_flip_dy_ratio
            pc = np.asarray(cfg.point_cloud_range, np.float32)
            center = (pc[:3] + pc[3:]) / 2.0
            bda4 = bev_transform_matrix(rot_deg, flip_dx, flip_dy, center)
            sample["bda"] = bda4.astype(np.float32)  # [4, 4]
            if gt_occ is not None:
                gt_occ = bev_transform_labels(
                    gt_occ.astype(np.uint8), rot_deg, flip_dx, flip_dy
                ).astype(np.int32)

        if gt_occ is not None:
            sample["gt_occ"] = gt_occ
            if cfg.relation_label_shape is not None:
                shape = tuple(cfg.relation_label_shape)
                ds = tuple(g // s for g, s in zip(gt_occ.shape, shape))
                target = downsample_label_monoscene(
                    gt_occ.astype(np.uint8), ds
                )
                sample["cp_mega_matrix"] = compute_cp_mega_matrix(target)
        if cfg.load_lidar_depth and frame.lidar_path is not None:
            sample.update(self._lidar_products(frame, sample))
        return sample

    def _lidar_products(self, frame: FrameInfo,
                        sample) -> Dict[str, np.ndarray]:
        """Sparse depth maps + labeled points (ref occ_to_depth.py:235-345):
        gt_depth and img_seg [2, H, W] float32 (0 where no point lands),
        points_occ [max_points, 4] (ego xyz and train-id label of the left
        camera's in-image points, zero-padded), points_uv [max_points, 3]
        (their uv in [-1, 1] and depth) and points_count."""
        cfg = self.cfg
        h, w = cfg.input_size
        pts = np.fromfile(frame.lidar_path,
                          dtype=np.float32).reshape(-1, 4)[:, :3]
        if frame.lidarseg_path is not None:
            seg = np.fromfile(frame.lidarseg_path, dtype=np.uint32) & 0xFFFF
            seg = self._seg_lut[seg.astype(np.int64)].astype(np.float32)
        else:
            seg = np.zeros((len(pts),), np.float32)

        out: Dict[str, np.ndarray] = {}
        depth_maps = []
        seg_maps = []
        for cam in range(2):
            uvd = project_lidar_to_image(
                pts,
                sample["rots"][cam],
                sample["trans"][cam],
                sample["intrins"][cam],
                sample["post_rots"][cam],
                sample["post_trans"][cam],
            )
            valid = (
                (uvd[:, 0] >= 0)
                & (uvd[:, 1] >= 0)
                & (uvd[:, 0] <= w - 1)
                & (uvd[:, 1] <= h - 1)
                & (uvd[:, 2] > 0)
            )
            vu = uvd[valid]
            vseg = seg[valid]
            # far first: numpy's fancy-index assignment writes repeated
            # indices in order, so the last (nearest) point wins a pixel
            order = np.argsort(-vu[:, 2])
            vu_o = vu[order]
            vseg_o = vseg[order]
            ui = np.round(vu_o[:, 0]).astype(np.int64)
            vi = np.round(vu_o[:, 1]).astype(np.int64)
            dmap = np.zeros((h, w), np.float32)
            smap = np.zeros((h, w), np.float32)
            dmap[vi, ui] = vu_o[:, 2]
            smap[vi, ui] = vseg_o
            depth_maps.append(dmap)
            seg_maps.append(smap)

            if cam == 0:
                # labeled points in ego frame + normalized uv (left camera)
                points_occ = np.concatenate([pts, seg[:, None]], axis=1)[valid]
                uv_norm = uvd[valid].copy()
                uv_norm[:, 0] = (uv_norm[:, 0] / w - 0.5) * 2
                uv_norm[:, 1] = (uv_norm[:, 1] / h - 0.5) * 2
                n = min(len(points_occ), cfg.max_points)
                occ_fixed = np.zeros((cfg.max_points, 4), np.float32)
                uv_fixed = np.zeros((cfg.max_points, 3), np.float32)
                occ_fixed[:n] = points_occ[:n]
                uv_fixed[:n] = uv_norm[:n]
                out["points_occ"] = occ_fixed
                out["points_uv"] = uv_fixed
                out["points_count"] = np.int32(n)

        out["gt_depth"] = np.stack(depth_maps)
        out["img_seg"] = np.stack(seg_maps)
        return out
