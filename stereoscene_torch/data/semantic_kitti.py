"""SemanticKITTI dataset index: sequence discovery, calibration, splits.

Port of ``stereoscene_tpu/data/semantic_kitti.py`` (a copy: the port imports
nothing of the JAX package), the rebuild of ``CustomSemanticKITTIDataset`` /
``CustomSemanticKITTILssDataset`` (ref: datasets/semantic_kitti_dataset.py:
59-154, datasets/semantic_kitti_lss_dataset.py:25-229): scans KITTI odometry
sequences, parses calib.txt into P2/P3/Tr, derives the stereo ``calib``
scalar fx2 * dynamic_baseline, and exposes per-frame records. Also the
CBGS class-balanced resampling (ref lss_dataset.py:80-118), drawn from the
one ``RandomState(seed)`` that ``repeat``'s shuffle draws from first.

Pure numpy/host code.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional

import numpy as np

SPLITS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["08"],
    "test_submit": ["11", "12", "13", "14", "15", "16", "17", "18", "19",
                    "20", "21"],
}

CAMERA_MAP = {"left": "2", "right": "3"}


def read_calib(calib_path: str) -> Dict[str, np.ndarray]:
    """Parse calib.txt -> {'P2': 4x4, 'P3': 4x4, 'Tr': 4x4} (homogeneous).

    ref: semantic_kitti_dataset.py:84-114
    """
    raw = {}
    with open(calib_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                break
            key, value = line.split(":", 1)
            try:
                raw[key] = np.array([float(v) for v in value.split()])
            except ValueError:
                pass
    out = {}
    for key in ("P2", "P3"):
        mat = np.eye(4)
        mat[:3, :4] = raw[key].reshape(3, 4)
        out[key] = mat
    tr = np.eye(4)
    tr[:3, :4] = raw["Tr"].reshape(3, 4)
    out["Tr"] = tr
    return out


def dynamic_baseline(calib: Dict[str, np.ndarray]) -> float:
    """Stereo baseline from the P2/P3 projection matrices:
    b = P3_x/( -fx ) - P2_x/( -fx ). ref: semantic_kitti_lss_dataset.py:225-229
    """
    p2, p3 = calib["P2"], calib["P3"]
    return float(p3[0, 3] / (-p3[0, 0]) - p2[0, 3] / (-p2[0, 0]))


@dataclasses.dataclass
class FrameInfo:
    sequence: str
    frame_id: str
    img_left_path: str
    img_right_path: str
    P2: np.ndarray           # [4, 4]
    P3: np.ndarray
    T_velo_2_cam: np.ndarray  # [4, 4]
    voxel_path: Optional[str]
    calib: float             # fx2 * dynamic baseline
    lidar_path: Optional[str] = None
    lidarseg_path: Optional[str] = None


class SemanticKittiIndex:
    """Frame index over the preprocessed dataset layout.

    Args mirror the reference dataset config keys (stereoscene.py:180-201):
      data_root: root containing dataset/sequences/<seq>/{image_2,image_3,...}
      ann_file: root of preprocessed voxel labels (labels/<seq>/<id>_1_1.npy)
      lidar_root / lidarseg_root: raw velodyne + label files for the
        train-time depth supervision (ref occ_to_depth.py:207-208).
    """

    def __init__(
        self,
        data_root: str,
        ann_file: str,
        split: str = "train",
        lidar_root: Optional[str] = None,
        lidarseg_root: Optional[str] = None,
        cbgs: bool = False,
        repeat: int = 1,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.ann_file = ann_file
        self.split = split
        self.sequences = SPLITS[split]
        self.lidar_root = lidar_root
        self.lidarseg_root = lidarseg_root
        self.frames: List[FrameInfo] = self._load()
        # one generator for both draws, in this order, as in the JAX index
        rng = np.random.RandomState(seed)
        if repeat > 1:
            self.frames = self.frames * repeat
            rng.shuffle(self.frames)
        if cbgs:
            self.frames = self._class_balanced_resample(rng)

    def _load(self) -> List[FrameInfo]:
        frames = []
        for seq in self.sequences:
            seq_dir = os.path.join(self.data_root, "dataset", "sequences", seq)
            calib_path = os.path.join(seq_dir, "calib.txt")
            if not os.path.exists(calib_path):
                continue  # tolerate partial downloads / test fixtures
            calib = read_calib(calib_path)
            stereo_calib = float(calib["P2"][0, 0]) * dynamic_baseline(calib)
            for id_path in sorted(
                glob.glob(os.path.join(seq_dir, "voxels", "*.bin"))
            ):
                frame_id = os.path.splitext(os.path.basename(id_path))[0]
                voxel_path = os.path.join(
                    self.ann_file, seq, f"{frame_id}_1_1.npy"
                )
                if not os.path.exists(voxel_path):
                    voxel_path = None
                frames.append(
                    FrameInfo(
                        sequence=seq,
                        frame_id=frame_id,
                        img_left_path=os.path.join(
                            seq_dir, "image_2", frame_id + ".png"
                        ),
                        img_right_path=os.path.join(
                            seq_dir, "image_3", frame_id + ".png"
                        ),
                        P2=calib["P2"][:3],
                        P3=calib["P3"][:3],
                        T_velo_2_cam=calib["Tr"],
                        voxel_path=voxel_path,
                        calib=stereo_calib,
                        lidar_path=(
                            os.path.join(
                                self.lidar_root, seq, "velodyne",
                                frame_id + ".bin",
                            )
                            if self.lidar_root
                            else None
                        ),
                        lidarseg_path=(
                            os.path.join(
                                self.lidarseg_root, seq, "labels",
                                frame_id + ".label",
                            )
                            if self.lidarseg_root
                            else None
                        ),
                    )
                )
        return frames

    def _class_balanced_resample(self, rng) -> List[FrameInfo]:
        """CBGS resampling by per-frame class histograms
        (ref: semantic_kitti_lss_dataset.py:80-118)."""
        counts = []
        for fr in self.frames:
            if fr.voxel_path is None:
                counts.append(np.zeros(19))
                continue
            occ = np.load(fr.voxel_path)
            hist = np.bincount(
                occ[occ != 255].reshape(-1).astype(np.int64), minlength=20
            )
            counts.append(hist[1:])
        counts = np.stack(counts)  # [N, 19]

        class_sum = counts.sum(axis=0)
        dist = class_sum / max(class_sum.sum(), 1)
        ratios = np.log(1 + (1.0 / len(class_sum)) / np.maximum(dist, 1e-12))

        sampled: List[int] = []
        for cls in range(len(class_sum)):
            valid = counts[:, cls] > 0
            idxs = np.nonzero(valid)[0]
            if len(idxs) == 0:
                continue
            pts = counts[valid, cls].astype(np.float64)
            prob = pts / pts.sum()
            expectation = (prob * pts).sum()
            n = int(class_sum[cls] * ratios[cls] / max(expectation, 1e-12))
            sampled.extend(rng.choice(idxs, size=n, p=prob))
        return [self.frames[i] for i in sampled]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> FrameInfo:
        return self.frames[i]

    def shard(self, process_index: int, process_count: int):
        """Per-host index shard (the DistributedSampler equivalent,
        ref datasets/samplers/; contiguity preserved for eval order)."""
        return self.frames[process_index::process_count]
