"""KITTI-format predictions -> Waymo submission converter.

A copy of ``stereoscene_tpu/core/kitti2waymo.py`` (numpy only; the port
imports nothing of the JAX package).

Capability rebuild of ``core/evaluation/kitti2waymo.py:24-250``
(``KITTI2Waymo``): predictions in KITTI camera-frame convention
(bottom-center boxes, (l, h, w) dims, rotation_y) are mapped into the Waymo
vehicle frame (volumetric-center boxes, heading about +z) and written as
``metrics_pb2.Objects`` .bin shards plus one combined file.

The geometric conversion (``kitti_box_to_waymo``) is pure numpy and fully
tested without Waymo deps; reading TFRecords for per-frame context names /
extrinsics and serializing the proto require ``tensorflow`` +
``waymo_open_dataset`` and are gated exactly like
:mod:`tools.data_converter.waymo_converter`.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

try:  # pragma: no cover - proto deps optional
    from waymo_open_dataset import label_pb2  # noqa: F401
    from waymo_open_dataset.protos import metrics_pb2  # noqa: F401

    _HAVE_WAYMO = True
except Exception:
    _HAVE_WAYMO = False

# ref: kitti2waymo.py:63-67 k2w_cls_map (proto enum values)
KITTI_TO_WAYMO_TYPE = {
    "Car": 1,  # TYPE_VEHICLE
    "Pedestrian": 2,  # TYPE_PEDESTRIAN
    "Sign": 3,  # TYPE_SIGN
    "Cyclist": 4,  # TYPE_CYCLIST
}

# KITTI rectified-camera frame -> waymo front-cam frame axis permutation
# (ref: kitti2waymo.py:70-73 T_ref_to_front_cam)
T_REF_TO_FRONT_CAM = np.array(
    [
        [0.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def kitti_box_to_waymo(
    name: str,
    dimensions: np.ndarray,
    location: np.ndarray,
    rotation_y: float,
    score: float,
    t_k2w: np.ndarray,
) -> Dict:
    """Convert one KITTI prediction row to waymo Object fields (pure numpy).

    ref: kitti2waymo.py:106-160 parse_one_object — bottom-center -> true
    center (y -= h/2 in the camera frame, y points down), frame transform by
    ``t_k2w``, heading = -(rotation_y + pi/2) wrapped to [-pi, pi].
    """
    length = round(float(dimensions[0]), 4)
    height = round(float(dimensions[1]), 4)
    width = round(float(dimensions[2]), 4)
    x = round(float(location[0]), 4)
    y = round(float(location[1]), 4) - height / 2
    z = round(float(location[2]), 4)
    pt = np.asarray(t_k2w, dtype=float) @ np.array([x, y, z, 1.0])
    heading = -(round(float(rotation_y), 4) + np.pi / 2)
    while heading < -np.pi:
        heading += 2 * np.pi
    while heading > np.pi:
        heading -= 2 * np.pi
    return {
        "center_x": float(pt[0]),
        "center_y": float(pt[1]),
        "center_z": float(pt[2]),
        "length": length,
        "width": width,
        "height": height,
        "heading": float(heading),
        "type": KITTI_TO_WAYMO_TYPE[name],
        "score": round(float(score), 4),
    }


def kitti_result_to_waymo_objects(
    kitti_result: Dict,
    t_k2w: np.ndarray,
    context_name: str,
    frame_timestamp_micros: int,
) -> List[Dict]:
    """All instances of one frame (ref: parse_objects, :88-163)."""
    out = []
    for i in range(len(kitti_result["name"])):
        obj = kitti_box_to_waymo(
            str(kitti_result["name"][i]),
            kitti_result["dimensions"][i],
            kitti_result["location"][i],
            float(kitti_result["rotation_y"][i]),
            float(kitti_result["score"][i]),
            t_k2w,
        )
        obj["context_name"] = context_name
        obj["frame_timestamp_micros"] = int(frame_timestamp_micros)
        out.append(obj)
    return out


def _objects_to_proto(objs: List[Dict]):  # pragma: no cover - needs protos
    objects = metrics_pb2.Objects()
    for d in objs:
        o = objects.objects.add()
        o.object.box.center_x = d["center_x"]
        o.object.box.center_y = d["center_y"]
        o.object.box.center_z = d["center_z"]
        o.object.box.length = d["length"]
        o.object.box.width = d["width"]
        o.object.box.height = d["height"]
        o.object.box.heading = d["heading"]
        o.object.type = d["type"]
        o.score = d["score"]
        o.context_name = d["context_name"]
        o.frame_timestamp_micros = d["frame_timestamp_micros"]
    return objects


class KITTI2Waymo:
    """Prediction converter orchestrator (ref: kitti2waymo.py:24-250).

    Requires tensorflow + waymo_open_dataset for TFRecord context lookup and
    proto serialization; the geometry above stays importable/testable
    without them.
    """

    def __init__(
        self,
        kitti_result_files: List[Dict],
        waymo_tfrecords_dir: str,
        waymo_results_save_dir: str,
        waymo_results_final_path: str,
        prefix: str,
        workers: int = 8,
    ):
        if not _HAVE_WAYMO:
            raise ImportError(
                "KITTI->Waymo submission conversion needs "
                "`waymo_open_dataset` (+ tensorflow) for the metrics_pb2 "
                "protos; the geometric conversion is available as "
                "kitti_result_to_waymo_objects without them."
            )
        self.kitti_result_files = kitti_result_files
        self.waymo_tfrecords_dir = waymo_tfrecords_dir
        self.waymo_results_save_dir = waymo_results_save_dir
        self.waymo_results_final_path = waymo_results_final_path
        self.prefix = prefix
        self.workers = workers
        self.name2idx = {
            str(result["sample_idx"][0]): idx
            for idx, result in enumerate(kitti_result_files)
            if len(result["sample_idx"]) > 0
        }
        os.makedirs(waymo_results_save_dir, exist_ok=True)

    def convert(self):  # pragma: no cover - needs TF
        from glob import glob

        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2

        records = sorted(
            glob(os.path.join(self.waymo_tfrecords_dir, "*.tfrecord"))
        )
        for file_idx, record in enumerate(records):
            data = tf.data.TFRecordDataset(record, compression_type="")
            for frame_num, frame_data in enumerate(data):
                frame = dataset_pb2.Frame()
                frame.ParseFromString(bytearray(frame_data.numpy()))
                filename = f"{self.prefix}{file_idx:03d}{frame_num:03d}"
                t_front = next(
                    np.array(c.extrinsic.transform).reshape(4, 4)
                    for c in frame.context.camera_calibrations
                    if c.name == 1  # FRONT
                )
                t_k2w = t_front @ T_REF_TO_FRONT_CAM
                if filename in self.name2idx:
                    result = self.kitti_result_files[self.name2idx[filename]]
                    objs = kitti_result_to_waymo_objects(
                        result, t_k2w, frame.context.name,
                        frame.timestamp_micros,
                    )
                else:
                    objs = []
                with open(
                    os.path.join(
                        self.waymo_results_save_dir, f"{filename}.bin"
                    ),
                    "wb",
                ) as f:
                    f.write(_objects_to_proto(objs).SerializeToString())
        self.combine()

    def combine(self):  # pragma: no cover - needs protos
        from glob import glob

        combined = metrics_pb2.Objects()
        for pathname in sorted(
            glob(os.path.join(self.waymo_results_save_dir, "*.bin"))
        ):
            objects = metrics_pb2.Objects()
            with open(pathname, "rb") as f:
                objects.ParseFromString(f.read())
            combined.objects.extend(objects.objects)
        with open(self.waymo_results_final_path, "wb") as f:
            f.write(combined.SerializeToString())
        return combined
