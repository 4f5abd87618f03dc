"""The least time a kernel's work could take on the card, and the work
itself, counted from the shapes the cell runs (copied from the bounds of
the program's chip checks, so a later change to the program cannot move
this yardstick).

A bound is the larger of the bytes the work must move over the memory
rate and its operations over the peak rate of the type it computes in.
Each input byte is counted once when read and each output byte once when
written, whatever the kernel reads again.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def peaks(device_name: str) -> Optional[Dict]:
    """The card's published peaks, or None for a card the table lacks."""
    with open(_PEAKS) as f:
        return json.load(f).get(device_name)


def bound_s(nbytes: float, ops: float, peak: Dict, ops_rate: str) -> float:
    return max(nbytes / peak["hbm_byte_per_s"], ops / peak[ops_rate])


def k3(pixels: int, depth: int, channels: int, num_voxels: int,
       plan_rows: int, live_rows: int, table_bytes: int) -> Dict:
    """``lift_splat_fused`` (csrc/splat.cu), one call: the depth table
    [D * pixels] and feature table [pixels, C] read in ``table_bytes`` a
    value, the plan order [plan_rows] and bounds [num_voxels + 1] as int32,
    the fp32 output [num_voxels, C]; a multiply-add per live row and
    channel, in fp32."""
    nbytes = ((depth * pixels + pixels * channels) * table_bytes
              + plan_rows * 4 + (num_voxels + 1) * 4
              + num_voxels * channels * 4)
    return {"bytes": nbytes, "ops": 2 * live_rows * channels,
            "rate": "fp32_flop_per_s"}


def p1(pixels: int, channels: int, taps: int, z_bytes: int,
       offset_bytes: int) -> Dict:
    """``dcn_gather`` (csrc/dcn.cu), one call: z [taps, pixels, C] and the
    output [pixels, C] in ``z_bytes`` a value, the offsets [pixels, 2 *
    taps]; 4 corners x taps multiply-adds per output value, in fp32."""
    nbytes = (taps * pixels * channels * z_bytes
              + pixels * 2 * taps * offset_bytes
              + pixels * channels * z_bytes)
    return {"bytes": nbytes, "ops": 2 * 4 * taps * pixels * channels,
            "rate": "fp32_flop_per_s"}


def k1(pixels: int, channels: int, depth: int, groups: int,
       in_bytes: int, out_bytes: int) -> Dict:
    """``gwc_warp`` (csrc/gwc_warp.cu), one call: both eyes' features
    [pixels, C], the positions [D] fp32 and the volume [D, pixels, G]."""
    nbytes = (2 * pixels * channels * in_bytes + depth * 4
              + depth * pixels * groups * out_bytes)
    return {"bytes": nbytes, "ops": 0, "rate": "fp32_flop_per_s"}


def splat_plan(model_cfg: Dict, traffic: Dict, group: int) -> Dict:
    """The static splat plan the cell's first calibration gives (its rows
    as the numpy `build_plan` pads them), from the reference's own
    geometry."""
    import numpy as np
    import torch

    from .generate import camera_geometry
    from .reference import geometry

    m = model_cfg
    g = camera_geometry(traffic["calibrations"][0], m["input_size"])
    frustum = torch.from_numpy(geometry.create_frustum(
        tuple(m["input_size"]), m["downsample"], m["dbound"]))
    pts = geometry.get_geometry(frustum, g["rots"][:, :1], g["trans"][:, :1],
                                g["intrins"][:, :1], g["post_rots"][:, :1],
                                g["post_trans"][:, :1], g["bda"])[0, 0]
    ranks = geometry.voxel_ranks(pts, m["xbound"], m["ybound"],
                                 m["zbound"]).reshape(-1).numpy()
    nvox = int(np.prod(geometry.gen_dx_bx(m["xbound"], m["ybound"],
                                          m["zbound"])[2]))
    return dict(geometry.plan_rows(ranks, nvox, group), num_voxels=nvox)
