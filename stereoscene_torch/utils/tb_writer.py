"""Minimal TensorBoard event-file writer (no TF / tensorboard dependency),
a copy of ``stereoscene_tpu/utils/tb_writer.py`` (the port imports nothing
of the JAX package).

Reference parity: the reference logs scalars to TensorBoard every 50 iters
via mmcv's ``TensorboardLoggerHook``
(ref: projects/configs/_base_/default_runtime.py:6-11). This module writes
the same ``events.out.tfevents.*`` files by hand-encoding the two protobuf
messages involved (``Event`` and ``Summary``) and the TFRecord framing
(length + masked-CRC32C), so standard TensorBoard can read the logs without
tensorflow being a runtime dependency of the trainer.

Wire format notes:
- TFRecord record: u64 LE length, u32 LE masked_crc32c(length bytes),
  payload, u32 LE masked_crc32c(payload).
- ``Event``: field 1 wall_time (double), field 2 step (int64),
  field 3 file_version (string, first record only), field 5 summary.
- ``Summary``: repeated field 1 ``Value``; ``Value``: field 1 tag (string),
  field 2 simple_value (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire helpers (varint + tagged fields)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _encode_event(
    wall_time: float,
    step: int = 0,
    file_version: Optional[str] = None,
    scalars: Optional[Dict[str, float]] = None,
) -> bytes:
    msg = _field_double(1, wall_time) + _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            v = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
            summary += _field_bytes(1, v)
        msg += _field_bytes(5, summary)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TensorBoardWriter:
    """Scalar-only event writer, API-compatible with the subset of
    ``torch.utils.tensorboard.SummaryWriter`` the reference hook uses."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d.0" % (
            int(time.time()), socket.gethostname(), os.getpid(),
        )
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(
            _record(_encode_event(time.time(), 0, file_version="brain.Event:2"))
        )
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: Dict[str, float], step: int):
        self._f.write(
            _record(_encode_event(time.time(), int(step), scalars=scalars))
        )
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
