"""The native host library of the data path, port of
``stereoscene_tpu/native/`` (ctypes bindings of ``kitti_host.cc``, the
port's own copy of the JAX package's source beside this file).

At first use ``load()`` compiles ``kitti_host.cc`` with ``g++ -O3 -shared
-fPIC`` into ``stereoscene_torch/_kernels_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, so an
edited source is rebuilt and a stale build is never loaded. The build is
atomic: g++ writes a temporary file of a unique name, which
``os.replace`` then moves into place, so processes that build at once
(test workers, data loader ranks) never load a half-written file; a lock
holds the threads of one process (the data loader's workers) to one build
and one load. Nothing is built at import.

Where g++ or the build is missing, ``available()`` is False and the data
path takes its numpy route, as the JAX package does
(``data/pipeline.py``, ``data/preprocess.py``). The two routes differ: the
native scatter rounds u + 0.5 down and keeps the first of two points of
equal depth, numpy's rounds half to even and keeps the last
(``data.pipeline.lidar_route`` names the one this process takes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "kitti_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_kernels_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libkitti_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library where it is not built yet; -> its path. Raises
    where g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library is "
                           "compiled from kitti_host.cc at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(prefix=f"{out.stem}.", suffix=".so.tmp",
                                dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(name)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None where it cannot be
    built or loaded (then every caller takes its numpy route)."""
    with _lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError):
        _load_failed = True
        return None
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p = np.ctypeslib.ndpointer
    lib.unpack_remap_labels.argtypes = [
        p(np.uint16), p(np.uint8), p(np.int32), i64, p(np.uint8)]
    lib.majority_downsample.argtypes = [
        p(np.uint8), i64, i64, i64, i64, p(np.uint8)]
    lib.scatter_depth.argtypes = [
        p(np.float32), ctypes.c_void_p, i64, i64, i64, p(np.float32),
        ctypes.c_void_p]
    lib.point_majority_vote.argtypes = [
        p(np.int32), p(np.int32), i64, i64, i64, i64, i32, p(np.int32),
        p(np.uint8)]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native host library is not available "
                           "(g++ missing or the build failed)")
    return lib


def unpack_remap_labels(labels: np.ndarray, invalid_packed: np.ndarray,
                        lut: np.ndarray) -> np.ndarray:
    """Raw uint16 labels through ``lut``, 255 where the bit-packed invalid
    mask is set -> uint8 train ids."""
    lib = _lib_or_raise()
    labels = np.ascontiguousarray(labels, np.uint16)
    invalid_packed = np.ascontiguousarray(invalid_packed, np.uint8)
    lut = np.ascontiguousarray(lut, np.int32)
    out = np.empty(labels.shape[0], np.uint8)
    lib.unpack_remap_labels(labels, invalid_packed, lut, labels.shape[0], out)
    return out


def majority_downsample(grid: np.ndarray, k: int) -> np.ndarray:
    """Majority-vote k^3 downsample of a uint8 grid."""
    lib = _lib_or_raise()
    grid = np.ascontiguousarray(grid, np.uint8)
    x, y, z = grid.shape
    out = np.empty((x // k, y // k, z // k), np.uint8)
    lib.majority_downsample(grid, x, y, z, k, out)
    return out


def scatter_depth(uvd: np.ndarray, h: int, w: int,
                  seg: Optional[np.ndarray] = None):
    """Nearest-return depth map [h, w] of the points uvd [n, 3] (and, with
    ``seg``, the label map of the same winners)."""
    lib = _lib_or_raise()
    uvd = np.ascontiguousarray(uvd, np.float32)
    depth = np.empty((h, w), np.float32)
    if seg is not None:
        seg = np.ascontiguousarray(seg, np.float32)
        seg_out = np.empty((h, w), np.float32)
        lib.scatter_depth(
            uvd, seg.ctypes.data_as(ctypes.c_void_p), uvd.shape[0], h, w,
            depth, seg_out.ctypes.data_as(ctypes.c_void_p))
        return depth, seg_out
    lib.scatter_depth(uvd, None, uvd.shape[0], h, w, depth, None)
    return depth


def point_majority_vote(coords: np.ndarray, labels: np.ndarray,
                        grid_shape, num_classes: int = 20) -> np.ndarray:
    """Per-voxel majority label of the points at int coords [n, 3]."""
    lib = _lib_or_raise()
    coords = np.ascontiguousarray(coords, np.int32)
    labels = np.ascontiguousarray(labels, np.int32)
    x, y, z = grid_shape
    scratch = np.zeros((x * y * z * num_classes,), np.int32)
    out = np.empty((x * y * z,), np.uint8)
    lib.point_majority_vote(coords, labels, coords.shape[0], x, y, z,
                            num_classes, scratch, out)
    return out.reshape(x, y, z)
