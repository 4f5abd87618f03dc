"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use ``load_kernels()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
``sm_90a``, one nvcc process per source, all started together, and links the
objects into one shared library with a plain C interface, under
``_kernels_build/`` (listed in ``.gitignore``); it loads it with ``ctypes``.
The library name carries a hash of the sources, so an edited kernel is
rebuilt and a stale build is never loaded. Nothing here runs at import time:
the CPU test suite imports every module on a host with no ``nvcc``.

Every C entry takes its pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after the launch; ``check()`` raises on a nonzero code.
Every wrapper launches through ``launch()``, which binds each entry once,
passes the current stream, checks the code and counts the launch.

``launch_counts`` holds one integer per kernel entry. ``launch()`` adds one
right after the kernel launched and nowhere else, so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel (its key in launch_counts) -> (C entry, argtypes before the stream;
# every pointer as c_void_p)
SIGNATURES = {
    # left, right, positions, out, B, H, W, C, G, K, D, in_bf16, out_bf16
    "gwc_warp": ("stereoscene_gwc_warp", [_P] * 4 + [_I] * 9),
    # dp, feat, order, bounds, partials, out, num_voxels, C, group, P, HW,
    # rows, chunk_rows, bf16
    "lift_splat_fused": ("stereoscene_splat_fused", [_P] * 6 + [_I] * 8),
    # vals, ranks, bounds, partials, out, num_voxels, C, rows, chunk_rows
    "splat_sorted": ("stereoscene_splat_sorted", [_P] * 5 + [_I] * 4),
    # x, w, wk, y, B, D, H, W, Ci, Co, bf16, w_fp32, block_n
    "conv3d_s1": ("stereoscene_conv3d_s1", [_P] * 4 + [_I] * 9),
    # z, offsets, out, B, H, W, C, kw, z_bf16, offsets_bf16, the offsets'
    # strides (b, h, w, c), tiles, slices
    "dcn_gather": ("stereoscene_dcn_gather", [_P] * 3 + [_I] * 13),
    # feat, idx, out, M, C, R, idx_col_stride
    "take_rows": ("stereoscene_take_rows", [_P] * 3 + [_I] * 4),
    # value, loc, attn, out, B, N, Q, H, ch, L, P, bf16, then (X, Y, Z,
    # first row) of 4 levels
    "msdeform_attn_3d": ("stereoscene_msdeform3d", [_P] * 4 + [_I] * 24),
}

launch_counts: "collections.Counter[str]" = collections.Counter()
_lib = None
_entries: dict = {}  # kernel -> its C entry, bound by load_kernels()
build_seconds = 0.0  # wall time of this process's nvcc run (0: cached)
build_log = ""  # nvcc / ptxas output of that run (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the stereoscene_torch CUDA "
            "kernels are compiled from csrc/ at first use"
        )
    return str(path)


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstereoscene_kernels_{digest.hexdigest()[:16]}.so"


def load_kernels() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            jobs.append(([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         obj))
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd, _ in jobs]
        logs = [p.communicate()[0] for p in procs]
        for (cmd, _), p, log in zip(jobs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{log}")
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        build_log = "".join(logs)
        for _, obj in jobs:
            obj.unlink()
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for kernel, (name, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*argtypes, _P]
        fn.restype = ctypes.c_int
        _entries[kernel] = fn
    _lib = lib
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` (a CUDA tensor's device) as an
    integer handle, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(kernel: str, device: int, *args) -> None:
    """Launch ``kernel``'s C entry (``SIGNATURES``) with ``args``, its
    pointers and integers before the stream, on the current stream of card
    ``device`` (the index a CUDA tensor's ``get_device()`` gives); raise if
    it returns an error; count the launch in ``launch_counts``.

    The one launch path of every wrapper. It enters a device guard only
    when ``device`` is not the current card: ``torch.cuda.device`` costs a
    device exchange on entry and on exit."""
    fn = _entries.get(kernel)
    if fn is None:
        load_kernels()
        fn = _entries[kernel]
    if device == torch._C._cuda_getDevice():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if code:
        check(code, SIGNATURES[kernel][0])
    launch_counts[kernel] += 1
