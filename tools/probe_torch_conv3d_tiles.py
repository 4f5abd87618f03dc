"""Device time of K4's bf16 route at each N tile, beside cuDNN.

For the flagship's three conv shapes (hourglass conv2 64 -> 64 at
56x24x80, conv4 128 -> 128 at 28x12x40, ResNet3D stage 1 128 -> 128 at
64x64x8), launches ``csrc/conv3d.cu`` directly through its C entry with
BN = 64 and BN = 128 (weights packed by the entry, output preallocated),
20 launches back to back per CUDA-event run, median of 20 runs, so the
wrapper's host time is left out; cuDNN's channels-last ``F.conv3d`` is
timed the same way. Prints one line per shape with each tile's error
against an fp32 conv. Run from the repository root on a CUDA card:

    python tools/probe_torch_conv3d_tiles.py
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stereoscene_torch import _build  # noqa: E402
from stereoscene_torch.ops import conv3d  # noqa: E402

SHAPES = {"hourglass conv2": (64, 56, 24, 80, 64),
          "hourglass conv4": (128, 28, 12, 40, 128),
          "resnet3d stage 1": (128, 64, 64, 8, 128)}


def device_ms(fn, reps: int = 20, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_torch_conv3d_tiles.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    lib = _build.load_kernels()
    stream = _build.stream_ptr(dev)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (ci, d, h, w, co) in SHAPES.items():
        x = torch.randn(1, ci, d, h, w, generator=gen, device=dev).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last_3d)
        wt = (torch.randn(co, ci, 3, 3, 3, generator=gen, device=dev)
              * ci ** -0.5).bfloat16()
        wk = torch.empty(27, co, ci, dtype=torch.bfloat16, device=dev)
        y = torch.empty((1, co, d, h, w), dtype=torch.bfloat16, device=dev,
                        memory_format=torch.channels_last_3d)
        ref = torch.nn.functional.conv3d(x.float(), wt.float(), padding=1)
        flop = 2 * y.numel() * 27 * ci
        parts = []
        for block_n in (64, 128):
            def launch():
                _build.check(lib.stereoscene_conv3d_s1(
                    x.data_ptr(), wt.data_ptr(), wk.data_ptr(), y.data_ptr(),
                    1, d, h, w, ci, co, 1, 0, block_n, stream), "conv3d")

            launch()
            torch.cuda.synchronize()
            err = float((y.float() - ref).abs().max() / ref.abs().max())
            ms = device_ms(launch)
            chosen = " (the wrapper's)" if block_n == conv3d.tile_n(co) else ""
            parts.append(f"BN {block_n}{chosen} {ms:.4f} ms "
                         f"({flop / ms / 1e9:.1f} TFLOP/s, err/max|ref| "
                         f"{err:.1e})")
        wcl = wt.contiguous(memory_format=torch.channels_last_3d)
        lib_ms = device_ms(
            lambda: torch.nn.functional.conv3d(x, wcl, padding=1))
        print(f"{name} [{ci}->{co} at {d}x{h}x{w}]: " + " | ".join(parts)
              + f" | cuDNN {lib_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
