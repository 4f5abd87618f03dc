"""Where the time of a bf16 serving request of the PyTorch port goes, by
the program's own spans.

Builds a detector of ``stereoscene_torch`` from ``--config`` (by default
the published SemanticKITTI model, ``configs/stereoscene_semantickitti.py``:
128x128x16 grid; ``configs/stereoscene_m2f_kitti.py`` gives its trunk with
the Mask2Former head; seeded random weights, bf16, kernels on), answers
warm-up requests on seeded frames at the flagship calibration (the first
builds the splat plan), then traces ``--requests`` more under
``torch.profiler`` and prints:

- for each span the program opened (``stereoscene_torch.utils.spans``):
  device ms a request of the operations launched inside it, the device's
  idle ms a request while it was open, and its launches a request;
- the kernels by device time, and the device's busy share of the window.

Run from the repository root on a machine with a CUDA card:

    python tools/profile_torch_serving.py [--config CONFIG] [--requests 3]
        [--out DIR]

The kernel table and the chrome trace, with the spans, go under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

import torch
from torch.profiler import record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ssc_bench import program_spans  # noqa: E402
from ssc_bench.trace import WINDOW, Trace  # noqa: E402
from stereoscene_torch.config import Config  # noqa: E402
from stereoscene_torch.models.detector import (  # noqa: E402
    BEVDepthOccupancy,
    DetectorConfig,
)
from stereoscene_torch.tools._frames import frame  # noqa: E402
from stereoscene_torch.utils.spans import SPANS  # noqa: E402
from stereoscene_torch.utils.weights import seeded_init_  # noqa: E402

CONFIG = os.path.join(ROOT, "stereoscene_torch", "configs",
                      "stereoscene_semantickitti.py")


def span_table(trace, requests: int) -> list:
    """One row a span the trace holds: device ms, idle ms and launches a
    request."""
    ctx = {"trace": trace, "frames": requests}
    rows = []
    for name in SPANS:
        device = program_spans.device_ms(ctx, (name,), "frames")
        if device is not None:
            rows.append({
                "span": name, "device_ms": device,
                "idle_ms": program_spans.idle_ms(ctx, (name,), "frames"),
                "launches": program_spans.launches(ctx, (name,), "frames")})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    cfg = DetectorConfig.from_config(Config.fromfile(args.config))
    model = BEVDepthOccupancy(cfg)
    seeded_init_(model, 0)
    model.to(dev, torch.bfloat16)

    batches = [frame(cfg, dev, seed=100 + i)
               for i in range(args.requests + 2)]
    for batch in batches[:2]:  # warm-up (plan build, cuDNN autotune)
        model.infer(batch)
    torch.cuda.synchronize()

    trace = Trace()
    with trace, record_function(WINDOW):
        for batch in batches[2:]:
            model.infer(batch)
        torch.cuda.synchronize()
    wall_ms = trace.window_s * 1e3 / args.requests
    busy_ms = trace.busy_s * 1e3 / args.requests
    spans = span_table(trace, args.requests)

    kernels = collections.defaultdict(lambda: [0.0, 0])
    for op in trace.ops:
        kernels[op.name][0] += (op.end - op.start) / 1e6 / args.requests
        kernels[op.name][1] += 1
    kernels = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        for name, (ms, count) in kernels:
            f.write(f"{ms:10.4f} ms/req x{count // args.requests:<5d} "
                    f"{name}\n")
    # Trace keeps the torch profiler it ran; its chrome trace shows the
    # spans over the device's timeline
    trace._prof.export_chrome_trace(os.path.join(args.out, "trace.json"))

    print(f"card: {card}")
    print(f"host wall ms per request {wall_ms:.3f}; device busy ms per "
          f"request {busy_ms:.3f} (idle share "
          f"{1 - busy_ms / wall_ms:.3f})")
    for row in spans:
        print(f"span {row['span']:<26s} device {row['device_ms']:9.3f} ms "
              f"idle {row['idle_ms']:9.3f} ms "
              f"launches {row['launches']:8.1f}")
    for name, (ms, count) in kernels[:25]:
        print(f"kernel {ms:9.3f} ms/req x{count // args.requests:<5d} "
              f"{name[:110]}")
    print(json.dumps({"card": card, "wall_ms": wall_ms, "busy_ms": busy_ms,
                      "spans": spans}))


if __name__ == "__main__":
    main()
