"""Device time of K3 and K2 (``csrc/splat.cu``) by chunk size.

On the flagship calibration's plans (``chip_smoke.splat_inputs``, phase 3's
inputs: the group-8 plan of 547,840 rows for K3, fp32 and bf16 tables;
the lifted rows of the group-1 plan, 456,704 x 128 fp32, for K2), calls
each C entry of the port's kernel library directly with preallocated
outputs and scratch, 20 calls back to back per CUDA-event run, median of
20 runs, so the wrapper's host time is left out. Prints ptxas's
registers, stack and spills of the chunk kernels when this process built
the library; then, for each chunk size, the device ms per call and the
number of partial sums. At the wrappers' ``CHUNK_ROWS`` it splits a call
into its launches (chunks, fix-up, K2's bounds) with ``torch.profiler``
and times the host's side of a call (the wrappers and the bare C
entries). Every output is checked against the plain version (1e-4 of
max|ref|). Run from the repository root on a CUDA card:

    python tools/probe_torch_splat.py [--chunks 64,128]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
from probe_torch_conv3d_tiles import device_ms  # noqa: E402
from stereoscene_torch import _build  # noqa: E402
from stereoscene_torch.models.detector import (  # noqa: E402
    BEVDepthOccupancy,
    DetectorConfig,
)
from stereoscene_torch.ops import voxel_pool  # noqa: E402


def launches_ms(fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler);
    empty when the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and "splat" in ev.key:
            name = ev.key.split("splat_")[1].split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds to issue one call of ``fn`` (the device queue
    absorbs the launches; one synchronise at the end, outside the
    clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def ptxas_summary(log: str) -> list:
    """Registers, stack and spills of each splat chunk kernel in ptxas's
    log."""
    lines = log.splitlines()
    summary = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "splat_chunks" in line:
            kind = line.split("splat_chunks")[1][:14]
            summary.append(kind + ": " + ", ".join(
                v.split(":")[-1].strip() for v in lines[i + 2:i + 4]))
    return summary


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunks", default="64,128")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("probe_torch_splat.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = _build.stream_ptr(dev)
    lib = _build.load_kernels()
    print("ptxas: " + (" | ".join(ptxas_summary(_build.build_log))
                       or "library already built"), flush=True)
    cfg = DetectorConfig(backbone_with_cp=False)
    model = BEVDepthOccupancy(cfg)
    x = chip_smoke.splat_inputs(
        model, chip_smoke.flagship_batch(cfg, chip_smoke.SEED, "cpu"), dev)
    del model
    nvox, group, c = x["nvox"], x["group"], x["feat"].shape[1]
    order, bounds, vals, ranks1 = (x["order"], x["bounds"], x["vals"],
                                   x["ranks1"])
    want2 = voxel_pool.splat_sorted_plain(vals, ranks1, nvox)
    tables = {"fp32": (x["dp"], x["feat"]),
              "bf16": (x["dp"].bfloat16(), x["feat"].bfloat16())}
    want3 = {k: voxel_pool.lift_splat_fused_plain(*t, order, bounds, group,
                                                  nvox)
             for k, t in tables.items()}
    out = torch.empty(nvox, c, device=dev)
    scratch = torch.empty(nvox + 1, dtype=torch.int32, device=dev)
    rows = {}

    def k3(dtype, chunk_rows, partials):
        dp, feat = tables[dtype]
        return lambda: _build.check(lib.stereoscene_splat_fused(
            dp.data_ptr(), feat.data_ptr(), order.data_ptr(),
            bounds.data_ptr(), partials.data_ptr(), out.data_ptr(), nvox, c,
            group, dp.numel(), feat.shape[0], order.numel(), chunk_rows,
            int(dtype == "bf16"), stream), "stereoscene_splat_fused")

    def k2(chunk_rows, partials):
        return lambda: _build.check(lib.stereoscene_splat_sorted(
            vals.data_ptr(), ranks1.data_ptr(), scratch.data_ptr(),
            partials.data_ptr(), out.data_ptr(), nvox, c, vals.shape[0],
            chunk_rows, stream), "stereoscene_splat_sorted")

    def checked(fn, want, name):
        fn()
        chip_smoke.check_close(name, out, want,
                               1e-4 * float(want.abs().max()), 0.0)
        return fn

    def host_cost(chunk_rows) -> dict:
        """Host us per call: the wrappers, then their bare C entries."""
        p3 = torch.empty((-(-order.numel() // chunk_rows), 2, c), device=dev)
        p2 = torch.empty((-(-vals.shape[0] // chunk_rows), 2, c), device=dev)
        cost = {}
        for dtype, (dp, feat) in tables.items():
            cost[f"k3_{dtype}_wrapper"] = host_us(
                lambda: voxel_pool.lift_splat_fused(
                    dp, feat, order, bounds, group, nvox, use_kernel=True))
            cost[f"k3_{dtype}_entry"] = host_us(k3(dtype, chunk_rows, p3))
        cost["k2_wrapper"] = host_us(lambda: voxel_pool.splat_sorted(
            vals, ranks1, nvox, use_kernel=True))
        cost["k2_entry"] = host_us(k2(chunk_rows, p2))
        return cost

    for chunk_rows in (int(k) for k in args.chunks.split(",")):
        profile = chunk_rows == voxel_pool.CHUNK_ROWS
        entry = {}
        for name, n_rows, g, plan_bounds in (
                ("k3", order.numel(), group, bounds.cpu().numpy()),
                ("k2", vals.shape[0], 1, x["bounds1"])):
            partials = torch.empty((-(-n_rows // chunk_rows), 2, c),
                                   device=dev)
            if name == "k3":
                for dtype in tables:
                    fn = checked(k3(dtype, chunk_rows, partials),
                                 want3[dtype], f"k3 {dtype} chunks of "
                                 f"{chunk_rows}")
                    entry[f"k3_{dtype}_ms"] = device_ms(fn)
                    if profile:
                        entry[f"k3_{dtype}_launch_ms"] = launches_ms(fn)
            else:
                fn = checked(k2(chunk_rows, partials), want2,
                             f"k2 chunks of {chunk_rows}")
                entry["k2_ms"] = device_ms(fn)
                if profile:
                    entry["k2_launch_ms"] = launches_ms(fn)
            part = chip_smoke.chunk_partition(plan_bounds, g, n_rows,
                                              chunk_rows)
            entry[f"{name}_chunks"] = part["n_chunks"]
            entry[f"{name}_partials"] = part["n_partials"]
        if profile:
            entry["host_us"] = host_cost(chunk_rows)
        rows[chunk_rows] = entry
        print(f"chunks of {chunk_rows} rows: " + json.dumps(entry),
              flush=True)
    print(json.dumps({"card": card, "default_chunk_rows":
                      voxel_pool.CHUNK_ROWS, "by_chunk_rows": rows}))


if __name__ == "__main__":
    main()
