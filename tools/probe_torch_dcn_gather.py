"""Device and host time of P1 (``csrc/dcn.cu``) and P2 (``csrc/gather.cu``).

On phase 4b's and 4c's inputs (``chip_smoke.dcn_inputs``: z [9, 7680, 640]
bf16 and fp32 with the probe-scale, the seeded and the serving-layout
offsets; ``chip_smoke.take_rows_inputs``: feat [7680, 128] fp32 and the
three index layouts), calls each C entry of the port's kernel library
directly with preallocated outputs, 20 calls back to back per CUDA-event
run, median of 20 runs, so the wrapper's host time is left out (P2's
bare call is shorter than its launch, so its kernel time comes from
torch.profiler, as P1's does beside it). Every
output is checked against the plain version (P1 fp32 1e-5, bf16 2e-2 of
max|ref|; P2 bitwise). Then times the host's side of each wrapper, part by
part (microseconds per call, the device queue absorbing the launches), and
lists the device kernels of one bf16 DCN module forward as serving runs it
(torch.profiler). Run from the repository root on a CUDA card:

    python tools/probe_torch_dcn_gather.py
"""

from __future__ import annotations

import copy
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
from probe_torch_conv3d_tiles import device_ms  # noqa: E402
from probe_torch_splat import host_us  # noqa: E402
from stereoscene_torch import _build  # noqa: E402
from stereoscene_torch.models.detector import (  # noqa: E402
    BEVDepthOccupancy,
    DetectorConfig,
)
from stereoscene_torch.ops import deform_conv, gather  # noqa: E402
from stereoscene_torch.ops._dispatch import want_kernel  # noqa: E402
from stereoscene_torch.utils.weights import seeded_init_  # noqa: E402


def dcn_module_kernels(dcn, x_nchw) -> list:
    """(kernel, calls, device us) of one bf16 forward of the DCN module, in
    the order the profiler lists them."""
    module = copy.deepcopy(dcn).to(torch.bfloat16)
    xb = x_nchw.bfloat16()
    with torch.no_grad():
        module(xb)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            module(xb)
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            rows.append((ev.key[:140], ev.count, round(us, 2)))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_torch_dcn_gather.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = _build.stream_ptr(dev)
    lib = _build.load_kernels()
    cfg = DetectorConfig(backbone_with_cp=False)
    model = BEVDepthOccupancy(cfg)
    seeded_init_(model, chip_smoke.SEED)
    x = chip_smoke.dcn_inputs(model, dev)
    dcn = model.img_view_transformer.depth_net.depth_conv[4]
    del model
    result = {"card": card}

    pydll = ctypes.PyDLL(lib._name)  # the same library, GIL held in calls

    def kernel_us(fn, name: str, calls: int = 20) -> float:
        """Device us per call of the kernels named ``name`` that ``fn``
        launches (torch.profiler); 0.0 when it records no device time."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "device_time_total", 0.0)
                   for ev in prof.key_averages() if name in ev.key) / calls

    # P1: the bare C entry, then the wrapper's host side by part
    n, c = x["zb"].shape[1:]
    p1 = {}
    for zname in ("zb", "z32"):
        z = x[zname]
        out = torch.empty(n, c, dtype=z.dtype, device=dev)
        for oname, off in x["offsets"].items():
            args = deform_conv.dcn_gather_args(z, off)

            def entry(z=z, off=off, out=out, args=args):
                _build.check(lib.stereoscene_dcn_gather(
                    z.data_ptr(), off.data_ptr(), out.data_ptr(), *args,
                    stream), "stereoscene_dcn_gather")

            entry()
            want = deform_conv.dcn_gather_plain(z, off)
            tol = 1e-5 if z.dtype == torch.float32 else 2e-2
            chip_smoke.check_close(f"p1 {zname} {oname}", out, want,
                                   tol * float(want.float().abs().max()), 0.0)
            first = out.clone()
            entry()
            p1[f"{zname}_{oname}_bitwise_repeat"] = bool(torch.equal(first,
                                                                    out))
            p1[f"{zname}_{oname}_device_ms"] = device_ms(entry)
            p1[f"{zname}_{oname}_kernel_us"] = kernel_us(entry, "dcn_gather")
    zb, seeded, serving = (x["zb"], x["offsets"]["seeded"],
                           x["offsets"]["serving"])
    out = torch.empty(n, c, dtype=zb.dtype, device=dev)
    args = deform_conv.dcn_gather_args(zb, serving)
    p1["host_us"] = {
        "dcn_gather_args (checks, strides, grid)": host_us(
            lambda: deform_conv.dcn_gather_args(zb, serving)),
        "device check": host_us(lambda: (zb.get_device(),
                                         serving.get_device())),
        "z contiguous": host_us(lambda: zb.contiguous().data_ptr() % 16),
        "new_empty": host_us(lambda: zb.new_empty(zb.shape[1:])),
        "current device": host_us(torch._C._cuda_getDevice),
        "stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "ctypes call": host_us(lambda: lib.stereoscene_dcn_gather(
            zb.data_ptr(), serving.data_ptr(), out.data_ptr(), *args,
            stream)),
        "wrapper, seeded fp32": host_us(
            lambda: deform_conv.dcn_gather_kernel(zb, seeded)),
        "wrapper, serving bf16 view": host_us(
            lambda: deform_conv.dcn_gather_kernel(zb, serving)),
    }
    p1["whole_call_ms"] = {
        "seeded fp32": chip_smoke.cuda_ms(
            lambda: deform_conv.dcn_gather_kernel(zb, seeded)),
        "serving bf16 view": chip_smoke.cuda_ms(
            lambda: deform_conv.dcn_gather_kernel(zb, serving))}
    p1["serving_dcn_module_kernels"] = dcn_module_kernels(
        dcn, x["x"].permute(0, 3, 1, 2).contiguous())
    result["p1"] = p1
    print("p1: " + json.dumps(p1), flush=True)

    # P2
    feat, layouts = chip_smoke.take_rows_inputs(dev)
    (r, c2), m = feat.shape, layouts["flat"].shape[0]
    out2 = torch.empty(m, c2, device=dev)
    p2 = {}
    for name, idx in layouts.items():
        col = int(idx.dim() == 2 and idx.shape[1] != 1)

        def entry2(idx=idx, col=col):
            _build.check(lib.stereoscene_take_rows(
                feat.data_ptr(), idx.data_ptr(), out2.data_ptr(), m, c2, r,
                col, stream), "stereoscene_take_rows")

        entry2()
        if not torch.equal(out2, gather.take_along_rows_plain(feat, idx)):
            raise AssertionError(f"p2 {name}: not bitwise equal")
        idx64 = idx.long().reshape(m, -1)
        p2[name] = {
            "whole_call_ms": chip_smoke.cuda_ms(
                lambda: gather.take_along_rows(feat, idx)),
            "take_along_dim_whole_call_ms": chip_smoke.cuda_ms(
                lambda: torch.take_along_dim(feat, idx64, dim=0)),
            "entry_ms": device_ms(entry2),
            "kernel_us": kernel_us(entry2, "take_rows"),
            "take_along_dim_kernel_us": kernel_us(
                lambda: torch.take_along_dim(feat, idx64, dim=0), "gather"),
            "host_us": {
                "want_kernel": host_us(lambda: want_kernel(
                    "take_along_rows", None, feat, idx)),
                "checks": host_us(lambda: (
                    feat.dtype != torch.float32 or idx.dtype != torch.int32,
                    feat.dim(), gather._per_element(feat, idx), feat.shape,
                    feat.get_device(), idx.get_device())),
                "new_empty": host_us(lambda: feat.new_empty((m, c2))),
                "contiguous": host_us(lambda: (feat.contiguous(),
                                               idx.contiguous())),
                "current device": host_us(torch._C._cuda_getDevice),
                "stream": host_us(
                    lambda: torch._C._cuda_getCurrentRawStream(0)),
                "ctypes call": host_us(lambda: lib.stereoscene_take_rows(
                    feat.data_ptr(), idx.data_ptr(), out2.data_ptr(), m, c2,
                    r, col, stream)),
                "ctypes call, GIL held (PyDLL)": host_us(
                    lambda: pydll.stereoscene_take_rows(
                        ctypes.c_void_p(feat.data_ptr()),
                        ctypes.c_void_p(idx.data_ptr()),
                        ctypes.c_void_p(out2.data_ptr()), m, c2, r, col,
                        ctypes.c_void_p(stream))),
                "wrapper": host_us(lambda: gather.take_along_rows(feat, idx)),
                "take_along_dim": host_us(
                    lambda: torch.take_along_dim(feat, idx64, dim=0)),
            },
        }
    result["p2"] = p2
    print("p2: " + json.dumps(p2), flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
