"""The precision below the configuration's, for the control of
``correct``: a quantize-dequantize function that a family's reference
routes its products through (``build_reference(..., quantizer=...)``)."""

from __future__ import annotations

import torch


def fp8_quantizer(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3) quantize-dequantize, with a
    straight-through gradient."""
    return _Fp8.apply(x)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def bf16_quantizer(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 round-trip with a straight-through gradient: the
    configuration's own precision, for a witness of what its rounding
    alone reads (``calibrate.py --witness``), not a control."""
    return _Bf16.apply(x)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad
