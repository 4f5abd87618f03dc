"""The plain reference of the toy occupancy program, unfused: the 3x3
convolution as an unfold and a matrix product, the pooling as a mean
over blocks, the 1x1 convolution as a matrix product, and the
cross-entropy as the log of a softmax (plain torch, float32; nothing of
the program). Installed as ``ssc_bench/reference/toy.py``."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _identity(x):
    return x


class UnfoldConv2d(nn.Conv2d):
    quantize: Callable = staticmethod(_identity)

    def forward(self, x):
        b, _, h, w = x.shape
        kh, kw = self.kernel_size
        oh = (h + 2 * self.padding[0] - kh) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - kw) // self.stride[1] + 1
        cols = F.unfold(x, self.kernel_size, padding=self.padding,
                        stride=self.stride)  # [B, Cin*kh*kw, oh*ow]
        weight = self.quantize(self.weight.reshape(self.out_channels, -1))
        out = weight @ self.quantize(cols) + self.bias[:, None]
        return out.reshape(b, self.out_channels, oh, ow)


class ToyOccReference(nn.Module):
    def __init__(self, m: Dict):
        super().__init__()
        self.grid, self.classes = tuple(m["grid"]), m["classes"]
        self.encoder = UnfoldConv2d(6, m["width"], 3, stride=2, padding=1)
        self.head = UnfoldConv2d(m["width"], m["classes"] * self.grid[2], 1)

    def forward(self, batch, generator=None) -> Dict[str, torch.Tensor]:
        imgs = batch["imgs"].float()
        b, _, h, w, _ = imgs.shape
        x = imgs.permute(0, 1, 4, 2, 3).reshape(b, 6, h, w)
        x = self.encoder(x).clamp_min(0.0)
        gx, gy, gz = self.grid
        c, fh, fw = x.shape[1:]
        x = x.reshape(b, c, gx, fh // gx, gy, fw // gy).mean(dim=(3, 5))
        x = self.head(x).reshape(b, self.classes, gz, gx, gy)
        return {"logits": x.permute(0, 1, 3, 4, 2)}


def upsample(logits, label_shape):
    return F.interpolate(logits, size=tuple(label_shape), mode="trilinear",
                         align_corners=False)


def cross_entropy(logits, target):
    """Mean over the voxels not marked 255 of -log softmax at the label."""
    c = logits.shape[1]
    flat = logits.permute(0, 2, 3, 4, 1).reshape(-1, c)
    target = target.reshape(-1).long()
    keep = target != 255
    logp = torch.log(torch.softmax(flat[keep], dim=-1))
    return -logp.gather(1, target[keep][:, None]).mean()


def build(model_cfg: Dict, device, quantizer: Optional[Callable] = None,
          checkpoint_blocks: bool = False) -> ToyOccReference:
    with torch.device(device):
        model = ToyOccReference(model_cfg)
    if quantizer is not None:
        for module in model.modules():
            if isinstance(module, UnfoldConv2d):
                module.quantize = quantizer
    return model.eval()
