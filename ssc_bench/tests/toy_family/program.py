"""A toy occupancy program that stands in for a model of the port in the
test that adds a family from new files alone: both eyes' pixels through a
3x3 convolution, pooled to the grid's X x Y, and a 1x1 convolution to
classes x Z logits; serving upsamples them to the label grid and takes
the argmax. Training takes one step of fused cross-entropy (ignore 255),
a clip of the global gradient norm and ``torch.optim.AdamW``."""

from __future__ import annotations

import types
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


class ToyOcc(nn.Module):
    def __init__(self, m: Dict, label_shape):
        super().__init__()
        self.grid, self.classes = tuple(m["grid"]), m["classes"]
        self.label_shape = tuple(label_shape)
        self.encoder = nn.Conv2d(6, m["width"], 3, stride=2, padding=1)
        self.head = nn.Conv2d(m["width"], m["classes"] * self.grid[2], 1)

    def forward(self, batch) -> torch.Tensor:
        """imgs [B, 2, H, W, 3] -> logits [B, classes, X, Y, Z]."""
        imgs = batch["imgs"].to(self.head.weight.dtype)
        b, _, h, w, _ = imgs.shape
        x = imgs.permute(0, 1, 4, 2, 3).reshape(b, 6, h, w)
        x = F.adaptive_avg_pool2d(F.relu(self.encoder(x)), self.grid[:2])
        x = self.head(x).reshape(b, self.classes, self.grid[2],
                                 *self.grid[:2])
        return x.permute(0, 1, 3, 4, 2)

    @torch.no_grad()
    def infer(self, batch) -> torch.Tensor:
        return F.interpolate(self(batch).float(), size=self.label_shape,
                             mode="trilinear", align_corners=False).argmax(1)


def train_program(model: ToyOcc, lr: float, weight_decay: float,
                  grad_clip: float):
    state = types.SimpleNamespace(
        trainable=list(model.named_parameters()),
        optimizer=torch.optim.AdamW(model.parameters(), lr=lr,
                                    weight_decay=weight_decay))

    def step(state, batch, generator=None):
        model.train()
        logits = F.interpolate(model(batch), size=model.label_shape,
                               mode="trilinear", align_corners=False)
        loss = F.cross_entropy(logits, batch["gt_occ"].long(),
                               ignore_index=255)
        params = [p for _, p in state.trainable]
        grads = torch.autograd.grad(loss, params)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        scale = grad_clip / norm if float(norm) >= grad_clip else 1.0
        for p, g in zip(params, grads):
            p.grad = g * scale
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return state, {"loss_total": loss.detach()}

    return state, step
