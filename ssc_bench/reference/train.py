"""The plain reference's training step: forward in training mode, the
family's loss terms, the gradient, a clip of its global norm, and AdamW
written out (torch's update rule: decoupled weight decay, bias-corrected
moments, eps outside the square root)."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def train_steps(model, batches: Sequence[Dict[str, torch.Tensor]],
                generators: Sequence[torch.Generator], loss: Callable,
                optim: Dict,
                on_first_grads: Callable = None) -> List[Dict[str, float]]:
    """One step per batch from the model's current parameters; returns
    each step's loss terms (``loss(outputs, batch)``, a dict of scalars)
    and ``loss_total``. ``on_first_grads(names, grads)`` sees the first
    step's clipped gradient, as the optimizer gets it."""
    model.train()
    named = [(n, p) for n, p in model.named_parameters()]
    params = [p for _, p in named]
    opt = AdamW(params, optim["lr"], optim["weight_decay"])
    logs = []
    for i, (batch, gen) in enumerate(zip(batches, generators)):
        terms = loss(model(batch, gen), batch)
        total = sum(terms.values())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        clip = optim["grad_clip"]
        scale = clip / norm if float(norm) >= clip else 1.0
        grads = [g * scale for g in grads]
        if i == 0 and on_first_grads is not None:
            on_first_grads([n for n, _ in named], grads)
        opt.step(grads)
        logs.append({k: float(v.detach()) for k, v in terms.items()}
                    | {"loss_total": float(total.detach())})
        del terms, total, grads
    return logs
