"""Optimizers of optax that torch's differ from, written out.

``optax.adagrad(lr)`` (the watch-time baselines, segmminterest_tpu/tasks/
watchtime.py, and SegRec's ``--optimizer Adagrad``) starts its accumulator
from 0.1 and scales by ``rsqrt(sum + 1e-7)``; ``torch.optim.Adagrad`` starts
from 0 and divides by ``sqrt(sum) + 1e-10``. ``optax.adam``, ``optax.sgd``
and ``optax.adadelta`` are ``torch.optim.Adam``, ``SGD`` and
``Adadelta(rho=0.9, eps=1e-6)`` with the same learning rate.
"""

from __future__ import annotations

import torch


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)``: ``sum += g^2`` from ``initial_accumulator_value``;
    ``p -= lr * g * rsqrt(sum + eps)``, no step where the sum is 0."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "sum" not in st:
                    st["sum"] = torch.full_like(p, group["initial"])
                acc = st["sum"].add_(p.grad.square())
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros_like(acc))
                p.sub_(group["lr"] * (scale * p.grad))
