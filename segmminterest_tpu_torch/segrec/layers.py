"""Shared layers for SegRec models (port of
``segmminterest_tpu/segrec/layers.py``).

Behavioral spec: reference SegRec/utils/layers.py (MLP_Block, Dice) and
reference SegRec/models/context/FM.py:30-66 (the per-feature
embedding-dict pattern every context model shares).

Init (:func:`init_weights`): every Linear / Embedding weight AND bias
~ N(0, 0.01) (BaseModel.init_weights :37-44), drawn from the caller's
``torch.Generator``; BatchNorm scale 1 and bias 0, Dice's alpha 0. A
model's own parameters drawn from a normal in the JAX package (DCN's cross
weights, DIEN's ``attentionW``, SDIM's ``random_rotations``...) are made by
:func:`normal_param` and drawn next, in the same walk; FinalMLP's
InteractionAggregation takes its xavier init as in the Task-1 model.

Module and parameter names follow the flax tree (``dense_{i}``, ``bn_{i}``,
``dice_{i}.BatchNorm_0``, ``emb_{feature}``...), so ``models/convert.py``'s
key rules map the JAX package's ``params`` and ``batch_stats`` onto the
``state_dict``.

:class:`BatchNorm` is flax's ``nn.BatchNorm``, not torch's: the running
averages move by ``momentum * old + (1 - momentum) * batch`` with flax's
``momentum=0.9`` (torch's 0.1), the running variance takes the *biased*
batch variance ``mean(x^2) - mean(x)^2`` (torch's BatchNorm1d the unbiased
one), and ``eps`` is 1e-5 in :class:`MLPBlock`, 1e-8 in :class:`Dice`.

Dropout is flax's (keep with probability ``1 - rate``, scaled by
``1 / (1 - rate)``), drawn from the ``generator`` the caller passes; the
masks are not the JAX package's bits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

INIT_STD = 0.01


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """N(0, 0.01) into every Linear / Embedding weight and bias, in the
    order ``named_modules`` walks them (init_weights :37-44); then each
    :func:`normal_param`, :func:`uniform_param` and InteractionAggregation,
    in that order again."""
    from ..models.interest import InteractionAggregation
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                for p in m.parameters(recurse=False):
                    p.normal_(0.0, INIT_STD, generator=generator)
        for m in model.modules():
            for name, std in getattr(m, "normal_init", {}).items():
                getattr(m, name).normal_(0.0, std, generator=generator)
            for name, bound in getattr(m, "uniform_init", {}).items():
                getattr(m, name).uniform_(-bound, bound, generator=generator)
            if isinstance(m, InteractionAggregation):
                m.reset_parameters(generator)
    return model


def normal_param(owner: nn.Module, name: str, shape, std: float = 1.0
                 ) -> nn.Parameter:
    """A parameter ``name`` of ``owner`` that :func:`init_weights` draws
    from N(0, std) (flax's ``normal(std)`` initializer in the JAX
    package); zeros until then."""
    if "normal_init" not in owner.__dict__:
        owner.normal_init = {}
    owner.normal_init[name] = std
    p = nn.Parameter(torch.zeros(shape))
    owner.register_parameter(name, p)
    return p


def uniform_param(owner: nn.Module, name: str, shape, bound: float
                  ) -> nn.Parameter:
    """A parameter ``name`` of ``owner`` that :func:`init_weights` draws
    from U(-bound, bound) (SRGNN's GRU weights in the JAX package); zeros
    until then."""
    if "uniform_init" not in owner.__dict__:
        owner.uniform_init = {}
    owner.uniform_init[name] = bound
    p = nn.Parameter(torch.zeros(shape))
    owner.register_parameter(name, p)
    return p


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``; ``generator`` None: deterministic."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def feature_layer(name: str, num: int, size: int) -> nn.Module:
    """One feature's ``size``-wide vector: an Embedding for ``*_c`` /
    ``*_id`` features, a bias-free Dense(1 -> size) of the value for
    numeric ones (:func:`lookup` applies it)."""
    return (nn.Embedding(num, size) if name.endswith(("_c", "_id"))
            else nn.Linear(1, size, bias=False))


def lookup(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a :func:`feature_layer`: ids cast to integers, values to the
    layer's dtype (fp32 as trained) with a trailing axis of one."""
    if isinstance(layer, nn.Embedding):
        return layer(x.long())
    return layer(x.to(layer.weight.dtype)[..., None])


def add_feature_layers(owner: nn.Module, prefix: str, names: Sequence[str],
              feature_max: Dict[str, int], size: int) -> None:
    for f in names:
        owner.add_module(f"{prefix}{f}",
                         feature_layer(f, feature_max[f], size))


def _broadcast_items(v: torch.Tensor, item_num: int) -> torch.Tensor:
    """A (B, size) per-row vector repeated over the candidate axis."""
    if v.dim() == 2:
        return v[:, None, :].expand(v.shape[0], item_num, v.shape[1])
    return v


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ContextEmbedding(nn.Module):
    """Per-feature embedding dict (FM.py:30-43): (B, I, n_feat, size)
    stacked vectors; scalar features are broadcast over the candidate
    axis."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], vec_size: int):
        super().__init__()
        self.feature_names = list(feature_names)
        add_feature_layers(self, "emb_", self.feature_names, feature_max, vec_size)

    def forward(self, feed: Dict[str, torch.Tensor], item_num: int):
        return torch.stack(
            [_broadcast_items(lookup(getattr(self, f"emb_{f}"), feed[f]),
                              item_num)
             for f in self.feature_names], dim=-2)


class LinearContext(nn.Module):
    """The wide/linear half: per-feature 1-d embeddings summed + bias
    (FM.py:36-38,55-63)."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int]):
        super().__init__()
        self.feature_names = list(feature_names)
        add_feature_layers(self, "lin_", self.feature_names, feature_max, 1)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))

    def forward(self, feed: Dict[str, torch.Tensor], item_num: int):
        values = [_broadcast_items(lookup(getattr(self, f"lin_{f}"), feed[f]),
                                   item_num) for f in self.feature_names]
        return torch.cat(values, dim=-1).sum(-1) + self.overall_bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the rows of an (N, F)
    input: batch statistics in training (biased variance, the running
    averages updated), the running ones in evaluation."""

    def __init__(self, features: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))   # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Dice(nn.Module):
    """Dice activation (utils/layers.py:246-289; Zhou et al. 2018):
    ``p * x + (1 - p) * alpha * x`` with ``p = sigmoid(BatchNorm(x))``, the
    affine BatchNorm1d(eps=1e-8) of the reference."""

    def __init__(self, emb_size: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(emb_size, eps=1e-8)
        self.alpha = nn.Parameter(torch.zeros(emb_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        p = torch.sigmoid(self.BatchNorm_0(x.reshape(-1, shape[-1]))
                          .reshape(shape))
        return p * x + (1.0 - p) * self.alpha * x


class MLPBlock(nn.Module):
    """FuxiCTR-style MLP (utils/layers.py:200-244): per hidden layer
    Dense -> [BatchNorm] -> activation -> dropout, optional output head.
    ``activation='dice'`` uses :class:`Dice` (which holds its own affine
    BatchNorm)."""

    def __init__(self, input_dim: int, hidden_units: Sequence[int],
                 output_dim: Optional[int] = None, activation: str = "relu",
                 dropout: float = 0.0, batch_norm: bool = False):
        super().__init__()
        self.activation = activation.lower()
        if self.activation not in ("relu", "sigmoid", "tanh", "dice"):
            raise ValueError(f"unknown activation {activation}")
        self.dropout = dropout
        self.batch_norm = batch_norm
        self.n_hidden = len(hidden_units)
        self.has_output = output_dim is not None
        d = input_dim
        for i, h in enumerate(hidden_units):
            self.add_module(f"dense_{i}", nn.Linear(d, h))
            if batch_norm:
                self.add_module(f"bn_{i}", BatchNorm(h, eps=1e-5))
            if self.activation == "dice":
                self.add_module(f"dice_{i}", Dice(h))
            d = h
        if self.has_output:
            self.dense_out = nn.Linear(d, output_dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gen = generator if self.training else None
        for i in range(self.n_hidden):
            x = getattr(self, f"dense_{i}")(x)
            if self.batch_norm:
                shape = x.shape
                x = getattr(self, f"bn_{i}")(
                    x.reshape(-1, shape[-1])).reshape(shape)
            if self.activation == "relu":
                x = F.relu(x)
            elif self.activation == "sigmoid":
                x = torch.sigmoid(x)
            elif self.activation == "tanh":
                x = torch.tanh(x)
            else:
                x = getattr(self, f"dice_{i}")(x)
            x = dropout(x, self.dropout, gen)
        if self.has_output:
            x = self.dense_out(x)
        return x


class MultiHeadTargetAttention(nn.Module):
    """Target attention (utils/layers.py:120-; FuxiCTR): one (N, D) query
    item attends over its (N, L, D) history through the W_q, W_k, W_v and
    W_o projections, scaled by 1/sqrt(head dim), masked slots at -1e9
    before an fp32 softmax; SDIM and ETA use it (the JAX layer's
    ``use_scale`` and ``use_qkvo`` at their defaults, the only values its
    callers use)."""

    def __init__(self, input_dim: int = 64, attention_dim: int = 64,
                 num_heads: int = 1, dropout: float = 0.0):
        super().__init__()
        self.att_dim, self.num_heads, self.dropout = \
            attention_dim, num_heads, dropout
        self.W_q = nn.Linear(input_dim, attention_dim, bias=False)
        self.W_k = nn.Linear(input_dim, attention_dim, bias=False)
        self.W_v = nn.Linear(input_dim, attention_dim, bias=False)
        self.W_o = nn.Linear(attention_dim, input_dim, bias=False)

    def forward(self, target_item: torch.Tensor,
                history_sequence: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        N, L = history_sequence.shape[:2]
        H = self.num_heads
        hd = self.att_dim // H
        q = self.W_q(target_item).reshape(N, 1, H, hd)
        k = self.W_k(history_sequence).reshape(N, L, H, hd)
        v = self.W_v(history_sequence).reshape(N, L, H, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask[:, None, None, :], scores,
                                 torch.full_like(scores, -1e9))
        probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        probs = dropout(probs, self.dropout,
                        generator if self.training else None)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            N, self.att_dim)
        return self.W_o(out)
