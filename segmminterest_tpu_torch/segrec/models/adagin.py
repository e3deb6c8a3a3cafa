"""AdaGIN (port of ``segmminterest_tpu/segrec/models/adagin.py``;
reference SegRec/models/context/AdaGIN.py:20-259): an adaptive graph
interaction network over the feature fields.

Quirks kept:
 * the "cold" adjacency is gumbel-softmaxed, then every positive entry is
   set to 1.0 (build_cold_matrix): at ``cold_tau`` 0.01 the entries that
   underflow to 0 are the ones dropped, subnormals among them as XLA
   flushes them (``FP32_TINY``);
 * the Gumbel noise is drawn in evaluation too (torch's F.gumbel_softmax
   always samples): the forward draws it from the ``generator`` it is
   given (the runner passes one in evaluation as in training), from
   torch's default generator without one;
 * ``h_list`` keeps each layer's INPUT, so the last layer's output is
   never read: the port does not compute it (nor draw its noise).

``gumbel_noise`` is a test seam: a list of the noise tensors to use, in
the JAX model's order (layer 0's cold (N, F, F), its warm (N, F, 1),
layer 1's...), so that a test can hand the model what ``jax.random``
drew. Nothing on the command line passes it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ContextEmbedding, MLPBlock, leaky_relu, normal_param


# a positive entry of the cold softmax is one at least the smallest normal
# fp32: XLA flushes subnormal results to zero (on the TPU, and on the CPU
# where the JAX package is tested), so an entry that underflows past it is 0
# there
FP32_TINY = torch.finfo(torch.float32).tiny


def gumbel_noise_like(x: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise of ``x``'s shape in fp32, drawn on the
    generator's device (a host generator gives a card's run the host's
    bits) and put on ``x``'s."""
    dev = generator.device if generator is not None else x.device
    u = torch.rand(x.shape, generator=generator, device=dev,
                   dtype=torch.float32).to(x.device)
    return -torch.log(-torch.log(u.clamp(min=FP32_TINY)))


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor, tau: float,
                   dim: int) -> torch.Tensor:
    return torch.softmax((logits.float() + noise) / tau, dim=dim)


class AutoGraphLayer(nn.Module):
    """AdaGIN.py:179-259: per layer, a cold adjacency over field pairs and
    a warm gate over fields, both gumbel-softmaxed, around GraphSage
    weights per field; each layer's output plus the input embeddings feeds
    the next."""

    def __init__(self, num_fields: int, embedding_dim: int, warm_dim: int,
                 warm_tau: float = 1.0, cold_tau: float = 0.01,
                 only_use_last_layer: bool = True, gnn_layers: int = 3):
        super().__init__()
        D = embedding_dim
        self.warm_tau, self.cold_tau = warm_tau, cold_tau
        self.only_use_last_layer = only_use_last_layer
        self.gnn_layers = gnn_layers
        self.warm_W1 = nn.Linear(D, warm_dim)
        self.warm_W2 = nn.Linear(warm_dim, 1, bias=False)
        self.cold_W = nn.Linear(2 * D, 1, bias=False)
        # variance_scaling(1.0, "fan_avg", "normal"): fan_in = fan_out = F*D
        normal_param(self, "W_GraphSage", (num_fields, D, D),
                     std=1.0 / math.sqrt(num_fields * D))

    def forward(self, feature_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                gumbel_noise: Optional[List[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        N, Fn, D = feature_emb.shape
        eye = torch.eye(Fn, dtype=torch.bool, device=feature_emb.device)
        h = feature_emb
        h_list = []
        for i in range(self.gnn_layers):
            if (not self.only_use_last_layer) or self.gnn_layers == i + 1:
                h_list.append(h)
            if i == self.gnn_layers - 1:
                break   # the last layer's output is never read
            e1 = h[:, :, None, :].expand(N, Fn, Fn, D)
            e2 = h[:, None, :, :].expand(N, Fn, Fn, D)
            alpha = leaky_relu(self.cold_W(torch.cat([e1, e2], -1))[..., 0])
            noise = (gumbel_noise[2 * i] if gumbel_noise is not None
                     else gumbel_noise_like(alpha, generator))
            cold = gumbel_softmax(alpha, noise, self.cold_tau, dim=-1)
            cold = torch.where((cold >= FP32_TINY) | eye, 1.0, 0.0) \
                .to(h.dtype)
            new_h = torch.einsum("nfg,ngd->nfd", cold, h)
            new_h = torch.einsum("fde,nfd->nfe", self.W_GraphSage, new_h)
            t = self.warm_W2(F.relu(self.warm_W1(new_h)))
            noise = (gumbel_noise[2 * i + 1] if gumbel_noise is not None
                     else gumbel_noise_like(t, generator))
            warm = gumbel_softmax(t, noise, self.warm_tau, dim=1).to(h.dtype)
            h = leaky_relu(new_h * warm) + feature_emb   # ResNet
        return h_list


class AdaGINHead:
    """The three (gate W_k, MLP mlp_k) pairs over each kept layer's
    pairwise products, their sums and the flat fields (AdaGIN.py
    forward): (N, F, D) layers -> (N,) scores; made on the model itself
    (the flax names are the model's own)."""

    def init_head(self, num_fields: int, emb_size: int,
                  fi_hidden_units: Sequence[int],
                  w_hidden_units: Sequence[int], num_gnn_layers: int,
                  only_use_last_layer: bool, dropout: float):
        iu, ju = torch.triu_indices(num_fields, num_fields)
        self.iu, self.ju = iu.tolist(), ju.tolist()
        self.only_use_last_layer = only_use_last_layer
        P = len(self.iu)
        for k, width in ((1, P * emb_size), (2, P),
                         (3, num_fields * emb_size)):
            self.add_module(f"mlp{k}", MLPBlock(width, fi_hidden_units,
                                                output_dim=1,
                                                dropout=dropout))
            self.add_module(f"W{k}", MLPBlock(width, w_hidden_units,
                                              output_dim=1, dropout=dropout))
        normal_param(self, "final_score_weight", (num_gnn_layers,))

    def score(self, h_list: List[torch.Tensor],
              generator: Optional[torch.Generator]) -> torch.Tensor:
        y = 0.0
        for li, h in enumerate(h_list):
            ep = h[:, self.iu, :] * h[:, self.ju, :]     # (N, P, D)
            for k, inp in ((1, ep.reshape(h.shape[0], -1)), (2, ep.sum(-1)),
                           (3, h.reshape(h.shape[0], -1))):
                wx = leaky_relu(getattr(self, f"W{k}")(inp, generator)) \
                    * getattr(self, f"mlp{k}")(inp, generator)
                y = y + wx[..., 0]
            if not self.only_use_last_layer:
                y = y * self.final_score_weight[li]
        return y


class AdaGINModel(nn.Module, AdaGINHead):

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 warm_dim: int = 64, cold_dim: int = 64,
                 warm_tau: float = 1.0, cold_tau: float = 0.01,
                 fi_hidden_units: Sequence[int] = (64, 64),
                 w_hidden_units: Sequence[int] = (64, 64),
                 num_gnn_layers: int = 3, only_use_last_layer: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        n = len(feature_names)
        self.init_head(n, emb_size, fi_hidden_units, w_hidden_units,
                       num_gnn_layers, only_use_last_layer, dropout)
        # the reference's linear embeddings (_define_params_FM) are unused
        # by its forward and left out, as in the JAX model
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        self.AutoGraph = AutoGraphLayer(n, emb_size, warm_dim, warm_tau,
                                        cold_tau, only_use_last_layer,
                                        num_gnn_layers)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                gumbel_noise: Optional[List[torch.Tensor]] = None):
        item_num = feed["item_id"].shape[1]
        emb = self.context_embedding(feed, item_num)
        B, I, Fn, D = emb.shape
        h_list = self.AutoGraph(emb.reshape(B * I, Fn, D), generator,
                                gumbel_noise)
        return self.score(h_list, generator).reshape(B, I), {}
