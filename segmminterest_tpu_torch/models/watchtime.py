"""Watch-time prediction models: the WLR/D2Q backbone and the TPM tree model
(port of ``segmminterest_tpu/models/watchtime.py``).

Behavioral spec: reference MMinterest/watchtime/
 * main_for_WatchTime_WLR.py:78-113  — D2QModel: user/item/duration
   embeddings -> 512-256-128-64-1 Swish MLP, sigmoid. WLR trains it with BCE
   on play_time > 60th-percentile; D2Q (main_for_WatchTime_D2Q.py) trains
   the same model with MSE on min(play/40, 1).
 * main_for_WatchTime_TPM.py:68-113  — TreeModelFastTest: embeddings ->
   128-64-32-(bucknum-1) ReLU MLP with dropout, sigmoid node probabilities.
 * main_for_WatchTime_TPM.py:114-206 — binary-tree quantile machinery:
   label_encoding, label-encoding BCE, expected playtime + variance.

TPM quirks kept verbatim: the label-encoding loss applies
binary_cross_entropy_with_logits to node *probabilities* (sigmoid outputs),
node traversal log-probs use log(p + 1e-5), and the variance's sqrt is
guarded by +1e-12.

The modules carry the flax names (``item_embedding``, ``fc_0`` ...), so
``models/convert.py:flax_to_state_dict`` transplants the JAX package's
params; they initialise as flax does (embeddings N(0, 1 / emb_size), as
``nn.Embed``'s variance scaling over the feature axis; Dense kernels
LeCun-normal truncated at two deviations, zero biases). TreeModel's dropout
draws from the ``generator`` the caller passes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

EMB_SIZE = 32
MAX_DURATION = 200
# the standard deviation of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def _dense(n_in: int, n_out: int) -> nn.Linear:
    """flax ``nn.Dense``'s init: lecun_normal kernel, zero bias."""
    lin = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / _TRUNC_STD
    nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(lin.bias)
    return lin


def _embed(n: int, emb_size: int) -> nn.Embedding:
    """flax ``nn.Embed``'s init: ``variance_scaling(1, "fan_in", "normal",
    out_axis=0)``, an untruncated normal of std ``emb_size ** -0.5``."""
    emb = nn.Embedding(n, emb_size)
    nn.init.normal_(emb.weight, std=emb_size ** -0.5)
    return emb


class _Embeddings(nn.Module):
    """item, user and duration embeddings, concatenated in that order."""

    def __init__(self, max_item: int, max_user: int, max_duration: int,
                 emb_size: int):
        super().__init__()
        self.item_embedding = _embed(max_item + 1, emb_size)
        self.user_embedding = _embed(max_user + 1, emb_size)
        self.duration_embedding = _embed(max_duration, emb_size)

    def embed(self, user_id, item_id, duration):
        return torch.cat([self.item_embedding(item_id),
                          self.user_embedding(user_id),
                          self.duration_embedding(duration)], dim=-1)


class D2QModel(_Embeddings):
    """(user, item, duration) -> predicted watch fraction in [0, 1], (B, 1)."""

    def __init__(self, max_item: int, max_user: int,
                 max_duration: int = MAX_DURATION, emb_size: int = EMB_SIZE):
        super().__init__(max_item, max_user, max_duration, emb_size)
        widths = [3 * emb_size, 512, 256, 128, 64]
        for i in range(4):
            setattr(self, f"fc_{i}", _dense(widths[i], widths[i + 1]))
        self.fc_out = _dense(64, 1)

    def forward(self, user_id, item_id, duration):
        x = self.embed(user_id, item_id, duration)
        for i in range(4):
            x = F.silu(getattr(self, f"fc_{i}")(x))
        return torch.sigmoid(self.fc_out(x))


class TreeModel(_Embeddings):
    """(user, item, duration) -> (bucknum - 1) sigmoid tree-node
    probabilities."""

    def __init__(self, max_item: int, max_user: int, class_num: int,
                 dropout: float = 0.2, max_duration: int = MAX_DURATION,
                 emb_size: int = EMB_SIZE):
        super().__init__(max_item, max_user, max_duration, emb_size)
        self.dropout = dropout
        self.fc1 = _dense(3 * emb_size, 128)
        self.fc2 = _dense(128, 64)
        self.fc3 = _dense(64, 32)
        self.fc_out = _dense(32, class_num)

    def _drop(self, x, generator: Optional[torch.Generator]):
        """flax ``nn.Dropout``: keep with probability 1 - rate, scale the
        kept by 1 / (1 - rate)."""
        if generator is None or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) \
            < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def forward(self, user_id, item_id, duration,
                generator: Optional[torch.Generator] = None):
        """``generator`` None: deterministic (no dropout)."""
        x = self.embed(user_id, item_id, duration)
        x = self._drop(F.relu(self.fc1(x)), generator)
        x = self._drop(F.relu(self.fc2(x)), generator)
        x = F.relu(self.fc3(x))
        return torch.sigmoid(self.fc_out(x))


def playtime_percentiles(playing_time_ms: np.ndarray,
                         bucknum: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quantile bucket edges over play time in segments
    (main_for_WatchTime_TPM.py:114-124): (1, bucknum) begins and ends."""
    play = playing_time_ms / 5000.0
    edges = np.percentile(
        play, np.linspace(0.0, 100.0, num=bucknum + 1).astype(np.float32))
    return (np.asarray(edges[:-1], np.float32)[None, :],
            np.asarray(edges[1:], np.float32)[None, :])


def tpm_label_encoding(bucknum: int, cmp_ratio: torch.Tensor,
                       begins: torch.Tensor, ends: torch.Tensor
                       ) -> Tuple[Dict[int, torch.Tensor],
                                  Dict[int, torch.Tensor]]:
    """Per-tree-node binary labels + sample weights
    (main_for_WatchTime_TPM.py:126-148). cmp_ratio: (B,) target playtime."""
    height = int(math.log2(bucknum))
    labels, weights = {}, {}
    c = cmp_ratio[:, None]
    for i in range(height):
        for j in range(2 ** i):
            idx = max(int(bucknum / (2 ** i) * j) - 1, 0)
            if j == 0:
                w = (c < begins[:, idx:idx + 1]).float()
            else:
                w = (c < ends[:, idx:idx + 1]).float()
            idx = max(int(bucknum / (2 ** i) * (j + 1)) - 1, 0)
            w = (c < ends[:, idx:idx + 1]).float() * w
            idx = max(int(bucknum * (1.0 / (2 ** i) * j
                                     + 1.0 / (2 ** (i + 1)))) - 1, 0)
            lab = (c >= ends[:, idx:idx + 1]).float()
            labels[1000 * i + j] = lab[:, 0]
            weights[1000 * i + j] = w[:, 0]
    return labels, weights


def tpm_label_encoding_loss(labels, weights, node_probs: torch.Tensor,
                            bucknum: int, row_mask: torch.Tensor):
    """Weighted BCE-with-logits applied to node *probabilities* — a
    reference quirk (main_for_WatchTime_TPM.py:150-162)."""
    height = int(math.log2(bucknum))
    total = node_probs.new_zeros(())
    for i in range(height):
        for j in range(2 ** i):
            lab = labels[1000 * i + j]
            w = weights[1000 * i + j] * row_mask
            x = node_probs[:, 2 ** i - 1 + j]
            ce = torch.clamp(x, min=0) - x * lab \
                + torch.log1p(torch.exp(-x.abs()))
            total = total + (ce * w).sum()
    return total / (bucknum - 1.0)


def tpm_encoded_playtime(node_probs: torch.Tensor, bucknum: int,
                         begins: torch.Tensor, ends: torch.Tensor):
    """Expected playtime + sqrt-variance from the leaf distribution
    (main_for_WatchTime_TPM.py:164-191), each (B, 1)."""
    height = int(math.log2(bucknum))
    mid = (begins + ends) / 2.0  # (1, bucknum)
    leaf_logps = []
    for i in range(bucknum):
        cur = 2 ** height - 1 + i
        logp = 0.0
        for _ in range(height):
            branch = cur % 2
            parent = (cur - 1) // 2
            cur = parent
            p = node_probs[:, parent]
            logp = logp + (torch.log(1.0 - p + 1e-5) if branch == 1
                           else torch.log(p + 1e-5))
        leaf_logps.append(logp)
    probs = torch.exp(torch.stack(leaf_logps, dim=1))  # (B, bucknum)
    expected = (mid * probs).sum(-1, keepdim=True)
    # reference quirk: e_x2 uses the already-reduced expectation, so the
    # variance collapses to E[x]^2 * (sum(probs) - 1) ~ 0; the sqrt is
    # epsilon-guarded because sqrt'(0) is infinite
    e_x2 = (expected.square() * probs).sum(-1, keepdim=True)
    var = torch.sqrt(torch.clamp(e_x2 - expected.square(), min=0.0) + 1e-12)
    return expected, var


def tpm_loss(node_probs, target_playtime, begins, ends, bucknum: int,
             mse_weight: float, var_weight: float, row_mask):
    """Total TPM loss (main_for_WatchTime_TPM.py:193-206) and the expected
    playtime."""
    expected, var = tpm_encoded_playtime(node_probs, bucknum, begins, ends)
    labels, weights = tpm_label_encoding(bucknum, target_playtime, begins,
                                         ends)
    enc_loss = tpm_label_encoding_loss(labels, weights, node_probs, bucknum,
                                       row_mask)
    n = torch.clamp(row_mask.sum(), min=1)
    mse = ((expected[:, 0] - target_playtime).square() * row_mask).sum() / n
    var_sum = (var[:, 0] * row_mask).sum()
    return enc_loss + mse * mse_weight + var_sum * var_weight, expected
