"""SegFormerX — the dual-stream (user x video) segment transformer (port of
``segmminterest_tpu/models/segformerx.py``: the 'ours' path and the
ablations).

Behavioral spec: reference MMinterest/models/encoder.py (SegFormerX,
SegFormerXEncoder, SegFormerXEncoderLayer, SegFormerXAttention).

The four attention streams (v2v, t2v, v2t, t2t) run on one of four routes,
chosen by the same flags as the JAX package:

* ``fused_attention=False``: composed PyTorch ops, the concat-KV
  construction the JAX package leaves to XLA (segformerx.py:228-317);
* ``fused_attention=True``: projections by ``nn.Linear`` (or, with
  ``fuse_projections``, two ``Linear(d, 6d)``), then the two-block
  attention kernel K1 (core/attention.py:fused_two_block_attention,
  segformerx.py:399-481);
* ``fused_attention=True, fuse_qkv=True``: the six projections of each
  stream inside kernel K2 (core/attention.py:fused_proj_two_block_attention,
  segformerx.py:319-397). Unlike the TPU build, single-query streams
  (the ID backbone's user stream) go through K2 as well. Under
  ``SEGMM_ATTN_V2=1`` these calls run K6, K2's weight-interleaved version 2;
* ``fused_attention=True, fuse_dual=True``: the K2 route with both streams
  of a layer in one launch of kernel K5
  (core/dual_kernel.py:fused_dual_stream_attention, segformerx.py:366-380)
  when both streams are longer than one; otherwise the two K2 calls, as the
  JAX package decides;
* the CrossAtt and SelfAtt ablations with ``fused_attention=True``, whatever
  ``fuse_qkv`` is: projections by ``nn.Linear``, then the single-block
  kernel K3 (core/attention.py:fused_masked_attention,
  segformerx.py:418-433). CrossAtt keeps only the cross streams (video
  queries over user keys, user queries over video keys), SelfAtt only the
  self streams; SelfAtt's user stream reaches no output (the layer returns
  no user state), so the port does not compute it.

With ``fuse_layer`` the 'ours' path (noPos included) runs each whole layer
stream, attention, out-projection, LayerNorm residual, GELU MLP and
LayerNorm residual, in kernel K4 (core/layer_kernel.py:fused_layer_stream,
segformerx.py:553-609), whatever ``fused_attention`` and
``fuse_projections`` are; the parameters stay the composed ones (per-stream
Denses, no ``vid_projs``). K4 saves only the layer inputs, so whole-layer
remat is off while it runs (segformerx.py:785-803). Single-query streams go
through K4 on the card too (the JAX package sends them to its composed
path). Under CrossAtt and SelfAtt ``fuse_dual`` and ``fuse_layer`` change
nothing, as there.

Ablations (``ablation``, matched as the JAX package matches them:
substrings "CrossAtt", "SelfAtt", "noPos"; whole names "CrossMLP",
"SelfMLP", "w/oAtt"): CrossMLP and SelfMLP replace the encoder stack by an
:class:`MLPBlock` (CrossMLP over the concatenated user and video tokens,
then an adaptive average pool back to the video length), w/oAtt returns the
embedded video tokens, and noPos feeds the frame-position Dense a random
permutation of each row's positions in training (drawn from
``permute_generator``).

Faithful quirks (PARITY.md): masked logits are filled with -10000 before
the 1/sqrt(d_head) scale; dropout acts on attention logits; LayerNorm eps is
1e-12; GELU is exact; ``output_layers=[-1]`` selects the INPUT of the last
encoder layer, so that layer is never built (PARITY M1).

Training: dropout runs inside the kernels on the K1, K2, K3, K4 and K5
routes (the hash mask of core/attention.py, seeded per attention call as
segformerx.py:328-333,412-416,564-569 seed them: two int32 per layer, slot
0 for the video stream, slot 1 for the user stream; K5 takes slot 0 for
both streams, :379) and through ``nn.Dropout`` elsewhere.
The seeds are drawn from ``seed_generator`` before any recomputed region,
so a remat replay sees the same ones. ``remat`` recomputes each encoder
layer (scope 'layer') or each attention block (scope 'attention') in the
backward with ``torch.utils.checkpoint`` (segformerx.py:795-803,521-536);
it changes no numbers.

Compute dtype: the model runs in the dtype of its Dense/Embedding weights.
LayerNorm keeps fp32 statistics, scale and bias and casts its output, as
flax's LayerNorm(dtype=compute dtype) over fp32 params does
(:class:`LayerNorm`).

Every parameter tree equals the flax model's for the same options, so that
``models/convert.py`` maps it leaf for leaf. The sr_ratio / patch-merge
pyramid (reachable only through the JAX ``SegFormerX`` itself) is not
ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.attention import (fused_masked_attention,
                              fused_proj_two_block_attention,
                              fused_two_block_attention)
from ..core.dual_kernel import fused_dual_stream_attention
from ..core.layer_kernel import fused_layer_stream
from ..core.numerics import masked_attention_logits

LN_EPS = 1e-12
INIT_STD = 0.02  # encoder.py:414-423: Linear/Embedding ~ N(0, 0.02)
NO_SEEDS = (0, 0)
MLP_ABLATIONS = ("CrossMLP", "SelfMLP", "w/oAtt")


def ours_path(ablation: str) -> bool:
    """The four-stream path: neither CrossAtt nor SelfAtt in the name."""
    return "CrossAtt" not in ablation and "SelfAtt" not in ablation


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics, scale and bias are fp32 whatever the input
    dtype, with the output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def _remat(fn, *args):
    """Recompute ``fn`` in the backward (non-reentrant checkpoint; the RNG
    state of nn.Dropout is restored for the replay)."""
    return checkpoint(fn, *args, use_reentrant=False)


def init_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Reference init: every Linear/Embedding weight ~ N(0, 0.02), biases
    zero, LayerNorm ones/zeros (encoder.py:414-423)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.data.normal_(0.0, INIT_STD, generator=generator)
            m.bias.data.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.data.normal_(0.0, INIT_STD, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()


class KnMLP(nn.Module):
    """n-layer MLP with exact GELU + dropout between layers, none after the
    last (kn_util/nn_utils/layers/mlp.py:1-24)."""

    def __init__(self, dims: Sequence[int], dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                    for i in range(len(dims) - 1))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i != n - 1:
                x = self.dropout(F.gelu(x))
        return x


class MLPBlock(nn.Module):
    """FuxiCTR-style MLP of the CrossMLP / SelfMLP ablations
    (segformerx.py:69-93, encoder.py:210-252): Dense ``dense_{i}`` ->
    (LayerNorm ``ln_{i}``, eps 1e-5) -> ReLU -> Dropout (rate > 0) per hidden
    width, then Dense ``dense_out``. The JAX SegFormerX builds it without a
    dtype, so it computes in fp32 whatever the model's compute dtype: its
    input, weights and output are fp32 (its parameters stay fp32 in a bf16
    working copy, :meth:`SegInterestModel.fp32_param_names`)."""

    def __init__(self, input_dim: int, hidden_units: Sequence[int],
                 output_dim: int, dropout: float = 0.0,
                 layer_norm: bool = False):
        super().__init__()
        self.n_hidden = len(hidden_units)
        self.layer_norm = layer_norm
        dims = [input_dim] + list(hidden_units)
        for i in range(self.n_hidden):
            setattr(self, f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
            if layer_norm:
                setattr(self, f"ln_{i}", LayerNorm(dims[i + 1], eps=1e-5))
        self.dense_out = nn.Linear(dims[-1], output_dim)
        self.drop = nn.Dropout(dropout) if dropout > 0 else None

    @staticmethod
    def _dense(lin, x):
        return F.linear(x, lin.weight.float(), lin.bias.float())

    def forward(self, x):
        x = x.float()
        for i in range(self.n_hidden):
            x = self._dense(getattr(self, f"dense_{i}"), x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x)
            x = F.relu(x)
            if self.drop is not None:
                x = self.drop(x)
        return self._dense(self.dense_out, x)


def adaptive_avg_pool_seq(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch AdaptiveAvgPool1d over the sequence axis of (B, L, D) as the
    JAX package computes it (segformerx.py:612-625): window i averages
    positions [floor(i L / out), ceil((i + 1) L / out)) through a window
    matrix built in x's dtype, so the 1/n weights round as there."""
    L = x.shape[1]
    w = torch.zeros(out_len, L, dtype=torch.float32)
    for i in range(out_len):
        s, e = (i * L) // out_len, -((-(i + 1) * L) // out_len)
        w[i, s:e] = 1.0 / (e - s)
    return torch.einsum("ol,bld->bod", w.to(x.device, x.dtype), x)


class FourStreamAttention(nn.Module):
    """v2v / t2v / v2t / t2t attention with per-stream QKV projections and
    concatenated KV for the user<->video cross streams
    (encoder.py:12-175). Stream wiring: vid queries attend block 1 = v2v
    (k/v of vid) and block 2 = t2v (k/v of usr); usr queries attend block 1
    = v2t (k/v of vid) and block 2 = t2t (k/v of usr). CrossAtt keeps t2v
    and v2t, SelfAtt v2v (and t2t, whose output is dead).

    Parameters, as flax creates them: the q and k Denses (``{s}_proj.0``,
    ``.1``) of the streams the ablation uses, the value Dense ``{s}_proj.2``
    of all four streams (segformerx.py:258-261), or only ``vid_projs`` and
    ``usr_projs`` (``Linear(d, 6d)``) with ``fuse_projections`` on the K1
    route; ``ff_usr``, ``ff_vid``, ``ln_vid``, and ``ln_usr`` except under
    SelfAtt. ``fuse_dual`` takes the K2 route and runs both streams in one
    K5 launch where both are longer than one."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 fused: bool = False, fuse_qkv: bool = False,
                 ablation: str = "ours", fuse_projections: bool = False,
                 fuse_dual: bool = False):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        # streams: CrossAtt first, as segformerx.py:270-279; the user state
        # is dropped whenever "SelfAtt" is in the name (:314-316)
        self.cross = "CrossAtt" in ablation
        self.no_usr_state = "SelfAtt" in ablation
        ours = not (self.cross or self.no_usr_state)
        self.route = ("composed" if not fused else "k3" if not ours
                      else "k2" if (fuse_qkv or fuse_dual) else "k1")
        self.fuse_dual = fuse_dual
        self.wide = self.route == "k1" and fuse_projections
        if self.wide:
            self.vid_projs = nn.Linear(d_model, 6 * d_model)
            self.usr_projs = nn.Linear(d_model, 6 * d_model)
        else:
            qk = ({"t2v", "v2t"} if self.cross
                  else {"v2v", "t2t"} if not ours
                  else {"t2v", "v2v", "t2t", "v2t"})
            for s in ("t2v", "v2v", "t2t", "v2t"):
                setattr(self, f"{s}_proj", nn.ModuleDict(
                    (str(j), nn.Linear(d_model, d_model))
                    for j in ((0, 1, 2) if s in qk else (2,))))
        self.ff_usr = nn.Linear(d_model, d_model)
        self.ff_vid = nn.Linear(d_model, d_model)
        self.ln_vid = LayerNorm(d_model, eps=LN_EPS)
        if not self.no_usr_state:
            self.ln_usr = LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def _heads(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, self.d_model // self.num_heads)

    def _qkv(self, s, xq, xk):
        """Stream ``s``'s q from xq and k, v from xk, split into heads."""
        p = getattr(self, f"{s}_proj")
        return (self._heads(p["0"](xq)), self._heads(p["1"](xk)),
                self._heads(p["2"](xk)))

    def forward(self, vid_feat, vid_mask, usr_feat, usr_mask,
                seeds: Tuple[int, int] = NO_SEEDS):
        """``seeds``: the kernels' dropout seeds of the video and the user
        stream (used in training on the K1, K2 and K3 routes). Returns the
        new video and user states; the user state is None under SelfAtt."""
        route = {"k2": self._proj_fused, "k1": self._two_block,
                 "k3": self._single_block}.get(self.route)
        if route is None:
            vid_out, usr_out = self._composed(vid_feat, vid_mask, usr_feat,
                                              usr_mask)
        else:
            vid_out, usr_out = route(vid_feat, vid_mask, usr_feat, usr_mask,
                                     seeds)
        if usr_out is not None:
            usr_out = self.drop(self.ff_usr(usr_out))
        vid_out = self.drop(self.ff_vid(vid_out))
        vid_feat = self.ln_vid(vid_feat + vid_out)
        if self.no_usr_state:
            return vid_feat, None
        return vid_feat, self.ln_usr(usr_feat + usr_out)

    def _composed(self, vid, vid_mask, usr, usr_mask):
        """Materialised attention (segformerx.py:236-304): one key block per
        stream under CrossAtt / SelfAtt, concat-KV otherwise."""
        logits = masked_attention_logits
        if self.cross:
            q, k, v = self._qkv("t2v", vid, usr)
            vid_lv = logits(q, k, vid_mask, usr_mask), v
            q, k, v = self._qkv("v2t", usr, vid)
            usr_lv = logits(q, k, usr_mask, vid_mask), v
        elif self.no_usr_state:
            q, k, v = self._qkv("v2v", vid, vid)
            vid_lv, usr_lv = (logits(q, k, vid_mask, vid_mask), v), None
        else:
            qa, ka, va = self._qkv("v2v", vid, vid)
            qb, kb, vb = self._qkv("t2v", vid, usr)
            vid_lv = (torch.cat([logits(qa, ka, vid_mask, vid_mask),
                                 logits(qb, kb, vid_mask, usr_mask)], -1),
                      torch.cat([va, vb], dim=1))
            qa, ka, va = self._qkv("v2t", usr, vid)
            qb, kb, vb = self._qkv("t2t", usr, usr)
            usr_lv = (torch.cat([logits(qa, ka, usr_mask, vid_mask),
                                 logits(qb, kb, usr_mask, usr_mask)], -1),
                      torch.cat([va, vb], dim=1))
        # dropout on logits, then scale, then an fp32 softmax; probs cast
        # back to the compute dtype for AV (encoder.py:116-150)
        scale = 1.0 / math.sqrt(self.d_model // self.num_heads)

        def attend(lv, x):
            if lv is None:
                return None
            probs = torch.softmax(self.drop(lv[0]).float() * scale,
                                  dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, lv[1])
            return out.reshape(x.shape[0], x.shape[1], self.d_model)

        return attend(vid_lv, vid), attend(usr_lv, usr)

    def _attn_args(self, seed):
        return dict(dropout_rate=self.drop.p, deterministic=not self.training,
                    seed=seed,
                    scale=1.0 / math.sqrt(self.d_model // self.num_heads))

    def _two_block(self, vid, vid_mask, usr, usr_mask, seeds):
        """Projections by nn.Linear, or by the two wide Denses with
        ``fuse_projections``, then attention by kernel K1
        (segformerx.py:437-467)."""
        if self.wide:
            d = self.d_model
            vid_all, usr_all = self.vid_projs(vid), self.usr_projs(usr)
            # column slices in flax's order (segformerx.py:453-456); the
            # kernel takes contiguous heads
            (q_v2v, k_v2v, vv_v2v, q_t2v, k_v2t, vv_v2t) = [
                self._heads(vid_all[..., j * d:(j + 1) * d]).contiguous()
                for j in range(6)]
            (k_t2v, vv_t2v, q_v2t, q_t2t, k_t2t, vv_t2t) = [
                self._heads(usr_all[..., j * d:(j + 1) * d]).contiguous()
                for j in range(6)]
        else:
            q_v2v, k_v2v, vv_v2v = self._qkv("v2v", vid, vid)
            q_t2v, k_t2v, vv_t2v = self._qkv("t2v", vid, usr)
            q_v2t, k_v2t, vv_v2t = self._qkv("v2t", usr, vid)
            q_t2t, k_t2t, vv_t2t = self._qkv("t2t", usr, usr)
        vid_out = fused_two_block_attention(
            q_v2v, q_t2v, k_v2v, k_t2v, vv_v2v, vv_t2v, vid_mask, vid_mask,
            usr_mask, **self._attn_args(seeds[0]))
        usr_out = fused_two_block_attention(
            q_v2t, q_t2t, k_v2t, k_t2t, vv_v2t, vv_t2t, usr_mask, vid_mask,
            usr_mask, **self._attn_args(seeds[1]))
        b = vid.shape[0]
        return (vid_out.reshape(b, vid.shape[1], self.d_model),
                usr_out.reshape(b, usr.shape[1], self.d_model))

    def _single_block(self, vid, vid_mask, usr, usr_mask, seeds):
        """CrossAtt / SelfAtt: projections by nn.Linear, attention by kernel
        K3 (segformerx.py:418-433). SelfAtt's user stream is not run."""
        b = vid.shape[0]
        if self.cross:
            vid_out = fused_masked_attention(
                *self._qkv("t2v", vid, usr), vid_mask, usr_mask,
                **self._attn_args(seeds[0]))
            usr_out = fused_masked_attention(
                *self._qkv("v2t", usr, vid), usr_mask, vid_mask,
                **self._attn_args(seeds[1])).reshape(b, usr.shape[1],
                                                     self.d_model)
        else:
            vid_out = fused_masked_attention(
                *self._qkv("v2v", vid, vid), vid_mask, vid_mask,
                **self._attn_args(seeds[0]))
            usr_out = None
        return vid_out.reshape(b, vid.shape[1], self.d_model), usr_out

    def block_params(self, a, b):
        """(weight, bias) of q1, q2, k1, k2, v1, v2 for block 1 = stream
        ``a`` and block 2 = stream ``b``."""
        pa, pb = getattr(self, f"{a}_proj"), getattr(self, f"{b}_proj")
        return [(lin.weight, lin.bias) for j in "012"
                for lin in (pa[j], pb[j])]

    def _proj_fused(self, vid, vid_mask, usr, usr_mask, seeds):
        """All twelve QKV projections inside kernel K2, or with
        ``fuse_dual`` both streams in one launch of K5 when both are longer
        than one (segformerx.py:319-397). The K2 calls follow the wrapper's
        default version: under ``SEGMM_ATTN_V2=1`` every one of them runs K6,
        the single-query streams included, as the JAX model does in
        interpret mode (:355); K5 and K4 never read the switch."""
        if self.fuse_dual and vid.shape[1] > 1 and usr.shape[1] > 1:
            return fused_dual_stream_attention(
                vid, usr, self.block_params("v2v", "t2v"),
                self.block_params("v2t", "t2t"), vid_mask, usr_mask,
                num_heads=self.num_heads, **self._attn_args(seeds[0]))

        def wb(a, b):
            return [t for p in self.block_params(a, b) for t in p]

        vid_out = fused_proj_two_block_attention(
            vid, vid, usr, *wb("v2v", "t2v"), vid_mask, vid_mask, usr_mask,
            num_heads=self.num_heads, **self._attn_args(seeds[0]))
        usr_out = fused_proj_two_block_attention(
            usr, vid, usr, *wb("v2t", "t2t"), usr_mask, vid_mask, usr_mask,
            num_heads=self.num_heads, **self._attn_args(seeds[1]))
        return vid_out, usr_out


class SegFormerXLayer(nn.Module):
    """Attention + per-stream GELU MLP FFN with post-LN residuals
    (encoder.py:178-208)."""

    def __init__(self, d_model: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1, fused: bool = False,
                 fuse_qkv: bool = False, remat_attention: bool = False,
                 ablation: str = "ours", fuse_projections: bool = False,
                 fuse_dual: bool = False, fuse_layer: bool = False):
        super().__init__()
        # K4 on the 'ours' path, with the composed parameter tree
        # (segformerx.py:518, :132-149)
        self.fuse_layer = fuse_layer and ours_path(ablation)
        self.cross_attn = FourStreamAttention(
            d_model, num_heads, dropout, fused=fused, fuse_qkv=fuse_qkv,
            ablation=ablation,
            fuse_projections=fuse_projections and not self.fuse_layer,
            fuse_dual=fuse_dual)
        # no user state under SelfAtt: no user FFN or LayerNorm
        # (segformerx.py:544-550)
        with_usr = not self.cross_attn.no_usr_state
        self.ff_vid = KnMLP([d_model, ff_dim, d_model], dropout)
        if with_usr:
            self.ff_usr = KnMLP([d_model, ff_dim, d_model], dropout)
        self.ln_vid = LayerNorm(d_model, eps=LN_EPS)
        if with_usr:
            self.ln_usr = LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.remat_attention = remat_attention

    def forward(self, usr_feat, usr_mask, vid_feat, vid_mask,
                seeds: Tuple[int, int] = NO_SEEDS):
        """The new video state and the new user state (None under
        SelfAtt)."""
        if self.fuse_layer:
            return self._fused_layer_forward(usr_feat, usr_mask, vid_feat,
                                             vid_mask, seeds)
        if self.remat_attention and self.training and \
                torch.is_grad_enabled():
            vid_feat, usr_feat = _remat(self.cross_attn, vid_feat, vid_mask,
                                        usr_feat, usr_mask, seeds)
        else:
            vid_feat, usr_feat = self.cross_attn(vid_feat, vid_mask,
                                                 usr_feat, usr_mask, seeds)
        vid_feat = self.ln_vid(vid_feat + self.drop(self.ff_vid(vid_feat)))
        if usr_feat is not None:
            usr_feat = self.ln_usr(usr_feat
                                   + self.drop(self.ff_usr(usr_feat)))
        return vid_feat, usr_feat

    def _fused_layer_forward(self, usr_feat, usr_mask, vid_feat, vid_mask,
                             seeds):
        """Each stream of the layer in one launch of kernel K4, the stream
        wiring of the K2 route (segformerx.py:553-609): video block 1 =
        v2v, block 2 = t2v; user block 1 = v2t, block 2 = t2t."""
        a = self.cross_attn

        def ep(ff, ln1, mlp, ln2):
            return (ff.weight, ff.bias, ln1.weight, ln1.bias,
                    mlp.layers[0].weight, mlp.layers[0].bias,
                    mlp.layers[1].weight, mlp.layers[1].bias, ln2.weight,
                    ln2.bias)

        vid_out = fused_layer_stream(
            vid_feat, vid_feat, usr_feat, a.block_params("v2v", "t2v"),
            ep(a.ff_vid, a.ln_vid, self.ff_vid, self.ln_vid), vid_mask,
            vid_mask, usr_mask, num_heads=a.num_heads,
            **a._attn_args(seeds[0]))
        usr_out = fused_layer_stream(
            usr_feat, vid_feat, usr_feat, a.block_params("v2t", "t2t"),
            ep(a.ff_usr, a.ln_usr, self.ff_usr, self.ln_usr), usr_mask,
            vid_mask, usr_mask, num_heads=a.num_heads,
            **a._attn_args(seeds[1]))
        return vid_out, usr_out


class SegFormerX(nn.Module):
    """The full encoder: input projections (+PE, LN, dropout) and the
    dual-stream layers (encoder.py:327-520).

    Input modes (resolved by tensor rank, like the reference):
      video:  (B, Lv, Dv) float features     -> Linear(Dv -> d)
              (B,) or (B, Lv) int ids        -> Embedding(d/2) ++ Linear(pos -> d/2)
      user:   (B, Lu, Du) float features     -> Linear(Du -> d)
              (B,) or (B, Lu) int ids        -> Embedding(d)   (mask forced to
                                                ones for the (B,) -> (B,1) case)
    """

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_dim: int, max_vid_len: int = 40, max_usr_len: int = 100,
                 dropout: float = 0.1, user_id_max: int = -1,
                 video_id_max: int = -1, feat_dim: int = 1024,
                 use_pe: bool = True, ablation: str = "ours",
                 output_layers: Optional[Sequence[int]] = None,
                 fused_attention: bool = False, fuse_qkv: bool = False,
                 remat: bool = False, remat_scope: str = "layer",
                 fuse_projections: bool = False, fuse_dual: bool = False,
                 fuse_layer: bool = False):
        super().__init__()
        if remat_scope not in ("layer", "attention"):
            raise ValueError(f"remat_scope must be 'layer' or 'attention', "
                             f"got {remat_scope!r}")
        d = d_model
        self.d_model = d
        self.num_layers = num_layers
        self.max_vid_len = max_vid_len
        self.use_pe = use_pe
        self.user_ids = user_id_max >= 0
        self.video_ids = video_id_max >= 0
        if self.video_ids:
            self.vid_proj = nn.Embedding(video_id_max + 1, d // 2)
            self.frameid_proj = nn.Linear(1, d // 2)
        else:
            self.vid_proj = nn.Linear(feat_dim, d)
        self.usr_proj = (nn.Embedding(user_id_max + 1, d) if self.user_ids
                         else nn.Linear(feat_dim, d))
        self.vid_pe = nn.Parameter(torch.zeros(max_vid_len, d))
        self.usr_pe = nn.Parameter(torch.zeros(max_usr_len, d))
        self.vid_ln = LayerNorm(d, eps=LN_EPS)
        self.usr_ln = LayerNorm(d, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.fused_attention = fused_attention
        # K4 saves only the layer inputs and recomputes the rest in its
        # backward, so whole-layer remat is off while it runs
        # (segformerx.py:785-803)
        self.fuse_layer = fuse_layer and ours_path(ablation)
        self.remat_layers = (remat and remat_scope == "layer"
                             and not self.fuse_layer)
        self.ablation = ablation
        self.no_pos = "noPos" in ablation
        # where the kernels' dropout seeds and noPos's permutations come
        # from (None: torch's default CPU generator); the engine sets both,
        # seeded from its config
        self.seed_generator: Optional[torch.Generator] = None
        self.permute_generator: Optional[torch.Generator] = None
        # intermediate state i is the INPUT of layer i, so only layers
        # 0..max(output_layers)-1 are observable and built (PARITY M1)
        self.output_layers = (list(output_layers) if output_layers is not None
                              else list(range(num_layers)))
        wanted = sorted({i % num_layers for i in self.output_layers})
        n_run = max(wanted) if wanted else 0
        # the MLP ablations replace the stack (segformerx.py:742-757)
        hidden = {"CrossMLP": max(num_layers - 4, 0),
                  "SelfMLP": max(num_layers - 2, 0)}.get(ablation)
        if hidden is not None:
            self.encoder_mlp = MLPBlock(d, [d] * hidden, d, dropout)
        if ablation in MLP_ABLATIONS:
            n_run = 0
        self.layers = nn.ModuleList(
            SegFormerXLayer(d, num_heads, ff_dim, dropout,
                            fused=fused_attention, fuse_qkv=fuse_qkv,
                            remat_attention=remat and
                            remat_scope == "attention", ablation=ablation,
                            fuse_projections=fuse_projections,
                            fuse_dual=fuse_dual, fuse_layer=fuse_layer)
            for _ in range(n_run))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_normal_(self, generator)
        self.vid_pe.data.normal_(0.0, INIT_STD, generator=generator)
        self.usr_pe.data.normal_(0.0, INIT_STD, generator=generator)

    def _layer_seeds(self) -> List[Tuple[int, int]]:
        """Two kernel dropout seeds per layer in [0, 2^31 - 1), drawn on the
        host as segformerx.py:330-331,566-567 draw them, only where the
        kernels apply dropout (training on the kernel routes and under
        ``fuse_layer``)."""
        n = len(self.layers)
        if not (self.training and (self.fused_attention or self.fuse_layer)
                and self.drop.p > 0):
            return [NO_SEEDS] * n
        seeds = torch.randint(0, 2 ** 31 - 1, (n, 2),
                              generator=self.seed_generator)
        return [tuple(r) for r in seeds.tolist()]

    def forward(self, usr_feat, usr_mask, vid_feat, vid_mask
                ) -> tuple[List[torch.Tensor], torch.Tensor]:
        dt = self.vid_pe.dtype
        # ---- normalize input ranks (encoder.py:478-488) ----
        if usr_feat.dim() == 1:
            usr_feat = usr_feat[:, None]
            usr_mask = torch.ones(usr_feat.shape[:2], dtype=torch.bool,
                                  device=usr_feat.device)
        if vid_feat.dim() == 1:
            vid_feat = vid_feat[:, None].expand(-1, self.max_vid_len)
        usr_mask = usr_mask.bool()
        vid_mask = vid_mask.bool()
        B, Lv = vid_feat.shape[:2]

        # ---- input projections (encoder.py:352-362,425-445) ----
        if self.video_ids:
            vid_emb = self.vid_proj(vid_feat.long())
            if self.no_pos and self.training:
                # each row's frame positions in a random order
                # (segformerx.py:705-709), drawn on the host before any
                # recomputed region
                positions = torch.rand(
                    B, Lv, generator=self.permute_generator).argsort(
                        dim=1).to(vid_feat.device, dt)
            else:
                positions = torch.arange(Lv, dtype=dt,
                                         device=vid_feat.device
                                         ).expand(B, Lv)
            frame_emb = self.frameid_proj(positions[..., None])
            vid_x = torch.cat([vid_emb, frame_emb], dim=-1)
        else:
            vid_x = self.vid_proj(vid_feat.to(dt))
        usr_x = (self.usr_proj(usr_feat.long()) if self.user_ids
                 else self.usr_proj(usr_feat.to(dt)))

        # ---- learned positional embeddings + LN + dropout (425-473) ----
        if self.use_pe:
            vid_x = vid_x + self.vid_pe[None, :vid_x.shape[1]]
            usr_x = usr_x + self.usr_pe[None, :usr_x.shape[1]]
        vid_x = self.drop(self.vid_ln(vid_x))
        usr_x = self.drop(self.usr_ln(usr_x))

        # ---- ablation MLP paths (encoder.py:503-511) ----
        if self.ablation == "CrossMLP":
            out = self.encoder_mlp(torch.cat([usr_x, vid_x], dim=-2))
            return [adaptive_avg_pool_seq(out, self.max_vid_len)], usr_x
        if self.ablation == "SelfMLP":
            return [self.encoder_mlp(vid_x)], usr_x
        if self.ablation == "w/oAtt":
            return [vid_x], usr_x

        # ---- encoder stack (encoder.py:302-324) ----
        states = [vid_x]
        vid_cur, usr_cur = vid_x, usr_x
        remat = self.remat_layers and self.training and \
            torch.is_grad_enabled()
        for layer, seeds in zip(self.layers, self._layer_seeds()):
            args = (usr_cur, usr_mask, vid_cur, vid_mask, seeds)
            vid_cur, usr_next = (_remat(layer, *args) if remat
                                 else layer(*args))
            if usr_next is not None:  # SelfAtt keeps the user state
                usr_cur = usr_next
            states.append(vid_cur)
        return [states[i % self.num_layers] for i in self.output_layers], \
            usr_cur
