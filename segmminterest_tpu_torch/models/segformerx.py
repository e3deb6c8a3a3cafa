"""SegFormerX — the dual-stream (user x video) segment transformer (port of
``segmminterest_tpu/models/segformerx.py``, 'ours' path).

Behavioral spec: reference MMinterest/models/encoder.py (SegFormerX,
SegFormerXEncoder, SegFormerXEncoderLayer, SegFormerXAttention).

The four attention streams (v2v, t2v, v2t, t2t) run on one of three routes,
chosen by the same flags as the JAX package:

* ``fused_attention=False``: composed PyTorch ops, the concat-KV
  construction the JAX package leaves to XLA (segformerx.py:228-317);
* ``fused_attention=True``: projections by ``nn.Linear``, then the two-block
  attention kernel K1 (core/attention.py:fused_two_block_attention,
  segformerx.py:399-481);
* ``fused_attention=True, fuse_qkv=True``: the six projections of each
  stream inside kernel K2 (core/attention.py:fused_proj_two_block_attention,
  segformerx.py:319-397). Unlike the TPU build, single-query streams
  (the ID backbone's user stream) go through K2 as well.

Faithful quirks (PARITY.md): masked logits are filled with -10000 before
the 1/sqrt(d_head) scale; dropout acts on attention logits; LayerNorm eps is
1e-12; GELU is exact; ``output_layers=[-1]`` selects the INPUT of the last
encoder layer, so that layer is never built (PARITY M1).

Training: dropout runs inside the kernels on the K1 and K2 routes (the hash
mask of core/attention.py, seeded per attention call as segformerx.py:
328-333,412-416 seeds them: two int32 per layer, slot 0 for the video
stream, slot 1 for the user stream) and through ``nn.Dropout`` elsewhere.
The seeds are drawn from ``seed_generator`` before any recomputed region,
so a remat replay sees the same ones. ``remat`` recomputes each encoder
layer (scope 'layer') or each attention block (scope 'attention') in the
backward with ``torch.utils.checkpoint`` (segformerx.py:795-803,521-536);
it changes no numbers.

Compute dtype: the model runs in the dtype of its Dense/Embedding weights.
LayerNorm keeps fp32 statistics, scale and bias and casts its output, as
flax's LayerNorm(dtype=compute dtype) over fp32 params does
(:class:`LayerNorm`).

The ablation paths, the sr_ratio / patch-merge pyramid, ``fuse_projections``,
``fuse_dual`` and ``fuse_layer`` are not ported yet; the port raises on them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.attention import (fused_proj_two_block_attention,
                              fused_two_block_attention)
from ..core.numerics import masked_attention_logits

LN_EPS = 1e-12
INIT_STD = 0.02  # encoder.py:414-423: Linear/Embedding ~ N(0, 0.02)
NO_SEEDS = (0, 0)


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


class FourStreamAttention(nn.Module):
    """v2v / t2v / v2t / t2t attention with per-stream QKV projections and
    concatenated KV for the user<->video cross streams
    (encoder.py:12-175). Stream wiring: vid queries attend block 1 = v2v
    (k/v of vid) and block 2 = t2v (k/v of usr); usr queries attend block 1
    = v2t (k/v of vid) and block 2 = t2t (k/v of usr)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 fused: bool = False, fuse_qkv: bool = False):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.fused = fused
        self.fuse_qkv = fuse_qkv
        for s in ("t2v", "v2v", "t2t", "v2t"):
            setattr(self, f"{s}_proj", nn.ModuleList(
                nn.Linear(d_model, d_model) for _ in range(3)))
        self.ff_usr = nn.Linear(d_model, d_model)
        self.ff_vid = nn.Linear(d_model, d_model)
        self.ln_vid = LayerNorm(d_model, eps=LN_EPS)
        self.ln_usr = LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def _heads(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, self.d_model // self.num_heads)

    def forward(self, vid_feat, vid_mask, usr_feat, usr_mask,
                seeds: Tuple[int, int] = NO_SEEDS):
        """``seeds``: the kernels' dropout seeds of the video and the user
        stream (used in training on the K1 and K2 routes)."""
        if self.fused and self.fuse_qkv:
            vid_out, usr_out = self._proj_fused(vid_feat, vid_mask, usr_feat,
                                                usr_mask, seeds)
        elif self.fused:
            vid_out, usr_out = self._two_block(vid_feat, vid_mask, usr_feat,
                                               usr_mask, seeds)
        else:
            vid_out, usr_out = self._composed(vid_feat, vid_mask, usr_feat,
                                              usr_mask)
        usr_out = self.drop(self.ff_usr(usr_out))
        vid_out = self.drop(self.ff_vid(vid_out))
        vid_feat = self.ln_vid(vid_feat + vid_out)
        usr_feat = self.ln_usr(usr_feat + usr_out)
        return vid_feat, usr_feat

    def _composed(self, vid, vid_mask, usr, usr_mask):
        """Materialised concat-KV attention (segformerx.py:236-304)."""
        h = self._heads
        t2v, v2v, t2t, v2t = self.t2v_proj, self.v2v_proj, self.t2t_proj, \
            self.v2t_proj
        v2v_l = masked_attention_logits(h(v2v[0](vid)), h(v2v[1](vid)),
                                        vid_mask, vid_mask)
        t2v_l = masked_attention_logits(h(t2v[0](vid)), h(t2v[1](usr)),
                                        vid_mask, usr_mask)
        v2t_l = masked_attention_logits(h(v2t[0](usr)), h(v2t[1](vid)),
                                        usr_mask, vid_mask)
        t2t_l = masked_attention_logits(h(t2t[0](usr)), h(t2t[1](usr)),
                                        usr_mask, usr_mask)
        v_logits = torch.cat([v2v_l, t2v_l], dim=-1)
        t_logits = torch.cat([v2t_l, t2t_l], dim=-1)
        v_value = torch.cat([h(v2v[2](vid)), h(t2v[2](usr))], dim=1)
        t_value = torch.cat([h(v2t[2](vid)), h(t2t[2](usr))], dim=1)
        # dropout on logits, then scale, then an fp32 softmax; probs cast
        # back to the compute dtype for AV (encoder.py:116-150)
        scale = 1.0 / math.sqrt(self.d_model // self.num_heads)
        dt = vid.dtype
        v_probs = torch.softmax(self.drop(v_logits).float() * scale,
                                dim=-1).to(dt)
        t_probs = torch.softmax(self.drop(t_logits).float() * scale,
                                dim=-1).to(dt)
        b = vid.shape[0]
        vid_out = torch.einsum("bhqk,bkhd->bqhd", v_probs, v_value)
        usr_out = torch.einsum("bhqk,bkhd->bqhd", t_probs, t_value)
        return (vid_out.reshape(b, vid.shape[1], self.d_model),
                usr_out.reshape(b, usr.shape[1], self.d_model))

    def _attn_args(self, seed):
        return dict(dropout_rate=self.drop.p, deterministic=not self.training,
                    seed=seed,
                    scale=1.0 / math.sqrt(self.d_model // self.num_heads))

    def _two_block(self, vid, vid_mask, usr, usr_mask, seeds):
        """Projections by nn.Linear, attention by kernel K1
        (segformerx.py:437-467)."""
        h = self._heads
        t2v, v2v, t2t, v2t = self.t2v_proj, self.v2v_proj, self.t2t_proj, \
            self.v2t_proj
        vid_out = fused_two_block_attention(
            h(v2v[0](vid)), h(t2v[0](vid)), h(v2v[1](vid)), h(t2v[1](usr)),
            h(v2v[2](vid)), h(t2v[2](usr)), vid_mask, vid_mask, usr_mask,
            **self._attn_args(seeds[0]))
        usr_out = fused_two_block_attention(
            h(v2t[0](usr)), h(t2t[0](usr)), h(v2t[1](vid)), h(t2t[1](usr)),
            h(v2t[2](vid)), h(t2t[2](usr)), usr_mask, vid_mask, usr_mask,
            **self._attn_args(seeds[1]))
        b = vid.shape[0]
        return (vid_out.reshape(b, vid.shape[1], self.d_model),
                usr_out.reshape(b, usr.shape[1], self.d_model))

    def _proj_fused(self, vid, vid_mask, usr, usr_mask, seeds):
        """All twelve QKV projections inside kernel K2
        (segformerx.py:319-397)."""
        def wb(*lins):
            return [t for lin in lins for t in (lin.weight, lin.bias)]

        t2v, v2v, t2t, v2t = self.t2v_proj, self.v2v_proj, self.t2t_proj, \
            self.v2t_proj
        vid_out = fused_proj_two_block_attention(
            vid, vid, usr,
            *wb(v2v[0], t2v[0], v2v[1], t2v[1], v2v[2], t2v[2]),
            vid_mask, vid_mask, usr_mask, num_heads=self.num_heads,
            **self._attn_args(seeds[0]))
        usr_out = fused_proj_two_block_attention(
            usr, vid, usr,
            *wb(v2t[0], t2t[0], v2t[1], t2t[1], v2t[2], t2t[2]),
            usr_mask, vid_mask, usr_mask, num_heads=self.num_heads,
            **self._attn_args(seeds[1]))
        return vid_out, usr_out


class SegFormerXLayer(nn.Module):
    """Attention + per-stream GELU MLP FFN with post-LN residuals
    (encoder.py:178-208)."""

    def __init__(self, d_model: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1, fused: bool = False,
                 fuse_qkv: bool = False, remat_attention: bool = False):
        super().__init__()
        self.cross_attn = FourStreamAttention(d_model, num_heads, dropout,
                                              fused=fused, fuse_qkv=fuse_qkv)
        self.ff_vid = KnMLP([d_model, ff_dim, d_model], dropout)
        self.ff_usr = KnMLP([d_model, ff_dim, d_model], dropout)
        self.ln_vid = LayerNorm(d_model, eps=LN_EPS)
        self.ln_usr = LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.remat_attention = remat_attention

    def forward(self, usr_feat, usr_mask, vid_feat, vid_mask,
                seeds: Tuple[int, int] = NO_SEEDS):
        if self.remat_attention and self.training and \
                torch.is_grad_enabled():
            vid_feat, usr_feat = _remat(self.cross_attn, vid_feat, vid_mask,
                                        usr_feat, usr_mask, seeds)
        else:
            vid_feat, usr_feat = self.cross_attn(vid_feat, vid_mask,
                                                 usr_feat, usr_mask, seeds)
        vid_feat = self.ln_vid(vid_feat + self.drop(self.ff_vid(vid_feat)))
        usr_feat = self.ln_usr(usr_feat + self.drop(self.ff_usr(usr_feat)))
        return vid_feat, usr_feat


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
                 remat: bool = False, remat_scope: str = "layer"):
        super().__init__()
        if ablation != "ours":
            raise NotImplementedError(
                f"ablation {ablation!r} is not ported yet (only 'ours')")
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
        self.remat_layers = remat and remat_scope == "layer"
        # where the kernels' dropout seeds come from (None: torch's default
        # CPU generator); the engine sets one seeded from its config
        self.seed_generator: Optional[torch.Generator] = None
        # intermediate state i is the INPUT of layer i, so only layers
        # 0..max(output_layers)-1 are observable and built (PARITY M1)
        self.output_layers = (list(output_layers) if output_layers is not None
                              else list(range(num_layers)))
        wanted = sorted({i % num_layers for i in self.output_layers})
        n_run = max(wanted) if wanted else 0
        self.layers = nn.ModuleList(
            SegFormerXLayer(d, num_heads, ff_dim, dropout,
                            fused=fused_attention, fuse_qkv=fuse_qkv,
                            remat_attention=remat and
                            remat_scope == "attention")
            for _ in range(n_run))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_normal_(self, generator)
        self.vid_pe.data.normal_(0.0, INIT_STD, generator=generator)
        self.usr_pe.data.normal_(0.0, INIT_STD, generator=generator)

    def _layer_seeds(self) -> List[Tuple[int, int]]:
        """Two kernel dropout seeds per layer in [0, 2^31 - 1), drawn on the
        host as segformerx.py:330-331 draws them, only where the kernels
        apply dropout (training on the K1/K2 routes)."""
        n = len(self.layers)
        if not (self.training and self.fused_attention and self.drop.p > 0):
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
            positions = torch.arange(Lv, dtype=dt, device=vid_feat.device)
            frame_emb = self.frameid_proj(
                positions[None, :, None].expand(B, Lv, 1))
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

        # ---- encoder stack (encoder.py:302-324) ----
        states = [vid_x]
        vid_cur, usr_cur = vid_x, usr_x
        remat = self.remat_layers and self.training and \
            torch.is_grad_enabled()
        for layer, seeds in zip(self.layers, self._layer_seeds()):
            args = (usr_cur, usr_mask, vid_cur, vid_mask, seeds)
            vid_cur, usr_cur = _remat(layer, *args) if remat else layer(*args)
            states.append(vid_cur)
        return [states[i % self.num_layers] for i in self.output_layers], \
            usr_cur
