"""Segment-interest model: SegFormerX backbone(s) + fusion head (port of
``segmminterest_tpu/models/interest.py``; the loss zoo is
``models/losses.py``).

Behavioral spec: reference MMinterest/models/decoder_leave_focal.py
(MultiScaleTemporalDetrLeaveFocal :425-658, InteractionAggregation :392-423).

Fusion heads (``fusion_heads``, reference :459-471,624-636):
  -3 / -2 : add last states, Linear(d -> 1)
  -1      : concat last states, Linear(2d -> 1)
   0      : Linear(d -> 1) per backbone, summed
  >=1     : InteractionAggregation bilinear fusion with that many heads
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .segformerx import LayerNorm, MLPBlock, SegFormerX


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax Dense in the compute dtype: the input cast to the weight's
    dtype first (an MLP ablation's state is fp32 in a bf16 model)."""
    return lin(x.to(lin.weight.dtype))


class InteractionAggregation(nn.Module):
    """Bilinear two-stream aggregation head (decoder_leave_focal.py:392-423,
    itself FinalMLP's InteractionAggregation). x, y: (..., D) -> (...)."""

    def __init__(self, x_dim: int, y_dim: int, output_dim: int = 1,
                 num_heads: int = 1):
        super().__init__()
        self.x_dim, self.y_dim = x_dim, y_dim
        self.output_dim = output_dim
        self.num_heads = num_heads
        self.w_x = nn.Linear(x_dim, output_dim)
        self.w_y = nn.Linear(y_dim, output_dim)
        if num_heads > 0:
            hx, hy = x_dim // num_heads, y_dim // num_heads
            self.w_xy = nn.Parameter(
                torch.zeros(num_heads * hx * hy, output_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # xavier_uniform for w_x/w_y (zero bias), plain xavier_normal for
        # w_xy, as the reference initialises them
        for lin in (self.w_x, self.w_y):
            fan_in, fan_out = lin.weight.shape[1], lin.weight.shape[0]
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            lin.weight.data.uniform_(-bound, bound, generator=generator)
            lin.bias.data.zero_()
        if self.num_heads > 0:
            fan_in, fan_out = self.w_xy.shape
            std = (2.0 / (fan_in + fan_out)) ** 0.5
            self.w_xy.data.normal_(0.0, std, generator=generator)

    def forward(self, x, y):
        lead = x.shape[:-1]
        out = _dense(self.w_x, x) + _dense(self.w_y, y)
        if self.num_heads > 0:
            H = self.num_heads
            hx, hy = self.x_dim // H, self.y_dim // H
            head_x = x.reshape(lead + (H, hx))
            head_y = y.reshape(lead + (H, hy))
            w = self.w_xy.to(x.dtype).reshape(H, hx, hy * self.output_dim)
            # xy[..., o] = sum_{h,p,q} x[..., h, p] W[h,p,q,o] y[..., h, q]
            tmp = torch.einsum("...hp,hpz->...hz", head_x, w)
            tmp = tmp.reshape(lead + (H, hy, self.output_dim))
            out = out + torch.einsum("...hqo,...hq->...o", tmp, head_y)
        return out.squeeze(-1) if self.output_dim == 1 else out


class SegInterestModel(nn.Module):
    """Single- or dual-backbone interest model producing (B, 40) logits."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_dim: int, n_users: int, n_items: int,
                 max_vid_len: int = 40, max_usr_len_image: int = 100,
                 dropout: float = 0.1, user_input: str = "both",
                 photo_input: str = "both", fusion_heads: int = 2,
                 learnable_bias: bool = False, use_pe: bool = True,
                 ablation: str = "ours", feat_dim: int = 1024,
                 fused_attention: bool = False, fuse_qkv: bool = False,
                 remat: bool = False, remat_scope: str = "layer",
                 fuse_projections: bool = False, fuse_dual: bool = False,
                 fuse_layer: bool = False):
        super().__init__()
        self.user_input, self.photo_input = user_input, photo_input
        self.fusion_heads = fusion_heads
        self.max_vid_len = max_vid_len
        self.dual = user_input == "both" or photo_input == "both"

        def backbone(user_id_max, max_usr_len, video_id_max):
            return SegFormerX(
                d_model=d_model, num_heads=num_heads, num_layers=num_layers,
                ff_dim=ff_dim, max_vid_len=max_vid_len,
                max_usr_len=max_usr_len, dropout=dropout,
                user_id_max=user_id_max, video_id_max=video_id_max,
                feat_dim=feat_dim, use_pe=use_pe, ablation=ablation,
                output_layers=[-1], fused_attention=fused_attention,
                fuse_qkv=fuse_qkv, remat=remat, remat_scope=remat_scope,
                fuse_projections=fuse_projections, fuse_dual=fuse_dual,
                fuse_layer=fuse_layer)

        u1_id = -1 if user_input in ("both", "image") else n_users
        u1_len = 1 if u1_id >= 0 else max_usr_len_image
        v1_id = -1 if photo_input in ("both", "image") else n_items
        self.backbone1 = backbone(u1_id, u1_len, v1_id)
        if self.dual:
            u2_id = -1 if user_input == "image" else n_users
            u2_len = max_usr_len_image if u2_id < 0 else 1
            v2_id = -1 if photo_input == "image" else n_items
            self.backbone2 = backbone(u2_id, u2_len, v2_id)
            if fusion_heads in (-3, -2, 0):
                self.stage_mlp1 = nn.Linear(d_model, 1)
                if fusion_heads == 0:
                    self.stage_mlp2 = nn.Linear(d_model, 1)
            elif fusion_heads == -1:
                self.stage_mlp1 = nn.Linear(2 * d_model, 1)
            else:
                self.fusion_module = InteractionAggregation(
                    d_model, d_model, output_dim=1, num_heads=fusion_heads)
        else:
            self.stage_mlp1 = nn.Linear(d_model, 1)
        self.learnable_bias = learnable_bias
        if learnable_bias:
            self.bias_weight = nn.Parameter(torch.ones(1, max_vid_len))
            self.bias_bias = nn.Parameter(torch.ones(1, max_vid_len))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Reference init from an explicit generator: backbones N(0, 0.02),
        fusion heads xavier, learnable bias ones."""
        self.backbone1.reset_parameters(generator)
        if self.dual:
            self.backbone2.reset_parameters(generator)
        for name in ("stage_mlp1", "stage_mlp2"):
            lin = getattr(self, name, None)
            if lin is not None:
                fan_in, fan_out = lin.weight.shape[1], lin.weight.shape[0]
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                lin.weight.data.uniform_(-bound, bound, generator=generator)
                lin.bias.data.zero_()
        if hasattr(self, "fusion_module"):
            self.fusion_module.reset_parameters(generator)
        if self.learnable_bias:
            self.bias_weight.data.fill_(1.0)
            self.bias_bias.data.fill_(1.0)

    def backbones(self):
        return [self.backbone1] + ([self.backbone2] if self.dual else [])

    def set_seed_generator(self, generator: Optional[torch.Generator],
                           permute_generator: Optional[torch.Generator]
                           = None):
        """The generators the backbones draw their kernel dropout seeds and
        noPos's position permutations from."""
        for bb in self.backbones():
            bb.seed_generator = generator
            bb.permute_generator = permute_generator

    def fp32_param_names(self):
        """Parameters that stay fp32 whatever the compute dtype: LayerNorm
        scale and bias and the learnable positional bias, which the flax
        model uses in fp32 (param_dtype), and the MLP ablations'
        ``encoder_mlp``, which flax runs in fp32; every other weight is used
        in the compute dtype."""
        names = {f"{m}.{p}" for m, mod in self.named_modules()
                 if isinstance(mod, (LayerNorm, MLPBlock))
                 for p, _ in mod.named_parameters()}
        if self.learnable_bias:
            names |= {"bias_weight", "bias_bias"}
        return names

    def to_compute_dtype(self, dtype: torch.dtype) -> "SegInterestModel":
        """Cast every parameter to ``dtype`` except
        :meth:`fp32_param_names`, in place."""
        keep = self.fp32_param_names()
        for name, p in self.named_parameters():
            p.data = p.data.to(torch.float32 if name in keep else dtype)
        return self

    def forward(self, usr_image, usr_id, usr_mask, vid_image, vid_id,
                vid_mask):
        """Per-segment interest logits (B, max_vid_len), with the learnable
        positional bias added (reference :574-658). Routing per modality:
        'both' gives backbone1 the image stream and backbone2 the ids."""
        if self.dual:
            ui, pi = self.user_input, self.photo_input
            usr1 = usr_image if ui in ("both", "image") else usr_id
            usr2 = usr_id if ui in ("both", "id") else usr_image
            vid1 = vid_image if pi in ("both", "image") else vid_id
            vid2 = vid_id if pi in ("both", "id") else vid_image
            s1 = self.backbone1(usr1, usr_mask, vid1, vid_mask)[0][-1]
            s2 = self.backbone2(usr2, usr_mask, vid2, vid_mask)[0][-1]
            if self.fusion_heads in (-3, -2):
                logits = _dense(self.stage_mlp1, s1 + s2).squeeze(-1)
            elif self.fusion_heads == -1:
                logits = _dense(self.stage_mlp1,
                                torch.cat([s1, s2], -1)).squeeze(-1)
            elif self.fusion_heads == 0:
                logits = (_dense(self.stage_mlp1, s1)
                          + _dense(self.stage_mlp2, s2)).squeeze(-1)
            else:
                logits = self.fusion_module(s1, s2)
        else:
            usr = usr_id if self.user_input == "id" else usr_image
            vid = vid_id if self.photo_input == "id" else vid_image
            logits = _dense(
                self.stage_mlp1,
                self.backbone1(usr, usr_mask, vid, vid_mask)[0][-1]
            ).squeeze(-1)
        if self.learnable_bias:
            # (pos + 1) * w + b, broadcast over batch (reference :496-504)
            pos = torch.arange(self.max_vid_len, dtype=logits.dtype,
                               device=logits.device)
            logits = logits + ((pos[None, :] + 1.0) * self.bias_weight
                               + self.bias_bias)
        return logits
