"""Weights of the JAX package -> the port's ``state_dict``.

Input is the flax ``params`` tree of a ``SegInterestModel`` (or of a
watch-time model, ``models/watchtime.py``) as nested dicts of numpy arrays,
or of torch tensors where numpy has no dtype (bf16 leaves of a ``.msgpack``
checkpoint, ``engine/checkpoint.py``); no flax is needed to read it. Path
rules, as in tools/ref_torch_loader.py:175-265:

  Dense  {kernel (in, out), bias}  -> {weight (out, in), bias}
  Embed  {embedding}               -> {weight} as is
  LayerNorm {scale, bias}          -> {weight, bias}
  other leaves (vid_pe, usr_pe, fusion_module/w_xy, bias_weight/bias_bias)
                                   -> as is, cast to fp32
  ``layer_{i}`` (encoder layer, KnMLP layer) -> ``layers.{i}``
  ``{stream}_proj_{j}``            -> ``{stream}_proj.{j}``

The same tree serves every attention route: the projection-fused path
declares Dense-compatible names (segformerx.py:96-107). Every leaf must land
on a key of the target model with the same shape, and every key of the
model must be written; anything else raises (``partial`` keeps the leaves
that land and writes what they cover, as the JAX SegRec runner's partial
restore does).

SegRec models (``segrec/``, :func:`segrec_state_dict`) take their flax
``params`` and ``batch_stats`` together: the port's modules carry the flax
names, so the same rules apply, and a BatchNorm's ``{scale, bias}`` params
and ``{mean, var}`` statistics land on its ``weight``, ``bias``, ``mean``
and ``var``; Dice's ``alpha`` and the models' single parameters
(``overall_bias``, ``trainable_interest_weight``; LightGCN's tables,
Caser's convolutions, SRGNN's ``w_ih`` / ``w_hh`` used as ``x @ w.T``)
go as they are, untransposed; a GRU's ``{name}/cell/x2h`` lands on
``{name}.cell.x2h``. The models of the other runners carry the flax
tree's names too: a reranker's ranker under ``ranker``, MIR's LSTM cells
``OptimizedLSTMCell_0`` / ``_1`` (Dense ``ii``...``io`` without a bias,
``hi``...``ho`` with one), SetRank's inducing points ``I_{b}``, MIR's
``w_b`` / ``w_v`` / ``w_q``, SLRCPlus's ``global_alpha`` and KDA's
``freq_real`` / ``freq_imag`` as they are.

MMRec models (``mmrec/models.py``, :func:`mmrec_state_dict`) carry the
flax names too: the tables ``user_embedding``, ``item_id_embedding``,
``new_pos_embedding`` and the scalar ``learnable_param`` as they are, the
Denses ``image_trs``, ``predictor``, ``modal_trs``, ``modal_layer_u_{l}``
and ``modal_layer_i_{l}`` transposed.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

_LAYER = re.compile(r"^layer_(\d+)$")
_PROJ = re.compile(r"^(t2v|v2v|t2t|v2t)_proj_(\d+)$")


def _module_key(name: str) -> str:
    m = _LAYER.match(name)
    if m:
        return f"layers.{m.group(1)}"
    m = _PROJ.match(name)
    if m:
        return f"{m.group(1)}_proj.{m.group(2)}"
    return name


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        elif isinstance(v, torch.Tensor):  # bf16 is exact in fp32
            yield prefix + (k,), v.detach().float().cpu().numpy()
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(params: Mapping,
                       model: Union[nn.Module, Mapping[str, torch.Tensor]],
                       partial: bool = False) -> Dict[str, torch.Tensor]:
    """The state_dict for ``model`` (a module, or its tensors by name)
    holding the flax ``params``; every shape checked against the model,
    every model key covered. ``partial``: leaves without a key of the same
    shape are skipped and the model's other keys left out."""
    target = model.state_dict() if isinstance(model, nn.Module) else model
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        *mods, leaf = path
        base = ".".join(_module_key(m) for m in mods)
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of rank "
                                 f"{arr.ndim} (only Dense is ported)")
            key, arr = f"{base}.weight", arr.T
        elif leaf in ("scale", "embedding"):
            key = f"{base}.weight"
        else:
            key = f"{base}.{leaf}" if base else leaf
        if partial and (key not in target
                        or tuple(target[key].shape) != arr.shape):
            continue
        if key not in target:
            raise KeyError(f"flax param {'/'.join(path)} -> {key}: no such "
                           "key in the model")
        if tuple(target[key].shape) != arr.shape:
            raise ValueError(f"{'/'.join(path)} -> {key}: shape {arr.shape} "
                             f"vs model {tuple(target[key].shape)}")
        if key in out:
            raise KeyError(f"two flax params map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    missing = sorted(set(target) - set(out))
    if missing and not partial:
        raise KeyError(f"model keys with no flax param: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the flax ``params`` into ``model`` (cast to its dtype)."""
    model.load_state_dict(flax_to_state_dict(params, model))
    return model


def _merge(a: Mapping, b: Mapping) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out else v
    return out


def segrec_state_dict(model: nn.Module, params: Mapping,
                      batch_stats: Optional[Mapping] = None,
                      partial: bool = False) -> Dict[str, torch.Tensor]:
    """The state_dict of a SegRec ``model`` holding the flax ``params`` and
    ``batch_stats``. Without ``batch_stats`` only the parameters are
    written (the BatchNorm statistics stay the model's)."""
    if batch_stats is None:
        target = dict(model.named_parameters())
        return flax_to_state_dict(params, target, partial=partial)
    return flax_to_state_dict(_merge(params, batch_stats), model,
                              partial=partial)


def mmrec_state_dict(model: nn.Module,
                     params: Mapping) -> Dict[str, torch.Tensor]:
    """The state_dict of an MMRec ``model`` holding the flax ``params`` (its
    graph arrays and features are buffers outside the state_dict)."""
    return flax_to_state_dict(params, model)
