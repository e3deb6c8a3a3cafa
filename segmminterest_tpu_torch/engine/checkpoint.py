"""Latest + best-on-monitored-metric checkpointing, as torch files (port of
``segmminterest_tpu/engine/checkpoint.py``).

Behavioral spec: reference MMinterest/models/kn_util/nn_utils/checkpoint.py
(CheckPointer :11-75): every save writes ``ckpt-latest.pt``; when the
monitored metric improves, the previous best file is removed and a new
``ckpt-best-ep{epoch}-{metric}.pt`` is written. ``load_checkpoint`` with
``mode='best'`` globs for the best file.

State is ``{"params": {name: tensor}, "opt_state": optimizer state_dict}``
(nested dicts, lists, tuples, numbers and tensors); it is saved on the host
with ``torch.save`` and loaded with ``weights_only=True``. Loading copies
the params into the target's tensors in place, as ``load_state_dict`` does
(every name and shape checked), so a target that shares storage with a
model updates that model; every other entry the target names (the
optimizer state) comes back as it was saved, on the host. A target without
``opt_state`` (serving) reads the params only. The JAX package's
``.msgpack`` checkpoints are not read yet.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _copy_into(target, loaded, path="state"):
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != target.shape:
            raise ValueError(f"{path}: checkpoint holds "
                             f"{getattr(loaded, 'shape', type(loaded))}, "
                             f"target {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(loaded)
        return target
    if isinstance(target, Mapping):
        if set(target) != set(loaded):
            raise KeyError(f"{path}: keys differ from the checkpoint's: "
                           f"{sorted(set(target) ^ set(loaded))[:8]}")
        return {k: _copy_into(v, loaded[k], f"{path}/{k}")
                for k, v in target.items()}
    return loaded


class CheckPointer:
    def __init__(self, monitor: str, work_dir: str, mode: str = "min") -> None:
        self.monitor = monitor
        self.best_metric: Optional[float] = None
        self.work_dir = work_dir
        self.mode = mode
        os.makedirs(work_dir, exist_ok=True)
        self.ckpt_latest = osp.join(work_dir, "ckpt-latest.pt")
        self.ckpt_best_fmt = osp.join(work_dir, "ckpt-best-ep{}-{}.pt")

    def better(self, new: float, orig: Optional[float]) -> bool:
        if orig is None:
            return True
        return new < orig if self.mode == "min" else new > orig

    def save_checkpoint(self, state: Dict[str, Any], num_epochs: int,
                        metric_vals: Optional[Dict[str, float]] = None) -> bool:
        """Write latest; update best when metric_vals[monitor] improves.
        Returns True when a new best was written."""
        save_dict = dict(state=_to_host(state), num_epochs=num_epochs,
                         metrics={k: float(v) for k, v in
                                  (metric_vals or {}).items()})
        torch.save(save_dict, self.ckpt_latest)
        if metric_vals:
            val = float(metric_vals[self.monitor])
            if self.better(val, self.best_metric):
                self.best_metric = val
                for old in glob.glob(self.ckpt_best_fmt.format("*", "*")):
                    os.remove(old)
                torch.save(save_dict, self.ckpt_best_fmt.format(
                    num_epochs, np.round(val, decimals=6)))
                return True
        return False

    def load_checkpoint(self, target: Dict[str, Any],
                        mode: str = "latest") -> Dict[str, Any]:
        """Load into ``target`` (a state of the same structure as what was
        saved); returns ``{"state", "num_epochs", "metrics"}``."""
        if mode == "latest":
            fn = self.ckpt_latest
        elif mode == "best":
            candidates = glob.glob(self.ckpt_best_fmt.format("*", "*"))
            if not candidates:
                raise FileNotFoundError(f"no best checkpoint in {self.work_dir}")
            fn = candidates[0]
        else:
            raise NotImplementedError(mode)
        data = torch.load(fn, map_location="cpu", weights_only=True)
        saved = data["state"]
        missing = sorted(set(target) - set(saved))
        if missing:
            raise KeyError(f"{fn} holds no {missing}")
        state = {k: (_copy_into(v, saved[k], f"state/{k}") if k == "params"
                     else saved[k]) for k, v in target.items()}
        return dict(state=state, num_epochs=data["num_epochs"],
                    metrics=data["metrics"])
