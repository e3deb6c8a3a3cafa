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
``opt_state`` (serving) reads the params only.

The JAX package's checkpoints (``ckpt-latest.msgpack``,
``ckpt-best-ep{epoch}-{metric}.msgpack``: ``flax.serialization.to_bytes``
of ``{"state", "num_epochs", "metrics"}``, segmminterest_tpu/engine/
checkpoint.py:35-36,53) are read too, without flax or msgpack:
:func:`msgpack_restore` decodes them as flax 0.12.3's ``msgpack_restore``
does (flax/serialization.py:278-311 ext types, :344-389 chunked leaves),
and their ``state["params"]`` pass through ``models/convert.py``. A
``bfloat16`` leaf, which numpy has no dtype for, becomes a
``torch.bfloat16`` tensor (cast to fp32 into the port's parameters). A
target with ``opt_state`` (resuming training) also gets optax's state
(segmminterest_tpu/engine/train.py:85-88: ``chain(clip_by_global_norm,
adamw)``, which flax writes as ``{"0": {}, "1": {"0": {count, mu, nu},
"1": {}, "2": {}}}``) as ``torch.optim.AdamW``'s: ``mu`` and ``nu`` pass
through the same key rules as the params (Dense kernels transposed, bf16
widened) into ``exp_avg`` and ``exp_avg_sq``, ``count`` into ``step``.

A run resumed from ``ckpt-latest.msgpack`` writes ``.pt`` checkpoints beside
it, and each records the ``.msgpack`` it continues (``continues``: file name
and SHA-256). A directory that holds both kinds is read as the port's when
its ``ckpt-latest.pt`` continues the ``ckpt-latest.msgpack`` there, as it
was, and raises otherwise (two runs' checkpoints in one directory).
"""

from __future__ import annotations

import copy
import glob
import hashlib
import os
import os.path as osp
import struct
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.convert import flax_to_state_dict


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


# ---------------------------------------------------------------------------
# msgpack, as flax writes it

# flax/serialization.py:_MsgpackExtType
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# type byte -> (length format, kind)
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(buf: memoryview, pos: int, raw: bool):
    """(object, next position) of the msgpack object at ``pos``: maps as
    dicts, arrays as lists, str as str (bytes when ``raw``), bin as bytes,
    flax's ext types decoded."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if b <= 0x8f:
        return _unpack_map(buf, pos, b & 0x0f, raw)
    if b <= 0x9f:
        return _unpack_array(buf, pos, b & 0x0f, raw)
    if b <= 0xbf:
        return _unpack_str(buf, pos, b & 0x1f, raw)
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    if b in _SCALARS:
        fmt = _SCALARS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b not in _SIZED:
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {pos - 1}")
    fmt, kind = _SIZED[b]
    n = struct.unpack_from(fmt, buf, pos)[0]
    pos += struct.calcsize(fmt)
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "str":
        return _unpack_str(buf, pos, n, raw)
    if kind == "array":
        return _unpack_array(buf, pos, n, raw)
    if kind == "map":
        return _unpack_map(buf, pos, n, raw)
    code = struct.unpack_from(">b", buf, pos)[0]
    return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n


def _unpack_str(buf, pos, n, raw):
    data = bytes(buf[pos:pos + n])
    return (data if raw else data.decode("utf-8")), pos + n


def _unpack_array(buf, pos, n, raw):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos, raw)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n, raw):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, raw)
        if not isinstance(k, (str, bytes)):  # msgpack's strict_map_key
            raise ValueError(f"msgpack: map key of type {type(k).__name__}")
        out[k], pos = _unpack(buf, pos, raw)
    return out, pos


def unpackb(data, raw: bool = False):
    """``msgpack.unpackb(data, raw=raw, ext_hook=flax's)``."""
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0, raw)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} bytes past the object")
    return obj


def _ndarray(data):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes);
    a bf16 array as a torch tensor."""
    shape, name, buffer = unpackb(data, raw=True)
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name.decode())).reshape(shape)


def _ext(code: int, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re_, im = unpackb(data)
        return complex(re_, im)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: a chunked leaf (arrays
    past ``MAX_CHUNK_SIZE`` bytes, split flat) back into one array, in
    nested dicts."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = (torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
                else np.concatenate(chunks))
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore``: the state dict of a
    ``to_bytes`` checkpoint (nested dicts of numpy arrays, numpy scalars,
    Python numbers, str, None; bf16 leaves as torch tensors)."""
    return _unchunk(unpackb(data))


# ---------------------------------------------------------------------------

class CheckPointer:
    def __init__(self, monitor: str, work_dir: str, mode: str = "min") -> None:
        self.monitor = monitor
        self.best_metric: Optional[float] = None
        self.work_dir = work_dir
        self.mode = mode
        os.makedirs(work_dir, exist_ok=True)
        self.ckpt_latest = osp.join(work_dir, "ckpt-latest.pt")
        self.ckpt_best_fmt = osp.join(work_dir, "ckpt-best-ep{}-{}.pt")
        # the .msgpack checkpoint this run continues, recorded in its saves
        # (its SHA-256 taken at the first save: serving never hashes)
        self.continues: Optional[Dict[str, str]] = None
        self._resumed_msgpack = False

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
        if self._resumed_msgpack and self.continues is None:
            self.continues = self._msgpack_id()
        if self.continues:
            save_dict["continues"] = dict(self.continues)
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

    def _path(self, mode: str, suffix: str) -> str:
        if mode == "latest":
            return self.ckpt_latest[:-len(".pt")] + suffix
        if mode == "best":
            candidates = glob.glob(
                self.ckpt_best_fmt.format("*", "*")[:-len(".pt")] + suffix)
            if not candidates:
                raise FileNotFoundError(f"no best checkpoint in {self.work_dir}")
            return candidates[0]
        raise NotImplementedError(mode)

    def has_latest(self) -> bool:
        """A latest checkpoint of either kind is in the directory."""
        return any(osp.exists(self._path("latest", suffix))
                   for suffix in (".pt", ".msgpack"))

    def _msgpack_id(self) -> Dict[str, str]:
        fn = self._path("latest", ".msgpack")
        with open(fn, "rb") as f:
            digest = hashlib.file_digest(f, "sha256").hexdigest()
        return {"file": osp.basename(fn), "sha256": digest}

    def _kind(self) -> str:
        """The kind of checkpoint the directory is read as: ".msgpack" or
        ".pt"; both raise unless the port's continue the JAX run's."""
        pts = sorted(glob.glob(osp.join(self.work_dir, "ckpt-*.pt")))
        packs = sorted(glob.glob(osp.join(self.work_dir, "ckpt-*.msgpack")))
        if not (pts and packs):
            return ".msgpack" if packs else ".pt"
        latest = self._path("latest", ".pt")
        continues = (torch.load(latest, map_location="cpu",
                                weights_only=True).get("continues")
                     if osp.exists(latest) else None)
        if continues and osp.exists(self._path("latest", ".msgpack")) \
                and continues == self._msgpack_id():
            return ".pt"
        raise ValueError(
            f"{self.work_dir} holds both the port's checkpoints {pts} and "
            f"the JAX package's {packs}, and its ckpt-latest.pt does not "
            "continue that ckpt-latest.msgpack: keep one kind")

    def load_checkpoint(self, target: Dict[str, Any], mode: str = "latest"
                        ) -> Dict[str, Any]:
        """Load into ``target`` (a state of the same structure as what was
        saved); returns ``{"state", "num_epochs", "metrics"}``. A directory
        of the JAX package's ``.msgpack`` checkpoints fills the params and,
        where the target has one, the AdamW state; later saves record it as
        the checkpoint they continue."""
        if self._kind() == ".msgpack":
            loaded = self._load_msgpack(target, self._path(mode, ".msgpack"))
            self._resumed_msgpack = True
            return loaded
        fn = self._path(mode, ".pt")
        data = torch.load(fn, map_location="cpu", weights_only=True)
        saved = data["state"]
        missing = sorted(set(target) - set(saved))
        if missing:
            raise KeyError(f"{fn} holds no {missing}")
        state = {k: (_copy_into(v, saved[k], f"state/{k}") if k == "params"
                     else saved[k]) for k, v in target.items()}
        self.continues = data.get("continues", self.continues)
        return dict(state=state, num_epochs=data["num_epochs"],
                    metrics=data["metrics"])

    def _load_msgpack(self, target: Dict[str, Any], fn: str
                      ) -> Dict[str, Any]:
        extra = sorted(set(target) - {"params", "opt_state"})
        if extra:
            raise KeyError(f"{fn} is a JAX checkpoint: it holds params and "
                           f"optax's state, not {extra}")
        with open(fn, "rb") as f:
            data = msgpack_restore(f.read())
        params = flax_to_state_dict(data["state"]["params"],
                                    target["params"])
        state = {"params": _copy_into(target["params"], params,
                                      "state/params")}
        if "opt_state" in target:
            state["opt_state"] = adamw_state_from_optax(
                data["state"].get("opt_state"), target["params"],
                target["opt_state"], fn)
        return dict(state=state, num_epochs=data["num_epochs"],
                    metrics=data["metrics"])


def adamw_state_from_optax(opt_state, params: Mapping[str, torch.Tensor],
                           template: Mapping[str, Any], what: str = "opt_state"
                           ) -> Dict[str, Any]:
    """``torch.optim.AdamW.state_dict()`` holding the state of the JAX
    engine's ``optax.chain(clip_by_global_norm, adamw)``. ``params`` are the
    optimizer's parameters by name, in the order it holds them; ``template``
    is its current ``state_dict()`` (its one parameter group is kept)."""
    try:
        adam = opt_state["1"]["0"]
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
    except (KeyError, TypeError):
        raise ValueError(
            f"{what}: not the state of optax.chain(clip_by_global_norm, "
            "adamw) (expected {'0': {}, '1': {'0': {count, mu, nu}, ...}})")
    groups = template["param_groups"]
    if len(groups) != 1 or list(groups[0]["params"]) != list(
            range(len(params))):
        raise ValueError(f"{what}: the optimizer must hold the {len(params)} "
                         "parameters in one group, in order")
    step = int(np.asarray(count))
    state = {}
    if step:
        exp_avg = flax_to_state_dict(mu, params)
        exp_avg_sq = flax_to_state_dict(nu, params)
        # a 0-d tensor of the default dtype, as AdamW makes its step
        state = {i: {"step": torch.tensor(float(step)),
                     "exp_avg": exp_avg[n], "exp_avg_sq": exp_avg_sq[n]}
                 for i, n in enumerate(params)}
    return {"state": state, "param_groups": copy.deepcopy(groups)}
