"""The interest-task engine, serving subset (port of
``segmminterest_tpu/engine/train.py`` InterestEngine: model construction
:65-84, the device-resident feature table :99-171, ``_model_inputs``
:178-216 and the eval step :238-245).

* The feature table lives on the device, optionally as int8 rows + a
  float32 per-row scale; a pre-quantized (int8, scale) pair already on the
  device is used as it is, without a copy.
* Batches carry int32 indices; the gather, dequantization, masking and L1
  normalization run on the device.
* Batches travel host -> device from pinned memory with non-blocking
  copies; ``batch_transform`` starts them in the iterator's prefetch thread.

The optimizer, the train step, the training loop, mesh sharding and the
loss dict of the eval step come with the training slice; until then
``eval_step`` returns ``(None, logits, interests)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.numerics import dequantize_rows, l1_normalize, quantize_table_int8
from ..models.interest import SegInterestModel
from ..utils.config import InterestConfig
from ..utils.device import resolve_device

DEVICE_KEYS = ("label", "user_identity_id", "photo_identity_id", "vid_mask",
               "user_mask", "row_mask", "photo_lines", "user_lines",
               "play_time", "duration")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in batch.items() if k in DEVICE_KEYS}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class InterestEngine:
    """Owns the model (in the compute dtype, on ``device``) and the device
    feature table. ``device=None`` means the card."""

    def __init__(self, config: InterestConfig, n_users: int, n_items: int,
                 feature_table=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.feature_mode = feature_table is not None
        self.dtype = _DTYPES[config.compute_dtype]
        for flag in ("fuse_projections", "fuse_dual", "fuse_layer"):
            if getattr(config, flag):
                raise NotImplementedError(f"{flag} is not ported yet")
        if not self.feature_mode and (config.user_input_type != "id"
                                      or config.photo_input_type != "id"):
            raise ValueError(
                f"--user_input_type={config.user_input_type} / "
                f"--photo_input_type={config.photo_input_type} need a "
                "feature table (--memmap and --lineid_map); use id/id "
                "without one")

        self._table_quant = (config.table_quant == "int8"
                             and self.feature_mode)
        self.feat_table: Optional[torch.Tensor] = None
        self.feat_scale: Optional[torch.Tensor] = None
        feat_dim = 1024
        if self.feature_mode:
            if self._table_quant:
                if isinstance(feature_table, tuple):
                    table, scale = (_as_tensor(t) for t in feature_table)
                    if table.dtype != torch.int8 or \
                            scale.dtype != torch.float32:
                        raise ValueError(
                            "pre-quantized feature_table must be (int8 rows, "
                            f"float32 scales); got ({table.dtype}, "
                            f"{scale.dtype})")
                else:
                    table, scale = (torch.from_numpy(a) for a in
                                    quantize_table_int8(feature_table))
                self.feat_scale = scale.to(self.device)
            else:
                table = _as_tensor(np.asarray(feature_table))
                if self.dtype == torch.bfloat16:
                    table = table.to(torch.bfloat16)
            # .to() returns the same tensor when it already lives there
            self.feat_table = table.to(self.device)
            feat_dim = table.shape[1]

        self._dims = (n_users, n_items, feat_dim)
        self.model = self._new_model(config.seed).to(device=self.device,
                                                     dtype=self.dtype)
        self.model.eval()
        self.exposure_prob = torch.tensor(
            config.exposure_prob or [1.0] * 40, dtype=torch.float32,
            device=self.device)
        self._params = None

    def _new_model(self, seed: int) -> SegInterestModel:
        """The model in fp32 on the host, initialised from ``seed`` (so the
        weights do not depend on the device or the compute dtype)."""
        cfg = self.config
        n_users, n_items, feat_dim = self._dims
        model = SegInterestModel(
            d_model=cfg.d_model, num_heads=cfg.nhead,
            num_layers=cfg.num_layers_enc, ff_dim=cfg.d_model,
            n_users=n_users, n_items=n_items, dropout=cfg.dropout,
            user_input=cfg.user_input_type,
            photo_input=cfg.photo_input_type,
            fusion_heads=cfg.fusion_heads,
            learnable_bias=cfg.learnable_bias, use_pe=cfg.use_pe,
            ablation=cfg.ablation_type, feat_dim=feat_dim,
            fused_attention=cfg.fused_attention, fuse_qkv=cfg.fuse_qkv)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model

    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """Re-initialise the model from ``seed`` (when given) and return the
        state ``{"params": model.state_dict()}``, whose tensors are the
        model's own."""
        if seed is not None:
            self.model.load_state_dict(self._new_model(seed).state_dict())
        self._params = self.model.state_dict()
        return {"params": self._params}

    # ------------------------------------------------------------------
    def _model_inputs(self, batch: Dict[str, torch.Tensor]):
        """Device batch -> (usr_image, usr_id, usr_mask, vid_image, vid_id,
        vid_mask); in feature mode the gathers + L1 normalization
        (main_…SegMM.py:272-273) run on the device here."""
        usr_id = batch["user_identity_id"]
        vid_id = batch["photo_identity_id"]
        vid_mask = batch["vid_mask"]
        usr_mask = batch["user_mask"]
        if self.feature_mode:
            def gather(ids):
                ids = ids.clamp(min=0).long()
                if self._table_quant:
                    return dequantize_rows(self.feat_table[ids],
                                           self.feat_scale[ids], self.dtype)
                return self.feat_table[ids]

            photo = gather(batch["photo_lines"])
            photo = photo * vid_mask[..., None].to(photo.dtype)
            user = gather(batch["user_lines"])
            user = user * usr_mask[..., None].to(user.dtype)
            usr_image, vid_image = l1_normalize(user), l1_normalize(photo)
        else:
            usr_image, vid_image = usr_id, vid_id
            usr_mask = torch.ones((usr_id.shape[0], 1), dtype=torch.bool,
                                  device=usr_id.device)
        return usr_image, usr_id, usr_mask, vid_image, vid_id, vid_mask

    def _put(self, v) -> torch.Tensor:
        t = _as_tensor(v)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def batch_transform(self, batch: Dict[str, np.ndarray]):
        """Start the host -> device copy of the device keys and attach the
        device views under '_dev', keeping every host field numpy. Passed as
        BatchIterator(transform=...) so the copy starts in the prefetch
        thread and overlaps device compute."""
        out = dict(batch)
        out["_dev"] = {k: self._put(v)
                       for k, v in device_batch(batch).items()}
        return out

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        if "_dev" in batch:
            return batch["_dev"]
        return {k: self._put(v) for k, v in device_batch(batch).items()}

    def eval_step(self, state: Dict[str, Any], batch):
        """Forward of one batch: ``(None, logits (B, 40) fp32, interests)``
        with ``interests = sigmoid(logits) * exposure_prob``. ``state`` is
        the one ``init_state`` returned (or a checkpoint loaded into it);
        another state's params are loaded into the model first."""
        if state["params"] is not self._params:
            self.model.load_state_dict(state["params"])
            self._params = state["params"]
        with torch.inference_mode():
            logits = self.model(*self._model_inputs(self.put_batch(batch)))
            logits = logits.float()
            interests = torch.sigmoid(logits) * self.exposure_prob[None, :]
        return None, logits, interests

