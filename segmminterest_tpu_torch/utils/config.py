"""Configuration for the segment-interest task (the port's own copy of
``segmminterest_tpu/utils/config.py``; field names and defaults identical so
checkpoints and CLI invocations translate 1:1).

One dataclass tree replaces the reference's argparse sprawl
(reference MMinterest/main_for_seq_leave_earlystop_SegMM.py:474-576).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class InterestConfig:
    # data
    path: str = "SegMM/"
    sep: str = "\t"
    history_max: int = 50
    sample_csv: Optional[str] = None  # single-csv mode (sample data)

    # batching
    train_batch_size: int = 1024
    valid_batch_size: int = 1024
    test_batch_size: int = 1024

    # model (main_…SegMM.py:488-527)
    d_model: int = 512
    nhead: int = 16
    num_layers_enc: int = 6
    dropout: float = 0.1
    user_input_type: str = "both"   # id | image | both
    photo_input_type: str = "both"
    fusion_heads: int = 2
    learnable_bias: bool = False
    use_pe: bool = True
    ablation_type: str = "ours"

    # optimization
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip_norm: float = 10.0
    epochs: int = 30
    seed: int = 42

    # losses
    loss_type: str = "interestBPR"
    loss_weight: Dict[str, float] = field(default_factory=lambda: {
        "focal": 1.0, "mse": 1.0, "hazard": 1.0, "surviveCE": 1.0,
        "interestBPR": 1.0, "interestCE": 1.0, "interestKL": 1.0})
    mask_loss: bool = False
    exposure_prob_type: str = "ones"  # ones | statistics
    exposure_prob: Optional[List[float]] = None

    # eval / early stop
    valid_step: int = 30
    logging_step: int = 10
    early_stop: int = 20
    main_metrics: str = "HR@5"
    eval_type_list: str = "JaccardSim,LeaveMSE,LeaveCTR,LeaveCTR_view,TOP_K"
    top_k_permutation: bool = True
    top_k_mask: bool = False
    threshold: float = 0.5
    eval_cold: str = ""  # "" | "test"
    test_model: bool = True
    save_logits: bool = False
    # watch-time task: add duration/TOP1MSE/MAES/pred_leave accumulators and
    # report (MSE, MAE) aggregates (main_for_WatchTime_Ours_SegMM.py:181-226)
    watchtime_metrics: bool = False

    # engine
    ckpt_dir: str = "ckpts_SegMM"
    load: bool = False               # resume from ckpt-latest before training
    profile: bool = False            # profiler trace of a few train steps
    record_train_detail: bool = False
    count_view_completion: bool = False
    plot_curves: bool = False        # save train/valid loss curves (png)
    draw_case: int = 0               # N case-study heatmaps from test batch 0
    debug: bool = False
    compute_dtype: str = "float32"   # float32 | bfloat16
    remat: bool = True               # rematerialize encoder layers on backward
    # what to rematerialize: 'layer' recomputes the whole encoder layer on
    # backward (max memory saving, ~+33% step time); 'attention' recomputes
    # only the projections+attention block, keeping FFN activations live
    # (most of the memory win at a fraction of the recompute)
    remat_scope: str = "layer"       # layer | attention
    fused_attention: bool = True     # two-block attention kernel (K1)
    # horizontally fuse the 12 per-stream QKV projections into 2 wide matmuls
    # per attention (K1 route, 'ours' path only; ignored elsewhere)
    fuse_projections: bool = False
    # run the QKV projections inside the attention kernel (K2: q/k/v never
    # touch device memory); parameter tree unchanged
    fuse_qkv: bool = False
    # merge both per-layer stream calls into one kernel launch; not ported
    # yet (the port raises on it); parameter tree unchanged
    fuse_dual: bool = False
    # run each whole encoder-layer stream (attention + out-proj + LN
    # residual + GELU MLP + LN residual) in one kernel; not ported yet (the
    # port raises on it).
    fuse_layer: bool = False
    # feature-table storage: 'none' keeps the table in compute_dtype
    # (bf16 ≈ 8 GB at 3.9M rows); 'int8' stores per-row symmetric int8 + a
    # float32 scale (≈4 GB), dequantized on gather — the L1 normalization
    # cancels the scale, so the model sees rounding error only (PARITY D8).
    table_quant: str = "none"       # none | int8
    # kept so configs written for the JAX package keep parsing; unused by
    # the port's serving path
    rng_impl: str = "rbg"
    n_devices: Optional[int] = None
    # DEPRECATED, ignored: candidate pools are stored as per-user
    # played-segment streams + per-row slice bounds, which gives the
    # reference's exact direct-draw pool semantics in O(total played
    # segments) memory — no cap needed (PARITY D7 closed). Kept so existing
    # configs/CLI invocations keep parsing.
    pool_cap: Optional[int] = None

    @property
    def loss_type_list(self) -> List[str]:
        return [s.strip() for s in self.loss_type.split(",") if s.strip()]

    @property
    def eval_types(self) -> List[str]:
        return [s.strip() for s in self.eval_type_list.split(",") if s.strip()]

    def param_dir(self) -> str:
        """Run-identifying directory name (reference :216)."""
        return (f"{self.num_layers_enc}_{self.exposure_prob_type}_"
                f"{self.learning_rate}_{self.weight_decay}_"
                f"{int(self.learnable_bias)}_{self.loss_type}_"
                f"{self.loss_weight.get('interestBPR', 1.0)}_"
                f"{self.user_input_type}_{self.photo_input_type}_"
                f"{int(self.mask_loss)}_{int(self.use_pe)}_"
                f"{self.fusion_heads}_earlystop_focal")

    def replace(self, **kw) -> "InterestConfig":
        return dataclasses.replace(self, **kw)

    def with_param_dir(self, dirname: str) -> "InterestConfig":
        """Invert :meth:`param_dir`: re-parse the hyperparameters encoded in
        a checkpoint directory name, as the reference inference scripts do
        (save_logits_for_all_leave_SegMM.py:249-259). Positional: none of
        the encoded fields contain underscores."""
        toks = dirname.rstrip("/").split("/")[-1].split("_")
        if len(toks) != 14 or toks[-2:] != ["earlystop", "focal"]:
            raise ValueError(
                f"{dirname!r} is not a param_dir-formatted name "
                "(want 14 '_'-separated fields ending 'earlystop_focal')")
        cfg = self.replace(
            num_layers_enc=int(toks[0]), exposure_prob_type=toks[1],
            learning_rate=float(toks[2]), weight_decay=float(toks[3]),
            learnable_bias=bool(int(toks[4])), loss_type=toks[5],
            user_input_type=toks[7], photo_input_type=toks[8],
            mask_loss=bool(int(toks[9])), use_pe=bool(int(toks[10])),
            fusion_heads=int(toks[11]))
        cfg.loss_weight["interestBPR"] = float(toks[6])
        return cfg
