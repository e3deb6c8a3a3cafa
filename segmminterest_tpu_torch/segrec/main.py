"""SegRec's command line (port of ``segmminterest_tpu/segrec/main.py``).

Behavioral spec: reference SegRec/main.py (:44-99,192-236): resolve
model + mode, build corpus, train, report dev/test metrics, save CTR rows
with WUAUC.

  python -m segmminterest_tpu_torch.segrec.main --model_name ClipWDRec \
      --model_mode CTR --path data --dataset SegMM_CTR \
      --clip_weight_path saved_logits/interest_logits.json \
      [--clip_feature_memmap feat.dat --lineid_map lineid.json] \
      [--device cpu]

The parser is the JAX CLI's, every flag, plus ``--device`` (the card
unless ``cpu`` is asked for; without a card and without ``--device cpu`` it
raises). Every route of the JAX CLI runs:
 * the CTR and Ranking (TopK) modes over every general, sequential and
   context model of the JAX registry (``models.MODEL_REGISTRY``), with
   their loss routes, DIEN's auxiliary loss (``--alpha_aux``), full-sort
   evaluation (``--test_all 1``) and the two-stage protocols (S3Rec
   ``--s3rec_stage 1`` then ``2 --load 1``, TiMiRec ``--timirec_stage
   pretrain`` then ``finetune --load 1``, through ``--model_path``);
 * ``--leave_rank 1``: the leave-frame ranking evaluation
   (``runner.LeaveRankingRunner``) over the frame-as-item datasets of
   ``tasks/build_leave_rank_data.py``;
 * the KG family (CFKG, SLRCPlus, Chorus, KDA; ``kg.py``) over a dataset
   with r_* relations in its item_meta.csv, with CFKG's and Chorus's
   stage-1 margin loss, Chorus's stage 1 (``--stage 1 --model_path``) then
   stage 2 (``--load 1``) on its own runner, KDA's DistMult term;
 * ``--model_mode Impression`` (``run_impression``): the BPRMF and SASRec
   impression rankers and the rerankers PRM, SetRank and MIR over a
   pretrained ranker (``--ranker_model_path``: the port's ``.pt`` or the
   JAX runner's ``.msgpack``), trained on an impression loss
   (``--loss_n``, BPRsession by default).
A batch sharded over more than one card (``--use_mesh`` with several
cards) is ROADMAP Queue A item 6 and raises.
``save_final_results`` and ``all_inference`` write their TSVs with
``data/reader.py``'s ``write_csv`` (pandas' ``to_csv`` byte for byte). On
the card the run logs its peak device memory.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp

import numpy as np
import torch

from ..data.feature_store import FeatureStore
from ..data.reader import frame_len, write_csv
from ..utils.device import resolve_device
from .corpus import Corpus
from .feeds import QUEUE_MULTI_GPU, ClipWeights, FeedBuilder
from .kg import KGFeedBuilder, KGMeta, kda_freq_init, make_chorus_runner
from .layers import init_weights
from .models import model_class
from .rerank import (IMPRESSION_RANKERS, RERANKERS, ImpressionFeedBuilder,
                     ImpressionRunner)
from .runner import (CTRRunner, LeaveRankingRunner, RankingRunner,
                     RunnerConfig)

logger = logging.getLogger(__name__)

SEQ_MODELS = {"DIN", "DIEN", "CAN", "SDIM", "ETA", "ClipDINRec", "ClipDIENRec",
              "ClipCANRec", "SASRec", "GRU4Rec", "Caser", "NARM", "FPMC",
              "TiSASRec", "ComiRec", "ContraRec", "TiMiRec",
              "SRGNN", "CLRec", "FourierTA", "S3Rec",
              "SLRCPlus", "Chorus", "KDA"}
KG_MODELS = {"CFKG", "SLRCPlus", "Chorus", "KDA"}


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", type=str, default="ClipWDRec")
    p.add_argument("--model_mode", type=str, default="CTR",
                   choices=["CTR", "Ranking", "TopK", "Impression"])
    p.add_argument("--path", type=str, default="data")
    p.add_argument("--dataset", type=str, default="SegMM_CTR")
    p.add_argument("--sep", type=str, default="\t")
    p.add_argument("--random_seed", type=int, default=0)
    # runner
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--early_stop", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--l2", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--eval_batch_size", type=int, default=512)
    p.add_argument("--optimizer", type=str, default="Adam")
    p.add_argument("--topk", type=str, default="5,10,20,50")
    p.add_argument("--metric", type=str, default="")
    p.add_argument("--main_metric", type=str, default="")
    p.add_argument("--loss_n", type=str, default="")
    p.add_argument("--num_neg", type=int, default=1)
    p.add_argument("--test_all", type=int, default=0,
                   help="full-sort ranking eval over all items with clicked "
                        "items masked -inf (BaseModel.py:200,231-235)")
    p.add_argument("--history_max", type=int, default=20)
    p.add_argument("--time_max", type=int, default=512,
                   help="TiSASRec max time-interval buckets")
    p.add_argument("--buir_momentum", type=float, default=0.995)
    p.add_argument("--model_path", type=str, default="",
                   help="save the best state here after training (.pt; "
                        "for a .msgpack path, beside it as .pt) "
                        "and/or load from here (--load 1), like ReChorus "
                        "BaseModel.save_model/load_model; a .msgpack of the "
                        "JAX runner's params loads too")
    p.add_argument("--load", type=int, default=0,
                   help="initialize from --model_path before training "
                        "(missing file -> train from scratch)")
    p.add_argument("--train", type=int, default=1,
                   help="0: skip training and evaluate the loaded model "
                        "(ReChorus main.py --train 0)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (raises "
                        "without one — pass 'cpu' to run on the CPU)")
    p.add_argument("--narm_hidden_size", type=int, default=100)
    p.add_argument("--narm_attention_size", type=int, default=50)
    p.add_argument("--train_max_pos_item", type=int, default=20)
    p.add_argument("--train_max_neg_item", type=int, default=20)
    p.add_argument("--n_blocks", type=int, default=4)
    p.add_argument("--num_hidden_unit", type=int, default=64)
    p.add_argument("--setrank_type", type=str, default="IMSAB")
    p.add_argument("--ranker_name", type=str, default="BPRMF",
                   help="Impression mode: base ranker for rerankers")
    p.add_argument("--ranker_emb_size", type=int, default=64)
    p.add_argument("--ranker_model_path", type=str, default="",
                   help="pretrained base-ranker msgpack (rerankers)")
    p.add_argument("--tuneranker", type=int, default=0)
    p.add_argument("--include_attr", type=int, default=0)
    p.add_argument("--margin", type=float, default=0.0)
    p.add_argument("--time_scalar", type=int, default=60 * 60 * 24 * 100)
    p.add_argument("--stage", type=int, default=2,
                   help="Chorus: 1 KG pretrain, 2 recommendation")
    p.add_argument("--base_method", type=str, default="BPR")
    p.add_argument("--lr_scale", type=float, default=0.1)
    p.add_argument("--category_col", type=str, default="i_category")
    p.add_argument("--n_dft", type=int, default=64)
    p.add_argument("--freq_rand", type=int, default=0)
    p.add_argument("--neg_head_p", type=float, default=0.5)
    p.add_argument("--gamma", type=float, default=-1)
    p.add_argument("--pooling", type=str, default="average")
    p.add_argument("--include_val", type=int, default=1)
    p.add_argument("--s3rec_stage", type=int, default=2,
                   help="1: self-supervised pretrain (save via --model_path);"
                        " 2: finetune (load pretrain via --load 1)")
    p.add_argument("--mip_weight", type=float, default=0.2)
    p.add_argument("--sp_weight", type=float, default=0.5)
    p.add_argument("--mask_ratio", type=float, default=0.2)
    p.add_argument("--t_scalar", type=int, default=60,
                   help="FourierTA time-interval scalar")
    p.add_argument("--timirec_stage", type=str, default="finetune",
                   choices=["pretrain", "finetune"])
    p.add_argument("--timirec_temp", type=float, default=1.0)
    p.add_argument("--timirec_n_layers", type=int, default=1)
    p.add_argument("--contrarec_encoder", type=str, default="BERT4Rec")
    p.add_argument("--contrarec_gamma", type=float, default=1.0)
    p.add_argument("--ctc_temp", type=float, default=1.0)
    p.add_argument("--ccc_temp", type=float, default=0.2)
    p.add_argument("--beta_a", type=int, default=3)
    p.add_argument("--beta_b", type=int, default=3)
    p.add_argument("--comirec_attn_size", type=int, default=8)
    p.add_argument("--comirec_k", type=int, default=2)
    p.add_argument("--comirec_add_pos", type=int, default=1)
    p.add_argument("--sam_interaction_type", type=str, default="SAM2E")
    p.add_argument("--sam_aggregation", type=str, default="concat")
    p.add_argument("--sam_num_layers", type=int, default=1)
    p.add_argument("--sam_use_residual", type=int, default=0)
    p.add_argument("--cin_layers", type=str, default="[8,8]",
                   help="xDeepFM CIN layer sizes")
    p.add_argument("--cin_direct", type=int, default=0,
                   help="xDeepFM CIN direct connections")
    p.add_argument("--dropout", type=float, default=0.0)
    # model
    p.add_argument("--emb_size", type=int, default=64)
    p.add_argument("--layers", type=str, default="[64]")
    p.add_argument("--att_layers", type=str, default="[64]")
    p.add_argument("--dnn_layers", type=str, default="[64]")
    p.add_argument("--adjust_interest_weight", type=int, default=0)
    p.add_argument("--duration_mask", type=int, default=0)
    p.add_argument("--norm_interest_type", type=str, default="none")
    # DCNv2 family (DCNv2.py / ClipDCNv2Rec.py argparse)
    p.add_argument("--cross_layer_num", type=int, default=6)
    p.add_argument("--mixed", type=int, default=1)
    p.add_argument("--structure", type=str, default="parallel",
                   choices=["parallel", "stacked"])
    p.add_argument("--low_rank", type=int, default=64)
    p.add_argument("--expert_num", type=int, default=2)
    p.add_argument("--reg_weight", type=float, default=2.0)
    # AutoInt (AutoInt.py argparse)
    p.add_argument("--num_heads", type=int, default=1)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--attention_size", type=int, default=32)
    # DIEN / CAN (DIEN.py / CAN.py argparse)
    p.add_argument("--alpha_aux", type=float, default=0.0)
    p.add_argument("--aux_hidden_layers", type=str, default="[64]")
    p.add_argument("--evolving_gru_type", type=str, default="AGRU")
    p.add_argument("--add_historical_situations", type=int, default=0,
                   help="append situation embeddings to history steps and "
                        "candidates (DIN.py:132-141)")
    p.add_argument("--co_action_layers", type=str, default="[4,4]")
    p.add_argument("--induce_vec_size", type=int, default=512)
    p.add_argument("--orders", type=int, default=1)
    # FinalMLP feature selection (FinalMLP.py argparse)
    p.add_argument("--use_fs", type=int, default=1)
    p.add_argument("--fs_hidden_units", type=str, default="[64]")
    p.add_argument("--fs1_context", type=str, default="")
    p.add_argument("--fs2_context", type=str, default="")
    # AdaGIN (AdaGIN.py argparse)
    p.add_argument("--warm_dim", type=int, default=64)
    p.add_argument("--cold_dim", type=int, default=64)
    p.add_argument("--warm_tau", type=float, default=1.0)
    p.add_argument("--cold_tau", type=float, default=0.01)
    p.add_argument("--num_gnn_layers", type=int, default=3)
    p.add_argument("--only_use_last_layer", type=int, default=1)
    p.add_argument("--fi_hidden_units", type=str, default="[64,64]")
    p.add_argument("--w_hidden_units", type=str, default="[64,64]")
    p.add_argument("--contrastive", type=str, default="",
                   choices=["", "ContrastiveLoss", "infoNCELoss"],
                   help="ClipRec feats-vs-id alignment aux loss")
    p.add_argument("--auxillary_loss_weight", type=float, default=0.0)
    # segment integration inputs
    p.add_argument("--clip_weight_path", type=str, default="")
    p.add_argument("--eval_neg_weight_path", type=str, default="")
    p.add_argument("--clip_feature_memmap", type=str, default="")
    p.add_argument("--lineid_map", type=str, default="")
    p.add_argument("--save_final_results", type=int, default=0)
    p.add_argument("--result_dir", type=str, default="results")
    # SkipPredBaseline fork features (ReChorus/src/main.py:39,105-141 and
    # helpers/BaseRunner.py:52-114)
    p.add_argument("--use_mesh", type=int, default=1,
                   help="shard batches over every visible card when there "
                        "is more than one and the batch sizes divide their "
                        "count (not ported yet: raises then)")
    p.add_argument("--leave_rank", type=int, default=0,
                   help="evaluate with the leave-frame ranking variant")
    p.add_argument("--all_inference", type=int, default=0,
                   help="after training, dump per-candidate prediction "
                        "scores over train/dev/test for the logits converter")
    return p


def build_model(args, corpus: Corpus, use_frames: bool,
                kg_meta=None) -> torch.nn.Module:
    """The model of ``--model_name`` with the JAX CLI's arguments (its
    ``build_model``, segrec/main.py:202-452, branch for branch; a KG model
    from ``kg_meta``), initialised on the host from ``--random_seed`` (the
    same weights on every device)."""
    name = args.model_name
    cls = model_class(name)
    model = (_kg_model(args, corpus, cls, kg_meta) if kg_meta is not None
             else _general_or_sequential(args, corpus, cls))
    if model is not None:
        return init_weights(model, torch.Generator().manual_seed(
            args.random_seed))
    feature_names = (corpus.user_feature_names + corpus.item_feature_names
                     + corpus.situation_feature_names
                     + ["user_id", "item_id"])
    layers = json.loads(args.layers)
    dnn_layers = json.loads(args.dnn_layers)
    att_layers = json.loads(args.att_layers)
    ctx = dict(emb_size=args.emb_size, dropout=args.dropout)
    seq_kwargs = dict(
        user_features=["user_id"] + corpus.user_feature_names,
        item_features=["item_id"] + corpus.item_feature_names,
        situation_features=corpus.situation_feature_names,
        feature_max=corpus.feature_max, **ctx)
    clip_kwargs = dict(
        feature_max=corpus.feature_max, dropout=args.dropout,
        adjust_interest_weight=bool(args.adjust_interest_weight),
        duration_mask=bool(args.duration_mask), use_frames=use_frames)
    co_action = tuple(json.loads(args.co_action_layers))
    dcnv2 = dict(cross_layer_num=args.cross_layer_num, mixed=bool(args.mixed),
                 structure=args.structure, low_rank=args.low_rank,
                 expert_num=args.expert_num, reg_weight=args.reg_weight)
    if name == "FM":
        model = cls(feature_names, corpus.feature_max, **ctx)
    elif name in ("DeepFM", "WideDeep"):
        model = cls(feature_names, corpus.feature_max, layers=layers, **ctx)
    elif name == "AFM":
        model = cls(feature_names, corpus.feature_max,
                    attention_size=args.attention_size,
                    reg_weight=args.reg_weight, **ctx)
    elif name == "SAM":
        model = cls(feature_names, corpus.feature_max,
                    interaction_type=args.sam_interaction_type,
                    aggregation=args.sam_aggregation,
                    num_layers=args.sam_num_layers,
                    use_residual=bool(args.sam_use_residual), **ctx)
    elif name == "xDeepFM":
        model = cls(feature_names, corpus.feature_max, layers=layers,
                    cin_layers=json.loads(args.cin_layers),
                    direct=bool(args.cin_direct),
                    reg_weight=args.reg_weight, **ctx)
    elif name == "DCN":
        model = cls(feature_names, corpus.feature_max, layers=layers,
                    cross_layer_num=args.cross_layer_num, **ctx)
    elif name == "DCNv2":
        model = cls(feature_names, corpus.feature_max, layers=layers,
                    **dcnv2, **ctx)
    elif name == "AutoInt":
        model = cls(feature_names, corpus.feature_max, layers=layers,
                    attention_size=args.attention_size,
                    num_heads=args.num_heads, num_layers=args.num_layers,
                    **ctx)
    elif name == "FinalMLP":
        def fs_ctx(v):
            return tuple(t for t in v.split(",") if t)
        model = cls(feature_names, corpus.feature_max,
                    mlp1_hidden_units=layers, mlp2_hidden_units=layers,
                    use_fs=bool(args.use_fs),
                    fs_hidden_units=tuple(json.loads(args.fs_hidden_units)),
                    fs1_context=fs_ctx(args.fs1_context),
                    fs2_context=fs_ctx(args.fs2_context),
                    num_heads=args.num_heads, **ctx)
    elif name == "AdaGIN":
        model = cls(feature_names, corpus.feature_max,
                    warm_dim=args.warm_dim, cold_dim=args.cold_dim,
                    warm_tau=args.warm_tau, cold_tau=args.cold_tau,
                    num_gnn_layers=args.num_gnn_layers,
                    only_use_last_layer=bool(args.only_use_last_layer),
                    fi_hidden_units=tuple(json.loads(args.fi_hidden_units)),
                    w_hidden_units=tuple(json.loads(args.w_hidden_units)),
                    **ctx)
    elif name == "DIN":
        model = cls(att_layers=att_layers, dnn_layers=dnn_layers,
                    add_historical_situations=bool(
                        args.add_historical_situations), **seq_kwargs)
    elif name == "DIEN":
        model = cls(fcn_hidden_layers=layers, alpha_aux=args.alpha_aux,
                    add_historical_situations=bool(
                        args.add_historical_situations),
                    aux_hidden_layers=tuple(json.loads(
                        args.aux_hidden_layers)),
                    evolving_gru_type=args.evolving_gru_type, **seq_kwargs)
    elif name == "CAN":
        # the JAX CLI passes CAN neither --alpha_aux nor
        # --evolving_gru_type: its defaults hold
        model = cls(fcn_hidden_layers=layers, orders=args.orders,
                    induce_vec_size=args.induce_vec_size,
                    co_action_layers=co_action, **seq_kwargs)
    elif name == "SDIM":
        model = cls(dnn_layers=dnn_layers, **seq_kwargs)
    elif name == "ETA":
        model = cls(dnn_layers=dnn_layers, history_max=args.history_max,
                    **seq_kwargs)
    elif name in ("ClipRec", "ClipWDRec"):
        model = cls(emb_dim=args.emb_size, dnn_layers=dnn_layers,
                    contrastive=args.contrastive, **clip_kwargs)
    elif name == "ClipDINRec":
        model = cls(has_duration="i_duration" in corpus.item_feature_names,
                    emb_size=args.emb_size, att_layers=att_layers,
                    dnn_layers=dnn_layers,
                    norm_interest_type=args.norm_interest_type, **clip_kwargs)
    elif name == "ClipDCNv2Rec":
        model = cls(emb_size=args.emb_size, layers=layers, **dcnv2,
                    **clip_kwargs)
    elif name == "ClipAutoIntRec":
        model = cls(emb_size=args.emb_size, layers=layers, **clip_kwargs)
    elif name == "ClipFinalMLPRec":
        model = cls(emb_size=args.emb_size, mlp1_hidden_units=layers,
                    mlp2_hidden_units=layers, **clip_kwargs)
    elif name == "ClipAdaGINRec":
        model = cls(emb_size=args.emb_size, **clip_kwargs)
    elif name == "ClipDIENRec":
        model = cls(emb_size=args.emb_size, fcn_hidden_layers=layers,
                    evolving_gru_type=args.evolving_gru_type,
                    norm_interest_type=args.norm_interest_type, **clip_kwargs)
    else:  # ClipCANRec
        model = cls(emb_size=args.emb_size, fcn_hidden_layers=layers,
                    evolving_gru_type=args.evolving_gru_type,
                    orders=args.orders, induce_vec_size=args.induce_vec_size,
                    co_action_layers=co_action,
                    norm_interest_type=args.norm_interest_type, **clip_kwargs)
    return init_weights(model, torch.Generator().manual_seed(
        args.random_seed))


def _kg_model(args, corpus: Corpus, cls, kg_meta: KGMeta):
    """The KG branches of the JAX CLI's build_model (segrec/main.py:
    204-248): KDA's initial frequencies from the interactions (unless
    ``--freq_rand 1``), its ``--gamma`` below 0 the KG rows per
    interaction."""
    name = args.model_name
    if name == "CFKG":
        return cls(user_num=corpus.n_users, entity_num=kg_meta.n_entities,
                   relation_num=kg_meta.n_relations, emb_size=args.emb_size,
                   margin=args.margin)
    if name == "SLRCPlus":
        return cls(user_num=corpus.n_users, item_num=corpus.n_items,
                   relation_num=len(kg_meta.item_relations) + 1,
                   emb_size=args.emb_size)
    if name == "Chorus":
        meta = kg_meta.item_meta_df
        cate = args.category_col
        return cls(user_num=corpus.n_users, item_num=corpus.n_items,
                   relation_names=tuple(kg_meta.item_relations),
                   category_num=(int(np.max(meta[cate])) + 1
                                 if cate in meta else 1),
                   emb_size=args.emb_size, margin=args.margin,
                   stage=args.stage, base_method=args.base_method)
    freq_real = freq_imag = None
    n_dft = args.n_dft
    if not args.freq_rand:
        freq_x, n_dft = kda_freq_init(corpus, kg_meta, n_dft=args.n_dft,
                                      t_scalar=args.t_scalar)
        freq_real, freq_imag = np.real(freq_x), np.imag(freq_x)
    gamma = args.gamma
    if gamma < 0:
        gamma = len(kg_meta.relation_df["head"]) / frame_len(corpus.all_df)
    return cls(user_num=corpus.n_users, item_num=corpus.n_items,
               entity_num=max(kg_meta.n_entities, corpus.n_items),
               relation_num=kg_meta.n_relations, freq_dim=n_dft // 2 + 1,
               freq_real_init=freq_real, freq_imag_init=freq_imag,
               emb_size=args.emb_size, num_layers=args.num_layers,
               num_heads=args.num_heads, attention_size=args.attention_size,
               pooling=args.pooling, include_val=bool(args.include_val),
               gamma=gamma, dropout=args.dropout)


def _general_or_sequential(args, corpus: Corpus, cls):
    """The general and sequential models' branches of the JAX CLI's
    build_model (segrec/main.py:266-341), with the flags each reads; None
    for a context model."""
    name = args.model_name
    base = dict(user_num=corpus.n_users, item_num=corpus.n_items,
                emb_size=args.emb_size)
    drop = dict(dropout=args.dropout)
    hist = dict(history_max=args.history_max)
    multi = dict(attn_size=args.comirec_attn_size, K=args.comirec_k,
                 add_pos=bool(args.comirec_add_pos))
    if name in ("BPRMF", "DirectAU"):
        return cls(**base)
    if name == "BUIR":
        return cls(momentum=args.buir_momentum, **base)
    if name == "NeuMF":
        return cls(layers=json.loads(args.layers), **base, **drop)
    if name == "LightGCN":
        train = corpus.data_df["train"]
        return cls(edge_users=train["user_id"].astype(np.int32),
                   edge_items=train["item_id"].astype(np.int32), **base)
    if name == "POP":
        pop = np.bincount(corpus.data_df["train"]["item_id"].astype(
            np.int64), minlength=corpus.n_items).astype(np.float32)
        return cls(popularity=pop)
    if name in ("SASRec", "Caser"):
        return cls(**base, **hist, **drop)
    if name in ("GRU4Rec", "FPMC"):
        return cls(**base, **drop)
    if name == "NARM":
        return cls(hidden_size=args.narm_hidden_size,
                   attention_size=args.narm_attention_size, **base, **drop)
    if name == "TiSASRec":
        return cls(time_max=args.time_max, **base, **hist, **drop)
    if name == "ContraRec":
        return cls(encoder=args.contrarec_encoder,
                   gamma=args.contrarec_gamma, ccc_temp=args.ccc_temp,
                   **base, **hist, **drop)
    if name == "S3Rec":
        return cls(mip_weight=args.mip_weight, sp_weight=args.sp_weight,
                   pretrain=args.s3rec_stage == 1, **base, **hist, **drop)
    if name == "CLRec":
        return cls(temp=args.ccc_temp, **base, **hist, **drop)
    if name == "FourierTA":
        return cls(t_scalar=args.t_scalar, **base, **drop)
    if name == "SRGNN":
        return cls(num_layers=args.num_layers, **base, **drop)
    if name == "TiMiRec":
        return cls(temp=args.timirec_temp, n_layers=args.timirec_n_layers,
                   stage=args.timirec_stage, **multi, **base, **hist,
                   **drop)
    if name == "ComiRec":
        return cls(**multi, **base, **hist, **drop)
    return None


def kg_mode(args, phase: str) -> str:
    """The KG feed of ``--model_name`` in ``phase`` (segrec/main.py:
    597-606)."""
    name = args.model_name
    if name == "CFKG":
        return "cfkg"
    if name == "SLRCPlus":
        return "slrc"
    if name == "KDA":
        return "kda"
    return "chorus_kg" if (args.stage == 1 and phase == "train") \
        else "chorus"


def feed_builders(args, corpus: Corpus, task: str, clip_weights=None,
                  store=None, phases=("train", "dev", "test"),
                  kg_meta=None):
    """The FeedBuilder of each phase for ``args`` (the JAX CLI's wiring,
    segrec/main.py:607-635): histories for the sequential models, DIEN's
    history negatives, ContraRec's views, SRGNN's graphs, S3Rec's pretrain
    corpus (stage 1, train) and full-sort candidates (``--test_all``); a
    KG model's KGFeedBuilder over ``kg_meta``."""
    hist = args.model_name in SEQ_MODELS
    if kg_meta is not None:
        return {phase: KGFeedBuilder(
            corpus, phase, kg=kg_meta, kg_mode=kg_mode(args, phase),
            time_scalar=args.time_scalar, category_col=args.category_col,
            t_scalar=args.t_scalar, num_neg_kg=args.num_neg,
            neg_head_p=args.neg_head_p, task=task, num_neg=args.num_neg,
            history_max=args.history_max, include_history=hist,
            test_all=bool(args.test_all) and phase != "train",
            seed=args.random_seed) for phase in phases}
    return {phase: FeedBuilder(
        corpus, phase, task=task, num_neg=args.num_neg,
        history_max=args.history_max, include_history=hist,
        neg_history=args.alpha_aux > 0 and hist,
        augment_history=args.model_name == "ContraRec",
        beta_a=args.beta_a, beta_b=args.beta_b,
        session_graph=args.model_name == "SRGNN",
        s3rec_pretrain=(args.model_name == "S3Rec" and args.s3rec_stage == 1
                        and phase == "train"),
        s3rec_mask_ratio=args.mask_ratio,
        test_all=(bool(args.test_all) and phase != "train"
                  and task == "ranking"),
        clip_weights=clip_weights, feature_store=store,
        seed=args.random_seed) for phase in phases}


def loss_name(args, task: str) -> str:
    """The JAX CLI's loss route (segrec/main.py:647-658): ``--loss_n`` if
    given (``DirectAU`` only so), else by task and model."""
    if args.loss_n:
        return args.loss_n
    if task == "ctr":
        return "BCE"
    if args.model_name in ("BUIR", "ContraRec", "CLRec"):
        return args.model_name
    if args.model_name == "S3Rec" and args.s3rec_stage == 1:
        return "S3Rec"
    if args.model_name == "CFKG":
        return "CFKG"
    if args.model_name == "Chorus" and args.stage == 1:
        return "ChorusKG"
    return "BPR"


def _save_path(path: str) -> str:
    """The port writes .pt: trained from the JAX runner's .msgpack, the
    state goes beside it."""
    if path.endswith(".msgpack"):
        return path[:-len(".msgpack")] + ".pt"
    return path


def _log_peak(device):
    if device.type == "cuda":
        logger.info("peak device memory: %.2f GiB",
                    torch.cuda.max_memory_allocated(device) / 2 ** 30)


def kg_metadata(args, corpus: Corpus):
    """A KG model's KGMeta (item_meta.csv's relations, with
    ``--include_attr`` its attribute entities); None for another model."""
    if args.model_name not in KG_MODELS:
        return None
    return KGMeta(args.path, args.dataset, sep=args.sep,
                  include_attr=bool(args.include_attr),
                  n_items=corpus.n_items)


def runner_config(args, task: str) -> RunnerConfig:
    metrics = args.metric or ("AUC,F1_SCORE,LOG_LOSS,ACC"
                              if task == "ctr" else "NDCG,HR")
    return RunnerConfig(
        epoch=args.epoch, early_stop=args.early_stop, lr=args.lr, l2=args.l2,
        batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
        optimizer=args.optimizer,
        topk=tuple(int(x) for x in args.topk.split(",")),
        metrics=tuple(m.strip().upper() for m in metrics.split(",")),
        main_metric=args.main_metric,
        loss_n=loss_name(args, task), ctc_temp=args.ctc_temp,
        margin=args.margin,
        auxillary_loss_weight=args.auxillary_loss_weight,
        seed=args.random_seed)


def make_runner(args, task: str, model, feat_table=None, device=None):
    """The JAX CLI's runner choice (segrec/main.py:672-681): CTR, Chorus's
    stage 2, leave-frame ranking, or ranking."""
    cfg = runner_config(args, task)
    if task == "ctr":
        return CTRRunner(model, cfg, feat_table=feat_table, device=device)
    if args.model_name == "Chorus" and args.stage == 2:
        return make_chorus_runner(model, cfg, args.lr_scale,
                                  feat_table=feat_table, device=device)
    if args.leave_rank:
        return LeaveRankingRunner(model, cfg, feat_table=feat_table,
                                  data_name=args.dataset, device=device)
    return RankingRunner(model, cfg, feat_table=feat_table, device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.model_mode == "Impression":
        return run_impression(args)
    task = "ctr" if args.model_mode == "CTR" else "ranking"
    model_class(args.model_name)  # an unknown name raises
    device = resolve_device(args.device)
    if args.use_mesh and device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if (n_dev > 1 and args.batch_size % n_dev == 0
                and args.eval_batch_size % n_dev == 0):
            raise NotImplementedError(
                f"--use_mesh over {n_dev} cards is not ported yet: "
                f"{QUEUE_MULTI_GPU}; pass --use_mesh 0 for one card")

    corpus = Corpus(args.path, args.dataset, sep=args.sep)
    # dense -> raw id maps: logit-key lookup (SegRec/models/BaseModel.py:
    # 132-136) and raw-id re-mapping of saved results (SegRec/main.py:148-187)
    id2user = id2item = None
    base = osp.join(args.path, args.dataset)
    if osp.exists(osp.join(base, "id2user.json")):
        with open(osp.join(base, "id2user.json")) as f:
            id2user = json.load(f)
        with open(osp.join(base, "id2item.json")) as f:
            id2item = json.load(f)
    clip_weights = None
    if args.clip_weight_path:
        clip_weights = ClipWeights(args.clip_weight_path,
                                   id2user=id2user, id2item=id2item,
                                   neg_weight_path=args.eval_neg_weight_path)
    feat_table = store = None
    if args.clip_feature_memmap and args.lineid_map:
        store = FeatureStore.open(args.clip_feature_memmap, args.lineid_map)
        feat_table = store.feat

    kg_meta = kg_metadata(args, corpus)
    builders = feed_builders(args, corpus, task, clip_weights, store,
                             kg_meta=kg_meta)
    model = build_model(args, corpus, use_frames=store is not None,
                        kg_meta=kg_meta)
    runner = make_runner(args, task, model, feat_table=feat_table,
                         device=device)

    best_state, _ = runner.train(
        builders,
        init_path=args.model_path if (args.load or not args.train) else "",
        do_train=bool(args.train))
    if args.model_path and args.train:
        runner.save_state(best_state, _save_path(args.model_path))
    dev_res = runner.evaluate(builders["dev"], best_state)
    test_res = runner.evaluate(builders["test"], best_state)
    _log_peak(device)
    logger.info("Dev  After Training: %s", dev_res)
    logger.info("Test After Training: %s", test_res)
    result = {"dev": dev_res, "test": test_res}
    if args.save_final_results and task == "ctr":
        os.makedirs(args.result_dir, exist_ok=True)
        preds, labels, users = runner.predict(builders["test"])
        wuauc = test_res.get("WUAUC", 0.0)
        out_path = osp.join(
            args.result_dir,
            f"rec-{args.model_name}{args.model_mode}-test_wuauc={wuauc}.csv")
        if id2user is not None:  # raw ids on save (SegRec/main.py:148-187)
            users = np.asarray([id2user.get(str(u), u) for u in users],
                               dtype=object)
        write_csv({"user_id": users, "pCTR": preds, "label": labels},
                  out_path)
        logger.info("saved CTR predictions to %s", out_path)
    if args.all_inference:
        out_path = all_inference(args, task, runner, builders)
        logger.info("saved inference scores to %s", out_path)
    print(json.dumps(result, indent=2))
    return result


def run_impression(args):
    """Impression / reranking flow (ReChorus main.py with ImpressionReader /
    ImpressionRunner; the JAX CLI's run_impression, segrec/main.py:
    455-531): the base rankers (BPRMF / SASRec Impression variants) train
    on impression lists; the rerankers (PRM / SetRank / MIR) wrap a ranker
    taken from ``--ranker_model_path`` (frozen unless ``--tuneranker
    1``)."""
    device = resolve_device(args.device)
    builders, _, runner = impression_setup(args, device)
    is_reranker = args.model_name in RERANKERS
    if is_reranker and args.ranker_model_path:
        runner.load_ranker(args.ranker_model_path)
        best_state = (_impression_train_from(runner, builders)
                      if args.train else runner.state())
    else:
        best_state, _ = runner.train(
            builders,
            init_path=args.model_path if (args.load or not args.train)
            else "", do_train=bool(args.train))
    if args.model_path and args.train:
        runner.save_state(best_state, _save_path(args.model_path))
    dev_res = runner.evaluate(builders["dev"], best_state)
    test_res = runner.evaluate(builders["test"], best_state)
    _log_peak(device)
    logger.info("Dev  After Training: %s", dev_res)
    logger.info("Test After Training: %s", test_res)
    result = {"dev": dev_res, "test": test_res}
    print(json.dumps(result, indent=2))
    return result


def impression_builders(args, corpus=None, phases=("train", "dev", "test")):
    """Impression mode's ImpressionFeedBuilders for ``args``
    (segrec/main.py:462-474): histories where a SASRec ranker or MIR reads
    them."""
    corpus = corpus or Corpus(args.path, args.dataset, sep=args.sep)
    seq_needed = (args.model_name in ("MIR", "SASRec")
                  or (args.model_name in RERANKERS
                      and args.ranker_name == "SASRec"))
    return {phase: ImpressionFeedBuilder(
        corpus, phase, pos_len=args.train_max_pos_item,
        neg_len=args.train_max_neg_item,
        history_max=args.history_max if seq_needed else 0,
        seed=args.random_seed) for phase in phases}


def impression_config(args) -> RunnerConfig:
    """Impression mode's runner settings: NDCG, MAP and HR, the loss
    BPRsession unless ``--loss_n`` names another."""
    metrics = args.metric or "NDCG,MAP,HR"
    return RunnerConfig(
        epoch=args.epoch, early_stop=args.early_stop, lr=args.lr,
        l2=args.l2, batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size, optimizer=args.optimizer,
        topk=tuple(int(x) for x in args.topk.split(",")),
        metrics=tuple(m.strip().upper() for m in metrics.split(",")),
        main_metric=args.main_metric,
        loss_n=args.loss_n or "BPRsession", seed=args.random_seed)


def impression_setup(args, device=None, builders=None):
    """Impression mode's builders (``builders`` if given), model
    (initialised from ``--random_seed``) and runner for ``args``
    (segrec/main.py:462-511)."""
    builders = builders or impression_builders(args)
    corpus = builders["train"].corpus
    pos_len, neg_len = args.train_max_pos_item, args.train_max_neg_item
    is_reranker = args.model_name in RERANKERS

    def make_ranker(name, emb):
        kw = dict(user_num=corpus.n_users, item_num=corpus.n_items,
                  emb_size=emb)
        if name == "SASRec":
            kw.update(num_heads=args.num_heads, history_max=args.history_max)
        return IMPRESSION_RANKERS[name](**kw)

    if is_reranker:
        kw = dict(item_num=corpus.n_items,
                  ranker=make_ranker(args.ranker_name, args.ranker_emb_size),
                  ranker_emb_size=args.ranker_emb_size, pos_len=pos_len,
                  neg_len=neg_len, emb_size=args.emb_size,
                  num_heads=args.num_heads,
                  num_hidden_unit=args.num_hidden_unit,
                  dropout=args.dropout, tuneranker=bool(args.tuneranker))
        if args.model_name in ("PRM", "SetRank"):
            kw["n_blocks"] = args.n_blocks
        if args.model_name == "SetRank":
            kw["setrank_type"] = args.setrank_type
        model = RERANKERS[args.model_name](**kw)
    else:
        model = make_ranker(args.model_name, args.emb_size)
    init_weights(model, torch.Generator().manual_seed(args.random_seed))
    return builders, model, ImpressionRunner(
        model, impression_config(args), pos_len, neg_len, device=device)


def _impression_train_from(runner, builders):
    """runner.train() from the model as it stands (the ranker absorbed),
    as the JAX CLI's loop (segrec/main.py:534-556): each epoch's dev
    result at every top-k, no stop on a NaN loss. Returns the best
    state."""
    main_results = []
    best_state = runner.state()
    for epoch in range(runner.cfg.epoch):
        loss = runner.fit(builders["train"], epoch + 1)
        dev_result = runner.evaluate(builders["dev"])
        main_results.append(dev_result[runner.main_metric])
        star = ""
        if max(main_results) == main_results[-1]:
            best_state = runner.state()
            star = " *"
        logger.info("Epoch %-4d loss=%.4f dev=%s%s", epoch + 1, loss,
                    dev_result, star)
        if runner.eval_termination(main_results, runner.cfg.early_stop):
            logger.info("Early stop at %d based on dev result.", epoch + 1)
            break
    return best_state


def all_inference(args, task: str, runner, builders) -> str:
    """Per-candidate scores over train/dev/test for the logits converter
    (ReChorus fork main.py:105-141): one row per (row, candidate), the CTR
    probability or the ranking score."""
    os.makedirs(args.result_dir, exist_ok=True)
    cols = {"user_id": [], "time": [], "item_id": [], "predictions": []}
    for phase in ("train", "dev", "test"):
        b = builders[phase]
        if phase == "train" and task == "ranking":
            b.actions_before_epoch()
        preds = runner.predict(b)
        if task == "ctr":
            preds = preds[0]
        if preds.ndim == 1:
            preds = preds[:, None]
        items = b._candidates(np.arange(len(b)))
        n, c = items.shape
        cols["user_id"].append(np.repeat(b.user_id, c))
        cols["time"].append(np.repeat(np.asarray(b.time, np.int64), c))
        cols["item_id"].append(items.reshape(-1))
        cols["predictions"].append(preds.reshape(-1).astype(np.float64))
    out_path = osp.join(args.result_dir, f"inference_scores-{args.model_name}"
                                         f"{args.model_mode}.csv")
    return write_csv({k: np.concatenate(v) for k, v in cols.items()},
                     out_path)


if __name__ == "__main__":
    main()
