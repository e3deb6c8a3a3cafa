"""MMRec's command line (port of ``segmminterest_tpu/mmrec/main.py``).

Behavioral spec: reference SkipPredBaseline/MMRec/src/main.py +
utils/quick_start.py: pick a model, build the frame-as-item dataset, train
with eval-step early stopping, report best-test-upon-valid; --save_logits
exports the canonical interest-logit dict for SegRec. --grid sweeps
hyperparameter combinations like the reference's quick_start() product loop
(quick_start.py:53-100).

  python -m segmminterest_tpu_torch.mmrec.main --model FREEDOM \\
      --inter_csv interactions.csv \\
      --min_interactions 30 --num_warmup 10 --epochs 5 \\
      --grid 'lr=0.001,0.0001;emb_size=64,128' [--device cpu]

The parser is the JAX CLI's, every flag, plus ``--device`` (the card
unless ``cpu`` is asked for; without a card and without ``--device cpu`` it
raises). The data are built without pandas (``data/reader.py``'s frames).
LATTICE's frozen global kNN graph is built on the device
(``graph.global_weighted_knn_graph_device``): the host function is
quadratic in the frames. ``--use_mesh`` over more than one card is ROADMAP
Queue A item 6 and raises; on one card (or the CPU) the run takes that
device, as the JAX CLI's ``mesh_for`` gives no mesh for one device. On the
card the run logs its peak device memory.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import logging

import numpy as np
import torch

from ..data.labels import frame_count
from ..data.reader import (concat, normalize_columns, read_csv,
                           split_interactions)
from ..segrec.feeds import QUEUE_MULTI_GPU
from ..utils.device import resolve_device
from ..utils.io import dump_logits
from .graph import (bipartite_norm_edges, global_weighted_knn_graph_device,
                    knn_item_graph)
from .models import MMREC_REGISTRY
from .runner import MMRecConfig, MMRecRunner

logger = logging.getLogger(__name__)


def build_mmrec_data(inter_csv, sep, min_interactions, num_warmup, seed):
    """Raw interactions -> frame universe + train edges + eval interactions
    (the get_data_MMRec.py pipeline, in memory). The JAX function's pandas
    calls, reproduced on numpy columns: a video's frames come from its
    first row in train -> dev -> test order (``drop_duplicates``), the
    frame map walks the videos ascending."""
    df = normalize_columns(read_csv(inter_csv, sep=sep))
    parts = split_interactions(df, seed=seed, num_warmup=num_warmup,
                               min_interactions=min_interactions)
    combined = concat([parts[k] for k in ("train", "dev", "test")])
    uids = {u: i for i, u in enumerate(
        np.unique(combined["user_id"]).tolist(), 1)}
    videos, first = np.unique(combined["video_id"], return_index=True)
    photo2frames = {}
    next_id = 1
    for pid, dur in zip(videos.tolist(),
                        combined["duration_ms"][first].tolist()):
        n = min(frame_count(dur), 40)
        photo2frames[str(int(pid))] = list(range(next_id, next_id + n))
        next_id += n
    n_users = len(uids) + 1
    n_items = next_id

    def rows(part):
        return zip(*(part[c].tolist() for c in (
            "user_id", "video_id", "playing_time", "duration_ms",
            "time_ms")))

    train_u, train_i = [], []
    for user, video, play, dur, _ in rows(parts["train"]):
        frames = photo2frames[str(int(video))]
        watched = max(1, frame_count(min(play, dur)))
        for k in range(min(watched, len(frames))):
            train_u.append(uids[user])
            train_i.append(frames[k])

    def eval_inters(part):
        out = []
        for user, video, play, dur, time_ms in rows(part):
            frames = photo2frames[str(int(video))]
            vl = max(1, frame_count(min(play, dur))) - 1
            out.append({"userID": uids[user],
                        "user_id": int(user),
                        "photo_id": int(video),
                        "view_length": min(vl, 40),
                        "duration": len(frames),
                        "time": int(time_ms)})
        return out

    return {
        "n_users": n_users, "n_items": n_items,
        "train_u": np.asarray(train_u), "train_i": np.asarray(train_i),
        "frame_map": photo2frames,
        "dev": eval_inters(parts["dev"]), "test": eval_inters(parts["test"]),
        "all": (eval_inters(parts["train"]) + eval_inters(parts["dev"])
                + eval_inters(parts["test"])),
        "train_photos": set(int(p) for p in parts["train"]["video_id"]),
    }


def parse_grid(spec: str):
    """'lr=0.001,0.0001;emb_size=64,128' -> (keys, combination tuples) — the
    reference's config['hyper_parameters'] x product(*hyper_ls)
    (quick_start.py:53-60)."""
    keys, value_lists = [], []
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        key, _, vals = part.partition("=")
        parsed = []
        for v in vals.split(","):
            v = v.strip()
            try:
                parsed.append(int(v))
            except ValueError:
                try:
                    parsed.append(float(v))
                except ValueError:
                    parsed.append(v)
        keys.append(key.strip())
        value_lists.append(parsed)
    return keys, list(itertools.product(*value_lists))


def item_graph(model: str, v_feat: np.ndarray, knn_k: int, device):
    """FREEDOM's block-local kNN graph (host) or LATTICE's global
    sim-weighted one (on ``device``) over the modal features (the position
    column dropped): (edges, values)."""
    feats = v_feat[:, :-1] if v_feat.shape[-1] % 8 == 1 else v_feat
    if model == "LATTICE":
        # LATTICE's frozen original_adj is a GLOBAL sim-weighted kNN
        # (lattice.py:72-76 via utils.build_sim), unlike FREEDOM's
        # block-local count-normalized one (freedom.py:103-119)
        return global_weighted_knn_graph_device(
            torch.from_numpy(feats).to(device), knn_k)
    return knn_item_graph(feats, knn_k)


def build_model(args, data, device, v_feat=None, mm_graph=None):
    """``args.model`` over ``data``'s train edges and ``v_feat`` (read from
    ``--feat_npy``, else random 64-d features from seed 0); ``mm_graph``:
    FREEDOM's or LATTICE's item graph where the caller built it."""
    eu, ei, ev = bipartite_norm_edges(data["train_u"], data["train_i"],
                                      data["n_users"], data["n_items"])
    if v_feat is None and args.feat_npy:
        v_feat = np.load(args.feat_npy).astype(np.float32)
    elif v_feat is None:
        v_feat = np.random.default_rng(0).normal(
            size=(data["n_items"], args.feat_dim)).astype(np.float32)
    kwargs = dict(n_users=data["n_users"], n_items=data["n_items"],
                  edge_u=eu, edge_i=ei, edge_values=ev,
                  emb_size=args.emb_size, v_feat=v_feat)
    if args.model in ("FREEDOM", "LATTICE"):
        mm_edges, mm_values = mm_graph or item_graph(args.model, v_feat,
                                                     args.knn_k, device)
        kwargs.update(mm_edges=mm_edges, mm_values=mm_values)
    return MMREC_REGISTRY[args.model](**kwargs)


def make_runner(args, data, model, device) -> MMRecRunner:
    cfg = MMRecConfig(epochs=args.epochs, stopping_step=args.stopping_step,
                      learning_rate=args.lr, batch_size=args.batch_size,
                      edge_dropout=args.edge_dropout, seed=args.seed,
                      use_mask_eval=bool(args.use_mask_eval))
    return MMRecRunner(model, cfg, data["train_u"], data["train_i"],
                       data["n_items"], device=device)


def run_one(args, data, device):
    """Build model + runner for one hyperparameter configuration and train.
    Returns (runner, best_state, result)."""
    runner = make_runner(args, data, build_model(args, data, device), device)
    best_state, result = runner.train(data["dev"], data["test"],
                                      data["frame_map"])
    return runner, best_state, result


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="FREEDOM",
                   choices=sorted(MMREC_REGISTRY))
    p.add_argument("--inter_csv", type=str, required=True)
    p.add_argument("--sep", type=str, default=",")
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--feat_npy", type=str, default="",
                   help="(n_frames, D[+1 pos]) frame feature matrix; "
                        "random features are synthesized when omitted")
    p.add_argument("--feat_dim", type=int, default=64)
    p.add_argument("--emb_size", type=int, default=64)
    p.add_argument("--knn_k", type=int, default=10)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--stopping_step", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--edge_dropout", type=float, default=0.0)
    p.add_argument("--use_mask_eval", type=int, default=1)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--save_logits", type=str, default="")
    p.add_argument("--test_cold", type=int, default=0,
                   help="also report cold/hot test splits (videos unseen/"
                        "seen in training) — MMRec fork main.py:21-23, "
                        "topk_evaluator.py:235-260")
    p.add_argument("--grid", type=str, default="",
                   help="hyperparameter grid 'key=v1,v2;key2=v3,v4' over "
                        "any CLI flag (e.g. lr, emb_size, knn_k, seed); "
                        "reproduces quick_start()'s product loop with "
                        "per-combination best-valid/best-test reporting "
                        "(quick_start.py:53-100)")
    p.add_argument("--use_mesh", type=int, default=1,
                   help="shard the triplet batch over the visible cards "
                        "when more than one is visible and batch_size "
                        "divides (not ported: raises)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def _check_mesh(args, device, batch_size):
    """Per trial, as the JAX CLI's mesh_for: a batch over several cards
    raises; one card or the CPU runs on that device."""
    if args.use_mesh and device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if n_dev > 1 and batch_size % n_dev == 0:
            raise NotImplementedError(
                f"--use_mesh over {n_dev} cards is not ported yet: "
                f"{QUEUE_MULTI_GPU}; pass --use_mesh 0 for one card")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    data = build_mmrec_data(args.inter_csv, args.sep, args.min_interactions,
                            args.num_warmup, 2024)
    logger.info("frames=%d users=%d train pairs=%d", data["n_items"],
                data["n_users"], len(data["train_u"]))

    if args.grid:
        # the reference grid loop: run every combination, report each
        # (valid, test) pair, and surface the combination whose
        # best_test_upon_valid wins on the valid metric — quick_start.py's
        # (quirky, replicated) best-by-TEST selection :85-89
        keys, combos = parse_grid(args.grid)
        hyper_ret = []
        best_test_value, best_idx = 0.0, 0
        for idx, combo in enumerate(combos):
            trial = copy.copy(args)
            for k, v in zip(keys, combo):
                setattr(trial, k, v)
            logger.info("=== %d/%d: %s=%s ===", idx + 1, len(combos),
                        keys, list(combo))
            _check_mesh(trial, device, trial.batch_size)
            _, _, res = run_one(trial, data, device)
            hyper_ret.append({"params": dict(zip(keys, combo)),
                              "best_valid_result": res["best_valid_result"],
                              "best_test_upon_valid":
                                  res["best_test_upon_valid"]})
            metric = res["best_test_upon_valid"].get("hr@5", 0.0)
            if metric > best_test_value:
                best_test_value, best_idx = metric, idx
            logger.info("best valid: %s", res["best_valid_result"])
            logger.info("test: %s", res["best_test_upon_valid"])
        out = {"grid": hyper_ret, "best": hyper_ret[best_idx]}
        _log_peak(device)
        print(json.dumps(out, indent=2))
        return out

    _check_mesh(args, device, args.batch_size)
    runner, best_state, result = run_one(args, data, device)
    if args.test_cold:
        cold = [r for r in data["test"]
                if r["photo_id"] not in data["train_photos"]]
        hot = [r for r in data["test"]
               if r["photo_id"] in data["train_photos"]]
        eval_rng = np.random.default_rng(args.seed)
        result["cold_test"] = (runner.evaluate(best_state, cold,
                                               data["frame_map"], eval_rng)
                               if cold else {})
        result["hot_test"] = (runner.evaluate(best_state, hot,
                                              data["frame_map"], eval_rng)
                              if hot else {})
        logger.info("cold/hot test sizes: %d/%d", len(cold), len(hot))
    if args.save_logits:
        logits = runner.export_logits(best_state, data["all"],
                                      data["frame_map"])
        dump_logits(logits, args.save_logits)
        logger.info("wrote %d logit rows to %s", len(logits),
                    args.save_logits)
    _log_peak(device)
    print(json.dumps(result, indent=2))
    return result


def _log_peak(device):
    if device.type == "cuda":
        logger.info("peak device memory: %.2f GiB",
                    torch.cuda.max_memory_allocated(device) / 2 ** 30)


if __name__ == "__main__":
    main()
