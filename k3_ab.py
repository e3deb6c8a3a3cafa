#!/usr/bin/env python3
"""K3 in bf16 for the port of one checkout: the kernels' device times and
CrossAtt's served batch, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 k3_ab.py [--root DIR]

It imports segmminterest_tpu_torch from DIR (default: this checkout), which
builds that package's kernels under DIR/build, and prints one JSON line:
  * K3f and K3b in bf16 at B=1024 on CrossAtt's two feature streams,
    (Lq, Lk) = (40, 100) and (100, 40), 16 heads of 32: device ms per call
    from torch.profiler (the kernels' own time, not the wrapper's), beside
    SDPA's forward and backward on the same inputs with an additive -10000
    pair mask;
  * CrossAtt served with --serving 1 (bf16, int8 table, K3) at B=1024 over
    the 3,920,483-row int8 table of chip_smoke.py: ms per batch with the
    batch on the card (CUDA events), and K3f's share of its device time;
  * the card's name and power limit (nvidia-smi).
To compare two checkouts, run it on each in turns in one call on one card:
A, B, B, A. The measuring code is this file's and chip_smoke.py's whatever
DIR is, so only the port under test differs.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

import chip_smoke as C

SHAPES = ((40, 100), (100, 40))
B = 1024


def _kernels(A, g, dev):
    H, Dh = C.HEADS, C.D_MODEL // C.HEADS
    scale = 1.0 / math.sqrt(Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for Lq, Lk in SHAPES:
        qkv = [torch.randn(B, L, H, Dh, generator=g, device=dev).to(
            torch.bfloat16) for L in (Lq, Lk, Lk)]
        m = (C._masks(g, B, Lq, dev), C._masks(g, B, Lk, dev, False))
        gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev).to(
            torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in qkv]
        o = A.fused_masked_attention(*leaves, *m, scale=scale)
        ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in qkv)
        pair = A._pair_mask(*m)
        bias = torch.zeros(pair.shape, device=dev, dtype=torch.bfloat16
                           ).masked_fill(~pair, -10000.0)
        lo = sdpa(ql, kl, vl, attn_mask=bias, scale=scale)
        gl = gq.transpose(1, 2).contiguous()
        out[f"{Lq}x{Lk}"] = dict(
            k3f_ms=C._device_ms(lambda: A.fused_masked_attention(
                *qkv, *m, scale=scale), 20, C.K3_NAMES[:1]),
            k3b_ms=C._device_ms(lambda: torch.autograd.grad(
                o, leaves, gq, retain_graph=True), 10, C.K3_NAMES[1:]),
            sdpa_ms=C._device_ms(lambda: sdpa(
                ql.detach(), kl.detach(), vl.detach(), attn_mask=bias,
                scale=scale), 20),
            sdpa_bwd_ms=C._device_ms(lambda: torch.autograd.grad(
                lo, (ql, kl, vl), gl, retain_graph=True), 10))
    return out


def _served(dev):
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import export_logits as X

    ctx = C._data({})
    reader, store = ctx["reader"], ctx["store"]
    cfg = X.apply_serving_preset(C._flagship_cfg(ctx["csv"]).replace(
        ablation_type="CrossAtt"))
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device=dev)
    state = engine.init_state()
    batch = next(iter(BatchIterator(reader, reader.tables["train"], B,
                                    feature_store=store, seed=cfg.seed,
                                    prefetch_size=0)))
    dev_batch = {"_dev": engine.put_batch(batch)}
    _, logits, _ = engine.eval_step(state, dev_batch)
    if logits.shape != (B, 40) or not torch.isfinite(logits).all():
        raise AssertionError("CrossAtt serving: logits not (1024, 40) finite")
    ms = C._time_ms(lambda: engine.eval_step(state, dev_batch), 10)
    share = C._device_share(lambda: engine.eval_step(state, dev_batch), 3,
                            C.K3_NAMES[:1])
    return dict(ms_per_batch=ms,
                k3f_share=None if share is None else share[0],
                device_ms_per_batch=None if share is None else share[1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=C.ROOT,
                   help="checkout whose segmminterest_tpu_torch is measured")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from segmminterest_tpu_torch.core import attention as A
    if not os.path.abspath(A.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {A.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = dict(root=root, kernels=_kernels(A, g, dev), served=_served(dev))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
