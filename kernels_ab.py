#!/usr/bin/env python3
"""The redesigned attention kernels of one checkout's port: their device
times and two served batches, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 kernels_ab.py [--root DIR]

It imports segmminterest_tpu_torch from DIR (default: this checkout), which
builds that package's kernels under DIR/build, and prints one JSON line:
  * at B=1024, 16 heads of 32, device ms per call from torch.profiler (the
    kernels' own time, not the wrapper's):
      - K3f and K3b in bf16 on CrossAtt's two feature streams, (Lq, Lk) =
        (40, 100) and (100, 40), beside SDPA's forward and backward on the
        same inputs with an additive -10000 pair mask;
      - K1f and K1b in fp32 at the four (Lq, L1, L2) stream shapes of a
        both/both layer and K3f and K3b in fp32 at (40, 100) and (100, 40),
        with dropout off and on (rate 0.1), each with its largest error
        relative to the plain version's largest output; the forwards beside
        SDPA's fp32 forward on the same inputs;
  * the SHA-256 of fp32 K1b's and K3b's outputs on fixed inputs
    (chip_smoke.fp32_bwd_digest): equal for two checkouts whose backward
    bodies compute bit for bit the same;
  * CrossAtt served with --serving 1 (bf16, int8 table, K3) and the
    default configuration served (fp32, int8 table, K1), at B=1024 over the
    3,920,483-row int8 table of chip_smoke.py: ms per batch with the batch
    on the card (CUDA events), device ms per batch and K3f's / K1f's share
    of it;
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

K3_SHAPES = ((40, 100), (100, 40))
B = 1024
SEED = 1234567


def _rel(got, want):
    return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def _k3_bf16(A, g, dev):
    H, Dh = C.HEADS, C.D_MODEL // C.HEADS
    scale = 1.0 / math.sqrt(Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for Lq, Lk in K3_SHAPES:
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


def _fp32_fwd(A, g, dev):
    """fp32 K1f and K3f through their wrappers: device ms of the kernel and
    its error against the plain version, dropout off and on, beside SDPA's
    fp32 forward (K1: over the concat construction, as chip_smoke.py times
    it)."""
    H, Dh = C.HEADS, C.D_MODEL // C.HEADS
    scale = 1.0 / math.sqrt(Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    cases = []
    for (Lq, L1, L2) in C.STREAM_SHAPES:
        qkv, m = C._k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
        q1, q2, k1, k2, v1, v2 = qkv
        qs = torch.cat([q1, q2], -1).transpose(1, 2).contiguous()
        ks = torch.cat([torch.cat([k1, torch.zeros_like(k1)], -1),
                        torch.cat([torch.zeros_like(k2), k2], -1)],
                       1).transpose(1, 2).contiguous()
        vs = torch.cat([v1, v2], 1).transpose(1, 2).contiguous()
        pair = A._pair_mask(m[0], torch.cat([m[1], m[2]], 1))
        cases.append((f"K1f {(Lq, L1, L2)}", qkv, m,
                      A.fused_two_block_attention,
                      A.two_block_attention_plain, C.K1_NAMES[:1],
                      (qs, ks, vs, pair)))
    for (Lq, Lk) in K3_SHAPES:
        qkv = [torch.randn(B, L, H, Dh, generator=g, device=dev)
               for L in (Lq, Lk, Lk)]
        m = (C._masks(g, B, Lq, dev), C._masks(g, B, Lk, dev, False))
        cases.append((f"K3f {(Lq, Lk)}", qkv, m, A.fused_masked_attention,
                      A.masked_attention_plain, C.K3_NAMES[:1],
                      tuple(t.transpose(1, 2).contiguous() for t in qkv)
                      + (A._pair_mask(*m),)))
    for name, qkv, m, fused, plain, names, (ql, kl, vl, pair) in cases:
        bias = torch.zeros(pair.shape, device=dev).masked_fill(~pair,
                                                               -10000.0)
        sdpa_ms, _ = C._sdpa_device(lambda: sdpa(ql, kl, vl, attn_mask=bias,
                                                 scale=scale), 10)
        for rate in (0.0, C.DROP_RATE):
            def fwd(rate=rate):
                return fused(*qkv, *m, scale=scale, dropout_rate=rate,
                             seed=SEED, deterministic=rate == 0)
            ms = C._device_ms(fwd, 10, names)
            err = _rel([fwd()], [plain(*qkv, *m, scale, rate, SEED)])
            out[f"{name} rate {rate}"] = dict(ms=ms, err=err,
                                              sdpa_ms=sdpa_ms)
            print(f"  {name} rate {rate}: {C._ms(ms)} ms (sdpa "
                  f"{C._ms(sdpa_ms)}), err {err:.2g}", flush=True)
    return out


def _fp32_bwd(A, g, dev):
    """fp32 K1b and K3b through their wrappers: device ms of the backward
    kernel and its error against the plain version."""
    H, Dh = C.HEADS, C.D_MODEL // C.HEADS
    scale = 1.0 / math.sqrt(Dh)
    cases = []
    for (Lq, L1, L2) in C.STREAM_SHAPES:
        qkv, m = C._k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
        cases.append((f"K1b {(Lq, L1, L2)}", qkv, m, Lq,
                      A.fused_two_block_attention,
                      A.two_block_attention_bwd_plain, C.K1_NAMES[1:]))
    for (Lq, Lk) in K3_SHAPES:
        qkv = [torch.randn(B, L, H, Dh, generator=g, device=dev)
               for L in (Lq, Lk, Lk)]
        m = (C._masks(g, B, Lq, dev), C._masks(g, B, Lk, dev, False))
        cases.append((f"K3b {(Lq, Lk)}", qkv, m, Lq, A.fused_masked_attention,
                      A.masked_attention_bwd_plain, C.K3_NAMES[1:]))
    out = {}
    for name, qkv, m, Lq, fused, plain, names in cases:
        gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev)
        for rate in (0.0, C.DROP_RATE):
            leaves = [t.detach().requires_grad_() for t in qkv]
            o = fused(*leaves, *m, scale=scale, dropout_rate=rate, seed=SEED,
                      deterministic=rate == 0)

            def bwd(o=o, leaves=leaves, gq=gq):
                return torch.autograd.grad(o, leaves, gq, retain_graph=True)
            ms = C._device_ms(bwd, 5, names)
            err = _rel(bwd(), plain(*qkv, *m, gq, scale, rate, SEED))
            out[f"{name} rate {rate}"] = dict(ms=ms, err=err)
            print(f"  {name} rate {rate}: {C._ms(ms)} ms, err {err:.2g}",
                  flush=True)
            del o, leaves
    return out


def _served(dev):
    """B=1024 batches served: CrossAtt with the serving preset (bf16, int8
    table, K3) and the default configuration (fp32, int8 table, K1): ms per
    batch with the batch on the card (CUDA events), device ms per batch and
    K3f's / K1f's share of it (torch.profiler)."""
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import export_logits as X

    ctx = C._data({})
    reader, store = ctx["reader"], ctx["store"]
    flagship = C._flagship_cfg(ctx["csv"])
    out = {}
    for name, cfg, names in (
            ("crossatt_bf16", X.apply_serving_preset(flagship.replace(
                ablation_type="CrossAtt")), C.K3_NAMES[:1]),
            ("default_fp32", flagship.replace(
                compute_dtype="float32", table_quant="int8",
                fused_attention=True, fuse_qkv=False),
             C.K1_NAMES[:1])):
        engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                feature_table=ctx["table"], device=dev)
        state = engine.init_state()
        batch = next(iter(BatchIterator(reader, reader.tables["train"], B,
                                        feature_store=store, seed=cfg.seed,
                                        prefetch_size=0)))
        dev_batch = {"_dev": engine.put_batch(batch)}
        _, logits, _ = engine.eval_step(state, dev_batch)
        if logits.shape != (B, 40) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name} serving: logits not (1024, 40) "
                                 "finite")
        ms = C._time_ms(lambda: engine.eval_step(state, dev_batch), 10)
        share = C._device_share(lambda: engine.eval_step(state, dev_batch),
                                3, names)
        out[name] = dict(ms_per_batch=ms,
                         kernel_share=None if share is None else share[0],
                         device_ms_per_batch=None if share is None
                         else share[1])
        del engine, state
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=C.ROOT,
                   help="checkout whose segmminterest_tpu_torch is measured")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from segmminterest_tpu_torch.core import attention as A
    if not os.path.abspath(A.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {A.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = dict(root=root, k3_bf16=_k3_bf16(A, g, dev),
               fp32_fwd=_fp32_fwd(A, g, dev), fp32_bwd=_fp32_bwd(A, g, dev),
               fp32_bwd_sha256=C.fp32_bwd_digest(A, dev), served=_served(dev))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
