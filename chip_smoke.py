#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py
(`--phases build,kernels` runs a subset while developing.)

Phases, each of which fails the run (non-zero exit) on any error:
  build          compile the CUDA kernels of core/csrc with nvcc for sm_90a
                 (seconds per library); the libraries of K1f, K1b, K3f and
                 K3b must hold TF32 HMMA instructions, K2f's, K2b's, K4f's,
                 K4b's, K5b's and K6b's BF16 ones (cuobjdump -sass up to
                 the first, each library as soon as it links; the last
                 ones finish beside phase kernels at the lowest priority)
  kernels        each kernel (K1f, K1b, K2f, K2b, K7b, K3f, K3b, K5f, K5b,
                 K4f, K4b, K6f, K6b) against its plain PyTorch version on
                 the card, at the main paths' stream shapes, fp32 and bf16,
                 dropout off and on, near-one-hot rows for K1b and K3,
                 every kernel also at head dims 48, 96 and 128 (d_model
                 768 / 16 and 8 heads, 512 / 4) in fp32 and bf16, and
                 timed at 4 heads of 128 (the `<K> D128` entries); every
                 kernel at streams past its core's one chunk ((200, 150,
                 300), (1, 300, 7); K3 (200, 300), (128, 128)) and K4 at
                 d = ff = 1024, fp32 and bf16, dropout off and on, K1b's
                 and K3b's gradients bit-equal across two calls; bf16 K1f
                 and K1b at B=1024 beside SDPA's bf16 calls; fp32
                 K1b's and K3b's outputs on fixed inputs bit for bit those
                 of the tree that introduced their bodies (a SHA-256);
                 bf16 K2b's, K4b's, K5b's and K6b's dW and db bit-equal
                 across two calls; bf16 K4, K5 and K6 on their
                 tensor-core bodies and fp32 on K2's fp32 route (by the
                 kernels' names in a profiler trace); K3 on
                 near-one-hot rows in 8 seeded draws of their own; times
                 at B=1024 (K2f and K2b at the four stream shapes kernel
                 by kernel by device time, dropout off and on; K4f and K4b
                 at the four by device time; K6 in turns with K2 by device
                 time; K5b by device time; fp32 K1 at
                 the four stream shapes and K3 at (40, 100) and (100, 40)
                 by their device time, the forwards with dropout off and
                 on, beside SDPA's)
  serving        the flagship both/both model (d=512, 16 heads, 6 layers)
                 served with the --serving preset over a 3,920,483-row int8
                 feature table built on the card, through the exporter's
                 functions, plus one run of the exporter's CLI over a small
                 memmap; latency per batch size
  default        the default config (K1 route, fp32) on the same checkpoint,
                 against an fp32 K2 run and against the CPU's plain versions
  train          the production training config (bf16, K2, int8 table, no
                 remat, B=1024) for 12 steps through the engine's own
                 functions: ms per step, interactions/s, 20 K2f + 18 K2b
                 launches per step; then 3 steps of the K7b route
  train_default  the default config trained (K1, fp32, layer remat): 40 K1f
                 + 18 K1b per step; one 32-row fp32 step against the CPU on
                 the K2 route and one on the K1 route (18 K1b)
  train_bf16     the default config in bf16 (--compute_dtype bfloat16, K1
                 on the bf16 two-block core, layer remat, B=1024): 40 K1f
                 + 18 K1b per step, K1's share of the step; a batch served
                 (20 K1f); one 32-row bf16 step against the CPU
  ablation       the ablation models at the flagship width over the same
                 table: CrossAtt and SelfAtt trained in the default config
                 (fp32, K3, layer remat; 40 K3f + 18 K3b and 20 K3f + 10 K3b
                 per step), CrossAtt trained in the production config (bf16,
                 no remat; 20 K3f + 18 K3b per step) and served with
                 --serving 1 (bf16, 20 K3f per forward, K3f's share of the
                 batch), one step each of CrossMLP, SelfMLP, w/oAtt, noPos
                 and fuse_projections; one 32-row fp32 CrossAtt step against
                 the CPU
  fused_variants the production training config (bf16, int8 table, no
                 remat, B=1024) with fuse_dual (5 K5f + 10 K2f, 5 K5b + 9
                 K2b per step) and with fuse_layer (20 K4f + 18 K4b), beside
                 the K2 config: ms per step, interactions/s, peak device
                 memory; each served at B=1024; the default config (fp32)
                 with fuse_layer and remat on, which must not remat; one
                 32-row fp32 step of each on the card against the CPU
  attn_v2        SEGMM_ATTN_V2's route: the production training config
                 with K6 (K2's weight-interleaved version 2) on every
                 fuse_qkv stream, 20 K6f + 18 K6b and no K2 per step; 3
                 batches served at B=1024; one 32-row fp32 step against the
                 CPU; skip_train's CLI under the switch (here), then
                 export_logits --serving 1 on its checkpoint in a process
                 of its own with SEGMM_ATTN_V2=1 in its environment (it
                 runs on beside phases wide and train_cli, which time
                 nothing; checked at the end of train_cli)
  wide           one training step per route at 4 heads of 128 (skip_train
                 --nhead 4 at d_model 512, B=256): the default config's K1
                 and CrossAtt's K3 (fp32), the production config's K2, K6,
                 K5 and K4 (bf16), each with its launches nonzero
  train_cli      skip_train's CLI over the small memmap, then export_logits
                 serving the checkpoint it wrote; the same for
                 --ablation_type CrossAtt and for --fuse_layer 1
  watchtime      the watch-time CLI: --method ours at the flagship width
                 over the small memmap in the CLI's default config (fp32,
                 K1, layer remat, B=1024, one epoch; its K1f and K1b
                 launches counted against its steps and evaluation
                 batches), --method wlr, d2q and tpm at B=1024 (finite HR1
                 and MAE; their steps timed on a batch on the card; a
                 32-row fp32 step of each against the CPU); stats_eval and
                 export_statistics_logits here and in a process that sees
                 no card (the same bytes); build_interactions,
                 build_segrec_data and build_leave_rank_data without
                 pandas, the built directory read back as the CSV's split
                 and trained by skip_train --path on the card
  msgpack        train_cli's flagship weights and AdamW state written in
                 the JAX package's .msgpack layout (optax's chain(clip,
                 adamw) state; bf16 PE tables and moments, one chunked
                 leaf) by a small encoder here, served by export_logits
                 --serving 1: the logits bit for bit those of a .pt of the
                 same weights; training resumed from each for 2 steps: the
                 losses bit for bit
  segrec         SegRec fed by Task 1: build_interactions and
                 build_segrec_data over the synthetic CSV, export_logits
                 --serving 1 of train_cli's checkpoint over the three
                 splits (20 K2f a batch), segrec.main side by side in six
                 processes: ClipWDRec, ClipDINRec, DIEN --alpha_aux 0.1 and
                 ClipCANRec (CTR, B=512, 1 epoch; finite AUC, LOG_LOSS,
                 WUAUC), ClipWDRec and ClipDINRec --model_mode TopK (one
                 epoch, evaluation batches of 128 rows x 100 candidates;
                 finite HR and NDCG, peak memory); meanwhile a 32-row fp32
                 step card against CPU of ClipWDRec, ClipDINRec, WideDeep
                 and DIN (interest weights of ones), of ClipWDRec and
                 ClipDINRec under Task 1's logits and of ClipDINRec under
                 them softmax-normalised (loss, gradient norm, evaluation
                 scores: 1e-6; ClipDINRec 1e-5), and of each context model
                 of segrec_models (1e-5, or 4x the CPU's step's own
                 fp32-vs-fp64 where that is more: DCNv2's crosses), each
                 beside the CPU's fp32 step against fp64; beside them too,
                 segrec_seq's 32-row ranking steps card against CPU of
                 each general and sequential model (1e-5, or 4x the CPU's
                 own fp32-vs-fp64); then ClipWDRec's and ClipDINRec's
                 steps and an evaluation batch at B=512 over a
                 3,920,483-row fp32 table (ms, interactions/s, peak
                 memory)
  segrec_models  SegRec's context models over phase segrec's table: FM,
                 DeepFM, AFM, xDeepFM, SAM, DCN, DCNv2, AutoInt, FinalMLP,
                 AdaGIN, DIEN, CAN, SDIM, ETA and the six Clip variants at
                 segrec.main's defaults (CTR, emb 64, B=512), DIEN and CAN
                 again with --alpha_aux 0.1: 10 steps timed after 2 and an
                 evaluation batch (ms, interactions/s, peak memory);
                 ClipDINRec's ranking evaluation at --eval_batch_size 512,
                 whether it fits
  segrec_seq     SegRec's general and sequential models, BPRMF through
                 S3Rec, at segrec.main's ranking defaults (emb 64, history
                 20, one negative, B=512) with their loss routes (their
                 CLI runs, --model_mode TopK for one epoch: SASRec, BPRMF
                 --test_all 1, BUIR, ContraRec, and S3Rec --s3rec_stage 1
                 then 2 --load 1 in one thread, with finite HR and NDCG,
                 go beside phases wide and train_cli; their 32-row checks
                 in phase segrec), and
                 S3Rec's and TiMiRec's pretrain stages: 10 steps timed
                 after 2 (ms, rows/s, peak memory), an evaluation batch of
                 512 rows x 100 candidates, a full-sort batch of 32 rows
                 (the target's two columns bit-equal); the host time of
                 SRGNN's and ContraRec's feeds
  segrec_runners SegRec's other runners at segrec.main's defaults (emb
                 64, B=512) over build_segrec_data --kg_meta 1's and
                 build_leave_rank_data's directories of the synthetic CSV:
                 CFKG's quadruple step, SLRCPlus, Chorus stage 1 and 2,
                 KDA with its DistMult term, the BPRMF and SASRec
                 impression rankers, PRM, SetRank (IMSAB, MSAB) and MIR
                 over a BPRMF ranker (BPRsession), SASRec under
                 --leave_rank 1: 10 steps timed after 2 (ms, rows/s, peak
                 memory), an evaluation batch; the host ms of SLRCPlus's,
                 Chorus's and KDA's feeds and of a CFKG epoch's negatives;
                 a 32-row fp32 step of each card against CPU (1e-5, or 4x
                 the CPU's own fp32-vs-fp64), beside phase segrec's CLIs;
                 segrec.main for one epoch (--leave_rank 1 on both
                 leave-rank datasets, BPRMF then PRM --model_mode
                 Impression, Chorus --stage 1 then --stage 2 --load 1, KDA
                 --include_attr 1: finite metrics) beside phases wide and
                 train_cli; no pandas
  mmrec          MMRec's graph recommenders at mmrec.main's defaults (emb
                 64, 64-d random features, --knn_k 10, B=2048) over
                 build_mmrec_data of the synthetic CSV (197,064 frames,
                 260,476 train pairs): BPR, LightGCN, LayerGCN, FREEDOM,
                 BM3, LATTICE, MMGCN and SLMRec, FREEDOM also with
                 --edge_dropout 0.1 and over a 197,064 x 1,025 feature
                 matrix: 10 steps timed after 2 (ms, train pairs/s, peak
                 memory); LATTICE's frozen global kNN graph built on the
                 card and its per-epoch rebuild; an evaluation of the dev
                 rows and an export of every row; one fp32 step of each
                 model on a small graph card against CPU (1e-5, or 4x the
                 CPU's own fp32-vs-fp64) and LATTICE's kNN graphs card
                 against CPU, beside phase segrec's CLIs; its data (a
                 process of its own at nice 19 from phase build on) and,
                 beside phases wide and train_cli, mmrec.main for one epoch
                 (FREEDOM --test_cold 1 --save_logits, LATTICE, BPR --grid
                 over lr) and tasks.exp over two seeds (one thread each, at
                 nice 19): finite metrics; no pandas
The last line is {"ok": true, "device": {...}}; before it come the card's
name and power limit (nvidia-smi) and one JSON line describing the kernels.
It needs no network and writes only under build/ (the kernels in
build/segmm_torch_kernels/, its data and checkpoints in build/chip_smoke/).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import itertools
import json
import logging
import math
import os
import shlex
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

D_MODEL, HEADS, FEAT_DIM = 512, 16, 1024
PRODUCTION_ROWS = 3_920_483          # SegMM segment count (bench.py:327)
# (Lq, L1, L2) of the four K1/K2 launches of one both/both layer
STREAM_SHAPES = ((40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1))
# (Lq, Lk) of the K3 launches: CrossAtt's four streams, SelfAtt's video one;
# bf16 also at the largest shape the kernel takes
K3_SHAPES = ((40, 100), (100, 40), (40, 1), (1, 40), (40, 40))
K3_MAX_SHAPE = (128, 128)
# libraries with tensor-core bodies: K3's bf16 ones on bf16 mma.sync, fp32
# K1f, K1b, K3f and K3b on TF32 mma.sync (3xTF32); phase build counts their
# HMMA instructions, and the TF32 ones among them, which each must hold
MMA_LIBS = ("two_block_attention", "masked_attention",
            "masked_attention_bwd", "two_block_attention_bwd")
# bf16 K2f and K2b, K4f and K4b, K6b and K5b run their projections, core,
# chain (and epilogue) on bf16 mma.sync: their libraries must hold bf16
# HMMA instructions (HMMA.16816.F32.BF16)
BF16_MMA_LIBS = ("proj_two_block_attention", "proj_two_block_attention_bwd",
                 "layer_stream", "layer_stream_bwd",
                 "proj_two_block_attention_v2_bwd", "dual_stream_attention_bwd")
HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# fp32 K1f, K1b, K3f and K3b run every product three times on the TF32
# tensor cores (495 TFLOP/s dense): their fp32 operations are priced at a
# third of it
TF32X3_FLOPS = 495e12 / 3
# fp32: the kernels and the plain versions sum the same products in other
# orders (projections over d=512 terms, softmax over <=200 keys): ~1e-6
# relative on O(1) outputs, 1e-4 leaves two orders of headroom.
# bf16: one bf16 ulp is 2^-8 relative (0.0156 at |x| in [2, 4)); a
# projection sum that rounds the other way moves a logit by ~one ulp, so
# the outputs may differ by a few ulps: atol 2e-2 + rtol 2e-2.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}
# gradients, as max |err| over max |want| per tensor. fp32: the same sums in
# another order, dW over up to 6,400 rows here (~1e-6 relative). bf16: the
# kernels recompute the projections and round them to bf16; a value that
# rounds the other way moves by one ulp (2^-8 relative) and carries into
# the gradients: 3e-2 is a few ulps.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DROP_RATE = 0.1                      # the model's dropout

RESULT = {"kernels": {}, "launches": {}}
ALL_PHASES = ("build", "kernels", "serving", "default", "train",
              "train_default", "train_bf16", "ablation", "fused_variants",
              "attn_v2", "wide", "train_cli", "watchtime", "msgpack",
              "segrec", "segrec_models", "segrec_seq", "segrec_runners",
              "mmrec")


def log(*a):
    print(*a, flush=True)


def _time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(name, got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max |err| {err.max().item():.3g}, atol {atol}, rtol {rtol})")
    return err.max().item()


# ---------------------------------------------------------------------------
def phase_build(ctx):
    """Build every library; each tensor-core library is disassembled as
    soon as it links, during the build's tail, when the last long compiles
    leave most cores idle. The last ones' disassembly goes on beside phase
    kernels, at the lowest priority; its check fails the run where
    _join_background reads it. Phase mmrec's host preparation starts here,
    at the lowest priority too."""
    from concurrent.futures import ThreadPoolExecutor

    from segmminterest_tpu_torch.core import build
    _start_mmrec_prep(ctx)
    t0 = time.perf_counter()
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    libs = {name: build._lib_path(name) for name in SASS_LIBS}
    sass = {}

    def stop():
        for proc, _ in sass.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()

    def check():
        try:
            _check_sass(sass)
        finally:
            stop()
    try:
        with ThreadPoolExecutor(1) as pool:
            built = pool.submit(build.build_all)
            while len(sass) < len(libs) and not built.done():
                _start_sass(cuobjdump, libs, sass)
                time.sleep(0.5)
            paths = built.result()
        log(f"build: {time.perf_counter() - t0:.1f} s")
        _start_sass(cuobjdump, libs, sass)
    except BaseException:
        stop()
        raise
    _in_background(ctx, "disassembly", check)
    for name, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
            elif "Compiling entry function" in line and name in MMA_LIBS:
                log(f"  ptxas {name}: {line.split('function', 1)[1].strip()}")
    for name, p in paths.items():
        parts = "; ".join(f"{f} {t:.1f}" for f, t in
                          build.part_seconds.get(name, {}).items())
        log(f"  built {os.path.relpath(p, ROOT)} in "
            f"{build.build_seconds.get(name, 0.0):.1f} s (each file done "
            f"at, s: {parts})")


# the tensor-core bodies: their libraries must hold HMMA (mma.sync)
# instructions of their kind, TF32 ones (HMMA.1688.F32.TF32) for the fp32
# bodies, BF16 ones for K2's, K4's, K5b's and K6b's. Each is disassembled
# by a process of its own, up to the first such instruction, before any
# phase times anything
SASS_LIBS = MMA_LIBS + BF16_MMA_LIBS


def _start_sass(cuobjdump, libs, sass):
    """Start the disassembly of each library of `libs` (name -> path) built
    by now."""
    for name, path in libs.items():
        if name in sass or not path.exists():
            continue
        kind = "BF16" if name in BF16_MMA_LIBS else "TF32"
        cmd = (f"{shlex.quote(cuobjdump)} -sass {shlex.quote(str(path))} | "
               f"grep -m 1 -E 'HMMA[.][0-9A-Z.]*{kind}'")
        # at the lowest priority: the build's last compiles go first
        sass[name] = (subprocess.Popen(
            ["nice", "-n", "19", "bash", "-c", cmd], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True), kind)


def _check_sass(sass):
    t0 = time.perf_counter()
    for name in SASS_LIBS:
        proc, kind = sass[name]
        first, err = proc.communicate(timeout=600)
        if proc.returncode or kind not in first:
            raise AssertionError(f"{name}: no {kind} HMMA instruction in "
                                 f"its library ({err[-400:]})")
        log(f"  {name}: {kind} HMMA instructions (cuobjdump -sass; the "
            f"first: {first.split(';')[0].split('*/')[-1].strip()})")
    log(f"disassembly: {time.perf_counter() - t0:.1f} s after the build, "
        "beside phase kernels")


def _masks(g, B, L, dev, allow_empty=True):
    lo = 0 if allow_empty else 1
    n = torch.randint(lo, L + 1, (B,), generator=g, device=dev)
    return torch.arange(L, device=dev)[None, :] < n[:, None]


def _k1_inputs(g, B, Lq, L1, L2, dt, dev, heads=HEADS, d=D_MODEL):
    def r(L):
        return torch.randn(B, L, heads, d // heads, generator=g,
                           device=dev).to(dt)
    return ((r(Lq), r(Lq), r(L1), r(L2), r(L1), r(L2)),
            (_masks(g, B, Lq, dev), _masks(g, B, L1, dev, False),
             _masks(g, B, L2, dev)))


def _k2_inputs(g, B, Lq, L1, L2, dt, dev, d=D_MODEL):
    def x(L):
        return torch.randn(B, L, d, generator=g, device=dev).to(dt)
    ws = []
    for _ in range(6):
        ws += [(torch.randn(d, d, generator=g, device=dev) / math.sqrt(d)
                ).to(dt), (0.1 * torch.randn(d, generator=g, device=dev)
                           ).to(dt)]
    return ((x(Lq), x(L1), x(L2)), ws,
            (_masks(g, B, Lq, dev), _masks(g, B, L1, dev, False),
             _masks(g, B, L2, dev)))


def _elem(dt):
    return torch.tensor([], dtype=dt).element_size()


def _rel_err(name, got, want, tol):
    """max |got - want| over max |want|, per tensor; fails above tol."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: output {i} is not finite")
        e = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, e)
    if worst > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max relative err {worst:.3g} > {tol})")
    return worst


def _grads(fn, inputs, g):
    """Gradients of fn(*inputs) . g with respect to the float inputs,
    through the wrapper's autograd.Function (the backward kernel)."""
    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(*leaves)
    diff = [t for t in leaves if t.requires_grad]
    return torch.autograd.grad(out, diff, g)


# fp32 K1b's and K3b's outputs on fp32_bwd_digest's inputs as the 3xTF32
# backward bodies that first shipped them write them on an H100 (nvcc 12.9,
# torch 2.11 + CUDA 12.8), hashed: a change to those bodies that moves any
# bit shows here
FP32_BWD_SHA256 = ("713c465dc5591c10e04205c7e2729eafbeeb799b7859bac9ed55dcb1"
                   "9abada3f")


def fp32_bwd_digest(A, dev):
    """SHA-256 of the gradients fp32 K1b and K3b write on fixed inputs
    (numpy seed 0, B=64, 16 heads of 32, padded rows, dropout off and on) at
    (40, 40, 100) and (1, 40, 1), and (40, 100) and (100, 40): equal on two
    trees whose backward bodies compute bit for bit the same."""
    rng = np.random.default_rng(0)
    B, Dh = 64, D_MODEL // HEADS
    h = hashlib.sha256()

    def on(a):
        return torch.from_numpy(a).to(dev)

    def masks(*lengths):
        out = []
        for L in lengths:
            n = rng.integers(1, L + 1, size=B)
            n[0] = 0 if L > 1 else n[0]  # a fully padded row
            out.append(on(np.arange(L)[None, :] < n[:, None]))
        return out
    cases = [(A.fused_two_block_attention, (Lq, Lq, L1, L2, L1, L2),
              masks(Lq, L1, L2), Lq)
             for Lq, L1, L2 in (STREAM_SHAPES[0], STREAM_SHAPES[3])]
    cases += [(A.fused_masked_attention, (Lq, Lk, Lk), masks(Lq, Lk), Lq)
              for Lq, Lk in K3_SHAPES[:2]]
    for fused, lengths, m, Lq in cases:
        x = [on(rng.standard_normal((B, L, HEADS, Dh), np.float32))
             for L in lengths + (Lq,)]
        for rate in (0.0, DROP_RATE):
            leaves = [t.detach().requires_grad_() for t in x[:-1]]
            out = fused(*leaves, *m, dropout_rate=rate, seed=77,
                        deterministic=rate == 0)
            for grad in torch.autograd.grad(out, leaves, x[-1]):
                h.update(grad.cpu().numpy().tobytes())
    return h.hexdigest()


def phase_kernels():
    from segmminterest_tpu_torch.core import attention as A
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(D_MODEL // HEADS)
    H, Dh, d = HEADS, D_MODEL // HEADS, D_MODEL

    def k1(qkv, m, rate=0.0, seed=0):
        return A.fused_two_block_attention(*qkv, *m, scale=scale,
                                           dropout_rate=rate, seed=seed,
                                           deterministic=rate == 0)

    def k1_plain(qkv, m, rate=0.0, seed=0):
        return A.two_block_attention_plain(*qkv, *m, scale, rate, seed)

    def k2(x, ws, m, rate=0.0, seed=0):
        return A.fused_proj_two_block_attention(
            *x, *ws, *m, num_heads=H, scale=scale, dropout_rate=rate,
            seed=seed, deterministic=rate == 0)

    def k2_plain(x, ws, m, rate=0.0, seed=0):
        return A.proj_two_block_attention_plain(*x, *ws, *m, H, scale, rate,
                                                seed)

    _k4_bodies(dev)
    _k6_k5_bodies(dev)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for (Lq, L1, L2) in STREAM_SHAPES:
            tag = f"{str(dt)[6:]} {(Lq, L1, L2)}"
            qkv, m = _k1_inputs(g, 64, Lq, L1, L2, dt, dev)
            x, ws, mx = _k2_inputs(g, 64, Lq, L1, L2, dt, dev)
            gq = torch.randn(64, Lq, H, Dh, generator=g, device=dev).to(dt)
            gx = gq.reshape(64, Lq, d)
            errs = {}
            for rate, seed in ((0.0, 0), (DROP_RATE, 1234567)):
                on = "drop" if rate else "eval"
                errs[f"K1f {on}"] = _check(
                    f"K1 {tag} {on}", k1(qkv, m, rate, seed),
                    k1_plain(qkv, m, rate, seed), dt)
                errs[f"K2f {on}"] = _check(
                    f"K2 {tag} {on}", k2(x, ws, m, rate, seed),
                    k2_plain(x, ws, m, rate, seed), dt)
                n = A.LAUNCHES["two_block_attention_bwd"]
                got = _grads(lambda *t: k1(t, m, rate, seed), qkv, gq)
                if A.LAUNCHES["two_block_attention_bwd"] != n + 1:
                    raise AssertionError("K1b did not launch")
                errs[f"K1b {on}"] = _rel_err(
                    f"K1b {tag} {on}", got, A.two_block_attention_bwd_plain(
                        *qkv, *m, gq, scale, rate, seed), BWD_TOL[dt])
                want = A.proj_two_block_attention_bwd_plain(
                    *x, *ws, *mx, gx, H, scale, rate, seed)
                for v3, key in ((False, "proj_two_block_attention_bwd"),
                                (True, "proj_two_block_attention_qkv_bwd")):
                    A.ATTN_V3_BWD = v3
                    n = A.LAUNCHES[key]
                    got = _grads(lambda *t: k2(t[:3], t[3:], mx, rate, seed),
                                 tuple(x) + tuple(ws), gx)
                    A.ATTN_V3_BWD = False
                    if A.LAUNCHES[key] != n + 1:
                        raise AssertionError(f"{key} did not launch")
                    name = "K7b" if v3 else "K2b"
                    errs[f"{name} {on}"] = _rel_err(f"{name} {tag} {on}",
                                                    got, want, BWD_TOL[dt])
            for k, v in errs.items():
                worst[k.split()[0]] = max(worst.get(k.split()[0], 0.0), v)
            log(f"  B=64 {tag}: " + ", ".join(f"{k} {v:.2g}"
                                              for k, v in errs.items()))
        # K1b with near-one-hot rows: q1 and q2 x50, logits of magnitude ~50
        qkv, m = _k1_inputs(g, 64, *STREAM_SHAPES[0], dt, dev)
        qkv = (50 * qkv[0], 50 * qkv[1]) + qkv[2:]
        gq = torch.randn(64, STREAM_SHAPES[0][0], H, Dh, generator=g,
                         device=dev).to(dt)
        errs = []
        for rate, seed in ((0.0, 0), (DROP_RATE, 1234567)):
            n = A.LAUNCHES["two_block_attention_bwd"]
            got = _grads(lambda *t: k1(t, m, rate, seed), qkv, gq)
            if A.LAUNCHES["two_block_attention_bwd"] != n + 1:
                raise AssertionError("K1b did not launch")
            errs.append(_rel_err(
                f"K1b {str(dt)[6:]} near-one-hot rate {rate}", got,
                A.two_block_attention_bwd_plain(*qkv, *m, gq, scale, rate,
                                                seed), BWD_TOL[dt]))
        worst["K1b"] = max(worst["K1b"], *errs)
        log(f"  B=64 {str(dt)[6:]} {STREAM_SHAPES[0]} q x50: K1b eval/drop "
            f"{errs[0]:.2g}/{errs[1]:.2g}")
    torch.cuda.synchronize()
    # the main path's largest launch: backbone1's video stream at B=1024;
    # K1 in fp32 (default config), K2 in bf16 (serving preset)
    B, (Lq, L1, L2) = 1024, STREAM_SHAPES[0]
    Lk = L1 + L2
    qkv, m = _k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
    err1 = _check("K1 B=1024", k1(qkv, m), k1_plain(qkv, m), torch.float32)
    gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev)
    A.reset_launch_counts()
    got = _grads(lambda *t: k1(t, m), qkv, gq)
    want = A.two_block_attention_bwd_plain(*qkv, *m, gq, scale)
    err1b = _rel_err("K1b B=1024", got, want, BWD_TOL[torch.float32])
    del got, want
    plain1 = _time_ms(lambda: k1_plain(qkv, m), 5)
    plain1b = _time_ms(lambda: A.two_block_attention_bwd_plain(
        *qkv, *m, gq, scale), 3)
    del qkv, m, gq
    # fp32 K1f and K1b by device time at the four stream shapes, beside
    # SDPA's forward and backward on the same inputs
    k1t = {s: _k1_device_times(A, g, dev, B, *s, scale)
           for s in STREAM_SHAPES}
    t = k1t[STREAM_SHAPES[0]]
    e = _elem(torch.float32)
    bytes1 = (e * B * H * Dh * (3 * Lq + 2 * L1 + 2 * L2)
              + 4 * B * (Lq + L1 + L2))
    flops1 = 4.0 * B * H * Lq * Lk * Dh
    # fp32 K1f, K1b: every product three times on the TF32 tensor cores
    _record("K1", "two_block_attention_fwd (K1f)",
            "two_block_attention.cu", 527, err1, t["k1f"], plain1, bytes1,
            flops1 / TF32X3_FLOPS, t["sdpa"])
    bytes1b = (e * B * H * Dh * (5 * Lq + 4 * L1 + 4 * L2)
               + 4 * B * (Lq + L1 + L2))
    flops1b = 10.0 * B * H * Lq * Lk * Dh
    _record("K1b", "two_block_attention_bwd (K1b)",
            "two_block_attention_bwd.cu", 558, err1b, t["k1b"], plain1b,
            bytes1b, flops1b / TF32X3_FLOPS, t["sdpa_bwd"])
    log(f"  K1 fp32 B=1024 {(Lq, L1, L2)}: plain K1f {plain1:.3f} ms, plain "
        f"K1b {plain1b:.3f} ms; max|err| K1f {err1:.3g}, max rel err K1b "
        f"{err1b:.3g}")
    for (sq, s1, s2), t in k1t.items():
        rows = B * (sq + s1 + s2)
        bf = e * B * H * Dh * (3 * sq + 2 * s1 + 2 * s2) + 4 * rows
        of = 4.0 * B * H * sq * (s1 + s2) * Dh / TF32X3_FLOPS
        b1 = e * B * H * Dh * (5 * sq + 4 * s1 + 4 * s2) + 4 * rows
        o1 = 10.0 * B * H * sq * (s1 + s2) * Dh / TF32X3_FLOPS
        log(f"  K1 fp32 B=1024 {(sq, s1, s2)}, device ms: K1f "
            f"{_ms(t['k1f'])}, dropout {_ms(t['k1f_drop'])} (sdpa "
            f"{_ms(t['sdpa'])}; bound "
            f"{1e3 * max(bf / HBM_BYTES_PER_S, of):.3f}), K1b "
            f"{_ms(t['k1b'])} (sdpa backward {_ms(t['sdpa_bwd'])}; bound "
            f"{1e3 * max(b1 / HBM_BYTES_PER_S, o1):.3f}); sdpa kernels "
            f"{t['sdpa_kernels']}")
    _k1_bf16_kernels(A, g, dev, k1, k1_plain, scale)

    x, ws, m = _k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
    err2 = _check("K2 B=1024", k2(x, ws, m), k2_plain(x, ws, m),
                  torch.bfloat16)
    ms2 = _device_ms(lambda: k2(x, ws, m), 10, K2_NAMES) \
        or _time_ms(lambda: k2(x, ws, m), 10)
    plain2 = _time_ms(lambda: k2_plain(x, ws, m), 5)
    e = _elem(torch.bfloat16)
    n_rows = 2 * Lq + 2 * L1 + 2 * L2     # rows through the six projections
    proj_flops = 2.0 * B * d * d * n_rows
    bytes2 = (e * (B * d * (2 * Lq + L1 + L2) + 6 * (d * d + d))
              + 4 * B * (Lq + L1 + L2))
    flops2 = proj_flops + 4.0 * B * Lq * Lk * d
    _record("K2", "proj_two_block_attention_fwd (K2f)",
            "proj_two_block_attention.cu", 776, err2, ms2, plain2, bytes2,
            flops2 / PEAK_FLOPS[torch.bfloat16], None)
    log(f"  K2f bf16 B=1024 {(Lq, L1, L2)}: {ms2:.3f} ms (plain "
        f"{plain2:.3f}) max|err| {err2:.3g}")

    # K2b (and K7b), bf16, B=1024
    gx = torch.randn(B, Lq, d, generator=g, device=dev).to(torch.bfloat16)
    inputs = tuple(x) + tuple(ws)
    want = A.proj_two_block_attention_bwd_plain(*x, *ws, *m, gx, H, scale)
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = k2(leaves[:3], leaves[3:], m)

    def k2b():
        return torch.autograd.grad(out, leaves, gx, retain_graph=True)
    timed = {}
    for v3, name in ((False, "K2b"), (True, "K7b")):
        A.ATTN_V3_BWD = v3
        got = k2b()
        # K2b's own kernels; K7b's are its qkv pass (its dx and dW are
        # torch.matmul)
        names = K2_NAMES if not v3 else K2_NAMES[:2]
        timed[name] = (_rel_err(f"{name} B=1024", got, want,
                                BWD_TOL[torch.bfloat16]),
                       _device_ms(k2b, 5, names) or _time_ms(k2b, 5))
        if not v3:
            # dW and db are summed in row chunks added in order: a second
            # call gives the same bits
            again = k2b()
            if not all(torch.equal(a, b) for a, b in zip(got[3:], again[3:])):
                raise AssertionError("K2b: dW or db differ between two calls")
            log("  K2b B=1024: dW and db bit-equal across two calls")
            del again
        A.ATTN_V3_BWD = False
        del got
    plain2b = _time_ms(lambda: A.proj_two_block_attention_bwd_plain(
        *x, *ws, *m, gx, H, scale), 3)
    # K2b: the recomputed projections and QK^T on the bf16 tensor cores (q
    # and k are bf16); the core's dV = p^T g, dQ = dl k and dK = dl^T q
    # with p and dl as bf16 hi + lo halves (two products each), dP = g v^T
    # one; dx and dW with dy in three bf16 parts (three products each): all
    # at the bf16 tensor-core rate (989 TFLOP/s). Reads x, W, g once,
    # writes dx, dW, db once.
    recompute = proj_flops + 2.0 * B * Lq * Lk * d
    core_flops = 7 * 2.0 * B * Lq * Lk * d
    bytes2b, ops2b = k2b_cost(B, Lq, L1, L2)
    _record("K2b", "proj_two_block_attention_bwd (K2b)",
            "proj_two_block_attention_bwd.cu", 808, timed["K2b"][0],
            timed["K2b"][1], plain2b, bytes2b, ops2b, None)
    # K7b does the recompute and the core; dx and dW are torch.matmul
    ops7b = (recompute + core_flops) / PEAK_FLOPS[torch.bfloat16]
    bytes7b = (e * (B * d * (Lq + L1 + L2) + B * Lq * d + 6 * (d * d + d))
               + 4 * B * d * n_rows // 2 + 4 * B * (Lq + L1 + L2))
    _record("K7b", "proj_two_block_attention_qkv_bwd (K7b)",
            "proj_two_block_attention_bwd.cu", 1568, timed["K7b"][0],
            timed["K7b"][1], plain2b, bytes7b, ops7b, None)
    log(f"  K2b bf16 B=1024 {(Lq, L1, L2)}: {timed['K2b'][1]:.3f} ms, K7b "
        f"(qkv pass) {timed['K7b'][1]:.3f} ms (plain {plain2b:.3f}); max "
        f"rel err K2b {timed['K2b'][0]:.3g}, K7b {timed['K7b'][0]:.3g}")
    del leaves, out, want
    # every launch shape of a layer, kernel by kernel, by device time:
    # K2f's projections and core, K2b's qkv pass and chain
    for (sq, s1, s2) in STREAM_SHAPES:
        x, ws, m = _k2_inputs(g, B, sq, s1, s2, torch.bfloat16, dev)
        gx = torch.randn(B, sq, d, generator=g, device=dev).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_()
                  for t in tuple(x) + tuple(ws)]
        for rate in (0.0, DROP_RATE):
            out = k2(leaves[:3], leaves[3:], m, rate, 5)
            rows = {}
            for what, fn, n in (
                    ("K2f", lambda: k2(x, ws, m, rate, 5), 10),
                    ("K2b", lambda: torch.autograd.grad(
                        out, leaves, gx, retain_graph=True), 5)):
                ks = {k.split("(")[0].split("<")[0][-40:]: v
                      for k, v in _device_kernels(fn, n).items()
                      if any(nm in k for nm in K2_NAMES)}
                rows[what] = (sum(ks.values()), ks)
            log(f"  B=1024 {(sq, s1, s2)} rate {rate}, device ms: K2f "
                f"{rows['K2f'][0]:.3f} {rows['K2f'][1]}, K2b "
                f"{rows['K2b'][0]:.3f} {rows['K2b'][1]}")
            del out
        del leaves, x, ws, m, gx

    _k3_kernels(A, g, dev)
    _k5_kernels(A, g, dev)
    _k4_kernels(A, g, dev)
    # K6 computes K2's function: K2f's bound, and K2b's, as bf16 K6b runs on
    # K2b's bodies
    _k6_kernels(A, g, dev, (bytes2, flops2 / PEAK_FLOPS[torch.bfloat16]),
                (bytes2b, ops2b))
    _wide_kernels(A, dev)
    _long_kernels(A, dev)
    digest = fp32_bwd_digest(A, dev)
    log(f"  fp32 K1b + K3b outputs, SHA-256: {digest}")
    if digest != FP32_BWD_SHA256:
        raise AssertionError("fp32 K1b / K3b outputs differ from those of "
                             f"their bodies' tree ({FP32_BWD_SHA256})")
    A.reset_launch_counts()


# ---------------------------------------------------------------------------
# Streams past the cores' one-chunk shapes and K4 past its epilogues' widths:
# every kernel takes every length (the two cores' key-chunk paths,
# csrc/two_block_chunked.cu and csrc/tf32_chunked.cu) and K4 every width (the
# row-tile epilogue, fewer rows a block as the width grows)
LONG_SHAPES = ((200, 150, 300), (1, 300, 7))
# K6's version 2 needs a block whose length is a multiple of 8
LONG_K6_SHAPE = (200, 152, 300)
LONG_K3_SHAPES = ((200, 300), (1, 300), (128, 128))
LONG_D = {32: 256, 128: 256}    # head dim: d_model (8 heads of 32, 2 of 128)
LONG_KERNELS = ("K1", "K2", "K6", "K3", "K4", "K5")
# K4 at d = ff = 1024 (16 heads of 64), past bf16's 768 and fp32's 512
WIDE_LAYER = (1024, 16, (40, 40, 100))


def _long_kernels(A, dev, B=2, dtypes=(torch.float32, torch.bfloat16),
                  rates=(0.0, DROP_RATE), kernels=LONG_KERNELS):
    """Each kernel of `kernels` at streams past the cores' one-chunk shapes
    (K1, K2 with K7b, K6, K5 and K4 at LONG_SHAPES, K3 at LONG_K3_SHAPES),
    head dims 32 and 128, B=2, in each dtype and dropout rate, against its
    plain version; K1b's and K3b's gradients bit-equal across two calls
    where the query windows apply (Lq = 200: four windows); K4 also at
    WIDE_LAYER's d = ff = 1024. Returns the worst error of each kernel and
    dtype."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    from segmminterest_tpu_torch.core import layer_kernel as K4
    g = torch.Generator(device=dev).manual_seed(13)
    worst = {}

    def note(key, dt, err):
        key = f"{key} {str(dt)[6:]}"
        worst[key] = max(worst.get(key, 0.0), err)

    def grads_of(fn, inputs, gout, name, key):
        n = A.LAUNCHES[key]
        got = _grads(fn, inputs, gout)
        if A.LAUNCHES[key] != n + 1:
            raise AssertionError(f"{name} did not launch {key}")
        return got

    def same_twice(fn, inputs, gout, got, name):
        if not all(torch.equal(a, b) for a, b in
                   zip(got, _grads(fn, inputs, gout))):
            raise AssertionError(f"{name}: two calls differ")

    def k4_check(name, got, want, dt):
        # bf16 against the largest output, as _k4_kernels holds it
        if dt == torch.float32:
            return _check(name, got, want, dt)
        return _rel_err(name, [got], [want], BWD_TOL[dt])

    def k4_case(dt, H, d, shape, rate, seed, tag):
        t4, m4 = _k4_inputs(g, B, *shape, dt, dev, ff=d, d=d)
        gx = torch.randn(B, shape[0], d, generator=g, device=dev).to(dt)
        scale = 1.0 / math.sqrt(d // H)

        def k4(*t):
            return K4.fused_layer_stream(
                *t[:3], _pairs(t[3:15]), t[15:], *m4, num_heads=H,
                scale=scale, dropout_rate=rate, seed=seed,
                deterministic=rate == 0)
        note("K4f", dt, k4_check(f"K4f {tag}", k4(*t4), K4.layer_stream_plain(
            *t4[:3], t4[3:15], t4[15:], *m4, H, scale, rate, seed), dt))
        got = grads_of(k4, t4, gx, "K4b", "layer_stream_bwd")
        note("K4b", dt, _rel_err(f"K4b {tag}", got, K4.layer_stream_bwd_plain(
            *t4[:3], t4[3:15], t4[15:], *m4, gx, H, scale, rate, seed),
            BWD_TOL[dt]))

    for dt in dtypes:
        for D, d in LONG_D.items():
            H = d // D
            scale = 1.0 / math.sqrt(D)
            for rate in rates:
                seed = 97531 if rate else 0
                on = "drop" if rate else "eval"
                for (Lq, L1, L2) in LONG_SHAPES:
                    tag = f"{str(dt)[6:]} D={D} {(Lq, L1, L2)} {on}"
                    qkv, m = _k1_inputs(g, B, Lq, L1, L2, dt, dev, H, d)
                    gq = torch.randn(B, Lq, H, D, generator=g,
                                     device=dev).to(dt)

                    def k1(*t):
                        return A.fused_two_block_attention(
                            *t, *m, scale=scale, dropout_rate=rate,
                            seed=seed, deterministic=rate == 0)
                    if "K1" in kernels:
                        note("K1f", dt, _check(
                            f"K1f {tag}", k1(*qkv), A.two_block_attention_plain(
                                *qkv, *m, scale, rate, seed), dt))
                        got = grads_of(k1, qkv, gq, "K1b",
                                       "two_block_attention_bwd")
                        note("K1b", dt, _rel_err(
                            f"K1b {tag}", got, A.two_block_attention_bwd_plain(
                                *qkv, *m, gq, scale, rate, seed),
                            BWD_TOL[dt]))
                        same_twice(k1, qkv, gq, got, f"K1b {tag}")
                    gx = gq.reshape(B, Lq, d)
                    for name in ("K2", "K6"):
                        if name not in kernels or (
                                name == "K6" and (Lq, L1, L2) != LONG_SHAPES[0]):
                            continue
                        v2 = name == "K6"
                        x, ws, mx = _k2_inputs(
                            g, B, *(LONG_K6_SHAPE if v2 else (Lq, L1, L2)), dt,
                            dev, d)
                        plain = (A.proj_two_block_attention_v2_plain if v2
                                 else A.proj_two_block_attention_plain)
                        plain_b = (A.proj_two_block_attention_v2_bwd_plain if v2
                                   else A.proj_two_block_attention_bwd_plain)

                        def k2(*t):
                            return A.fused_proj_two_block_attention(
                                *t[:3], *t[3:], *mx, num_heads=H, scale=scale,
                                dropout_rate=rate, seed=seed,
                                deterministic=rate == 0,
                                version=2 if v2 else 1)
                        inputs = tuple(x) + tuple(ws)
                        note(f"{name}f", dt, _check(
                            f"{name}f {tag}", k2(*inputs),
                            plain(*x, *ws, *mx, H, scale, rate, seed), dt))
                        want = plain_b(*x, *ws, *mx, gx, H, scale, rate, seed)
                        key = ("proj_two_block_attention_v2_bwd" if v2
                               else "proj_two_block_attention_bwd")
                        note(f"{name}b", dt, _rel_err(
                            f"{name}b {tag}", grads_of(k2, inputs, gx,
                                                       f"{name}b", key),
                            want, BWD_TOL[dt]))
                        if not v2:
                            A.ATTN_V3_BWD = True
                            try:
                                got = grads_of(
                                    k2, inputs, gx, "K7b",
                                    "proj_two_block_attention_qkv_bwd")
                            finally:
                                A.ATTN_V3_BWD = False
                            note("K7b", dt, _rel_err(f"K7b {tag}", got, want,
                                                     BWD_TOL[dt]))
                    if "K4" in kernels:  # d = ff on the same streams
                        k4_case(dt, H, d, (Lq, L1, L2), rate, seed, tag)
                if "K5" in kernels:  # video 150, user 300
                    Lv, Lu = LONG_SHAPES[0][1:]
                    t5 = [torch.randn(B, L, d, generator=g, device=dev).to(dt)
                          for L in (Lv, Lu)] + _proj_weights(g, d, 12, dt,
                                                             dev)
                    m5 = (_masks(g, B, Lv, dev, False), _masks(g, B, Lu, dev))
                    gs = tuple(torch.randn(B, L, d, generator=g,
                                           device=dev).to(dt)
                               for L in (Lv, Lu))

                    def k5(*t):
                        return K5.fused_dual_stream_attention(
                            t[0], t[1], _pairs(t[2:14]), _pairs(t[14:26]),
                            *m5, num_heads=H, scale=scale, dropout_rate=rate,
                            seed=seed, deterministic=rate == 0)
                    tag = f"{str(dt)[6:]} D={D} {(Lv, Lu)} {on}"
                    want = K5.dual_stream_attention_plain(
                        t5[0], t5[1], t5[2:14], t5[14:26], *m5, H, scale,
                        rate, seed)
                    note("K5f", dt, max(_check(f"K5f {tag} {s_}", a_, b_, dt)
                                        for s_, a_, b_ in zip("vu", k5(*t5),
                                                              want)))
                    note("K5b", dt, _rel_err(
                        f"K5b {tag}",
                        grads_of(k5, t5, gs, "K5b", "dual_stream_attention_bwd"),
                        K5.dual_stream_attention_bwd_plain(
                            t5[0], t5[1], t5[2:14], t5[14:26], *m5, *gs, H,
                            scale, rate, seed), BWD_TOL[dt]))
                for (Lq, Lk) in LONG_K3_SHAPES if "K3" in kernels else ():
                    tag = f"{str(dt)[6:]} D={D} {(Lq, Lk)} {on}"
                    q, k, v = (torch.randn(B, L, H, D, generator=g,
                                           device=dev).to(dt)
                               for L in (Lq, Lk, Lk))
                    mq, mk = _masks(g, B, Lq, dev), _masks(g, B, Lk, dev,
                                                           False)
                    g3 = torch.randn(B, Lq, H, D, generator=g,
                                     device=dev).to(dt)

                    def k3(*t):
                        return A.fused_masked_attention(
                            *t, mq, mk, scale=scale, dropout_rate=rate,
                            seed=seed, deterministic=rate == 0)
                    note("K3f", dt, _check(f"K3f {tag}", k3(q, k, v),
                                           A.masked_attention_plain(
                                               q, k, v, mq, mk, scale, rate,
                                               seed), dt))
                    got = grads_of(k3, (q, k, v), g3, "K3b",
                                   "masked_attention_bwd")
                    note("K3b", dt, _rel_err(f"K3b {tag}", got,
                                             A.masked_attention_bwd_plain(
                                                 q, k, v, mq, mk, g3, scale,
                                                 rate, seed), BWD_TOL[dt]))
                    same_twice(k3, (q, k, v), g3, got, f"K3b {tag}")
        if "K4" in kernels:
            d, H, shape = WIDE_LAYER
            for rate in rates:
                k4_case(dt, H, d, shape, rate, 97531 if rate else 0,
                        f"{str(dt)[6:]} d=ff={d} {shape} rate {rate}")
    torch.cuda.synchronize()
    log("  long streams and K4 at d = ff = 1024 (B=2, head dims 32 and 128, "
        "dropout off and on): " + ", ".join(f"{k} {v:.2g}"
                                            for k, v in worst.items()))
    return worst


# ---------------------------------------------------------------------------
# Head dims past the flagship's 32: d_model 768 with 16 and 8 heads (48, 96)
# and d_model 512 with 4 (128, skip_train --nhead 4)
WIDE_D = {48: 768, 96: 768, 128: 512}
WIDE_HEADS = 4  # the JSON line's widened entries: 4 heads of 128 at d 512


def _wide_kernels(A, dev):
    """Every kernel at head dims 48, 96 and 128 against its plain version,
    B=16, fp32 and bf16, dropout off and on, each call counting its launch:
    K1, K2 and K6 at the four stream shapes, K3 at CrossAtt's two and
    (100, 100), K5 on backbone 1's stream pair, K4 at (40, 40, 100) and
    (100, 40, 100) (bf16 also at d = ff = 768). Then at 4 heads of 128 and
    B=1024 the widened bodies' device times for the kernels JSON line
    (`_wide_timed`)."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    from segmminterest_tpu_torch.core import layer_kernel as K4
    g = torch.Generator(device=dev).manual_seed(12)
    Bw = 16
    worst = {}

    def ran(before, keys):
        for k in keys:
            if A.LAUNCHES[k] != before[k] + 1:
                raise AssertionError(f"{k} did not launch once")

    def note(name, dh, dt, err):
        key = (name, dh, str(dt)[6:])
        worst[key] = max(worst.get(key, 0.0), err)

    for dh, d in WIDE_D.items():
        H, scale = d // dh, 1.0 / math.sqrt(dh)
        for dt in (torch.float32, torch.bfloat16):
            for rate, seed in ((0.0, 0), (DROP_RATE, 2357)):
                tag = f"{str(dt)[6:]} head dim {dh} rate {rate}"
                for shape in STREAM_SHAPES:
                    qkv, m = _k1_inputs(g, Bw, *shape, dt, dev, H, d)
                    gq = torch.randn(Bw, shape[0], H, dh, generator=g,
                                     device=dev).to(dt)
                    before = dict(A.LAUNCHES)
                    out = A.fused_two_block_attention(
                        *qkv, *m, scale=scale, dropout_rate=rate, seed=seed,
                        deterministic=rate == 0)
                    got = _grads(lambda *t: A.fused_two_block_attention(
                        *t, *m, scale=scale, dropout_rate=rate, seed=seed,
                        deterministic=rate == 0), qkv, gq)
                    ran(before, ("two_block_attention_bwd",))
                    note("K1f", dh, dt, _check(
                        f"K1f {tag} {shape}", out,
                        A.two_block_attention_plain(*qkv, *m, scale, rate,
                                                    seed), dt))
                    note("K1b", dh, dt, _rel_err(
                        f"K1b {tag} {shape}", got,
                        A.two_block_attention_bwd_plain(
                            *qkv, *m, gq, scale, rate, seed), BWD_TOL[dt]))
                    x, ws, mx = _k2_inputs(g, Bw, *shape, dt, dev, d)
                    gx = torch.randn(Bw, shape[0], d, generator=g,
                                     device=dev).to(dt)
                    for v, name, plain, plain_b, keys in (
                            (1, "K2", A.proj_two_block_attention_plain,
                             A.proj_two_block_attention_bwd_plain, K2_KEYS),
                            (2, "K6", A.proj_two_block_attention_v2_plain,
                             A.proj_two_block_attention_v2_bwd_plain,
                             K6_KEYS)):
                        def k2(*t):
                            return A.fused_proj_two_block_attention(
                                *t, *mx, num_heads=H, scale=scale,
                                dropout_rate=rate, seed=seed,
                                deterministic=rate == 0, version=v)
                        before = dict(A.LAUNCHES)
                        out = k2(*x, *ws)
                        got = _grads(k2, tuple(x) + tuple(ws), gx)
                        ran(before, keys[1:])
                        note(f"{name}f", dh, dt, _check(
                            f"{name}f {tag} {shape}", out,
                            plain(*x, *ws, *mx, H, scale, rate, seed), dt))
                        note(f"{name}b", dh, dt, _rel_err(
                            f"{name}b {tag} {shape}", got, plain_b(
                                *x, *ws, *mx, gx, H, scale, rate, seed),
                            BWD_TOL[dt]))
                for Lq, Lk in K3_SHAPES[:2] + ((100, 100),):
                    q, k, v, gq = (torch.randn(Bw, L, H, dh, generator=g,
                                               device=dev).to(dt)
                                   for L in (Lq, Lk, Lk, Lq))
                    m = (_masks(g, Bw, Lq, dev), _masks(g, Bw, Lk, dev,
                                                        False))

                    def k3(*t):
                        return A.fused_masked_attention(
                            *t, *m, scale=scale, dropout_rate=rate,
                            seed=seed, deterministic=rate == 0)
                    before = dict(A.LAUNCHES)
                    out = k3(q, k, v)
                    got = _grads(k3, (q, k, v), gq)
                    ran(before, ("masked_attention_bwd",))
                    note("K3f", dh, dt, _check(
                        f"K3f {tag} {(Lq, Lk)}", out, A.masked_attention_plain(
                            q, k, v, *m, scale, rate, seed), dt))
                    note("K3b", dh, dt, _rel_err(
                        f"K3b {tag} {(Lq, Lk)}", got,
                        A.masked_attention_bwd_plain(q, k, v, *m, gq, scale,
                                                     rate, seed),
                        BWD_TOL[dt]))
                Lv, Lu = DUAL_SHAPE
                t = [torch.randn(Bw, L, d, generator=g, device=dev).to(dt)
                     for L in (Lv, Lu)] + _proj_weights(g, d, 12, dt, dev)
                m = (_masks(g, Bw, Lv, dev, False), _masks(g, Bw, Lu, dev))
                gs = tuple(torch.randn(Bw, L, d, generator=g, device=dev
                                       ).to(dt) for L in (Lv, Lu))

                def k5(*x):
                    return K5.fused_dual_stream_attention(
                        x[0], x[1], _pairs(x[2:14]), _pairs(x[14:26]), *m,
                        num_heads=H, scale=scale, dropout_rate=rate,
                        seed=seed, deterministic=rate == 0)
                before = dict(A.LAUNCHES)
                outs = k5(*t)
                got = _grads(k5, t, gs)
                ran(before, ("dual_stream_attention_bwd",))
                want = K5.dual_stream_attention_plain(
                    t[0], t[1], t[2:14], t[14:26], *m, H, scale, rate, seed)
                note("K5f", dh, dt, max(_check(f"K5f {tag}", a, b, dt)
                                        for a, b in zip(outs, want)))
                note("K5b", dh, dt, _rel_err(
                    f"K5b {tag}", got, K5.dual_stream_attention_bwd_plain(
                        t[0], t[1], t[2:14], t[14:26], *m, *gs, H, scale,
                        rate, seed), BWD_TOL[dt]))
                # K4 at d = ff = 512 (dh 128) and 768 (48, 96); fp32 at
                # d 384 past 512, where its row-tile epilogue fits
                d4 = d if dt == torch.bfloat16 or d <= 512 else 384
                for shape in STREAM_SHAPES[:2]:
                    t, m = _k4_inputs(g, Bw, *shape, dt, dev, ff=d4, d=d4)
                    gx = torch.randn(Bw, shape[0], d4, generator=g,
                                     device=dev).to(dt)

                    def k4(*x):
                        return K4.fused_layer_stream(
                            *x[:3], _pairs(x[3:15]), x[15:], *m,
                            num_heads=d4 // dh, scale=scale,
                            dropout_rate=rate, seed=seed,
                            deterministic=rate == 0)
                    before = dict(A.LAUNCHES)
                    out = k4(*t)
                    got = _grads(k4, t, gx)
                    ran(before, ("layer_stream_bwd",))
                    note("K4f", dh, dt, _rel_err(
                        f"K4f {tag} {shape}", [out], [K4.layer_stream_plain(
                            *t[:3], t[3:15], t[15:], *m, d4 // dh, scale,
                            rate, seed)], BWD_TOL[dt]))
                    note("K4b", dh, dt, _rel_err(
                        f"K4b {tag} {shape}", got, K4.layer_stream_bwd_plain(
                            *t[:3], t[3:15], t[15:], *m, gx, d4 // dh,
                            scale, rate, seed), BWD_TOL[dt]))
        torch.cuda.synchronize()
        log(f"  B={Bw} head dim {dh} (d {d}, {H} heads), fp32 / bf16, "
            "dropout off and on, worst: " + ", ".join(
                f"{n} {worst[n, dh, 'float32']:.2g} / "
                f"{worst[n, dh, 'bfloat16']:.2g}"
                for n in ("K1f", "K1b", "K2f", "K2b", "K6f", "K6b", "K3f",
                          "K3b", "K5f", "K5b", "K4f", "K4b")
                if (n, dh, "float32") in worst))
    _wide_timed(A, g, dev, worst)


def _wide_timed(A, g, dev, worst):
    """The widened bodies at 4 heads of 128 (d 512) and B=1024 by device
    time, at the shapes of the flagship's entries (K1, K2 and K6 at
    (40, 40, 100), K4 at (100, 40, 100), K3 at (40, 100), K5 on its stream
    pair), in the dtype of the configuration that runs each (K1 and K3
    fp32, the others bf16), beside their plain versions (and K1's and K3's
    beside SDPA's). Each bound is the flagship entry's, priced at the same
    shape: bytes and operations depend on d, not on how it is cut into
    heads. The entries' launches come from phase wide."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    from segmminterest_tpu_torch.core import layer_kernel as K4
    B, H, d = 1024, WIDE_HEADS, D_MODEL
    dh, scale = d // H, 1.0 / math.sqrt(d // H)
    (Lq, L1, L2) = STREAM_SHAPES[0]
    tag = f"{H} heads of {dh}"

    def record(key, flag, name, src, line, err, ms, plain_ms, lib):
        RESULT["kernels"][key] = dict(RESULT["kernels"][flag], name=name,
                                      max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, library_ms=lib)
        RESULT["kernels"][key]["source"] = \
            f"segmminterest_tpu_torch/core/csrc/{src}"
        log(f"  {key} B=1024: {_ms(ms)} ms (plain {plain_ms:.3f}, library "
            f"{_ms(lib)}, bound {RESULT['kernels'][key]['bound_ms']:.3f})")

    # K1, fp32
    t = _k1_device_times(A, g, dev, B, Lq, L1, L2, scale, H)
    qkv, m = _k1_inputs(g, B, Lq, L1, L2, torch.float32, dev, H)
    gq = torch.randn(B, Lq, H, dh, generator=g, device=dev)
    plain_f = _time_ms(lambda: A.two_block_attention_plain(*qkv, *m, scale),
                       3)
    plain_b = _time_ms(lambda: A.two_block_attention_bwd_plain(
        *qkv, *m, gq, scale), 2)
    del qkv, m, gq
    record("K1 D128", "K1", "two_block_attention_fwd (K1f, 4 heads of 128)",
           "two_block_attention.cu", 527, worst["K1f", 128, "float32"],
           t["k1f"], plain_f, t["sdpa"])
    record("K1b D128", "K1b", "two_block_attention_bwd (K1b, 4 heads of 128)",
           "two_block_attention_bwd.cu", 558, worst["K1b", 128, "float32"],
           t["k1b"], plain_b, t["sdpa_bwd"])
    # K3, fp32, beside SDPA's
    Lq3, Lk3 = K3_SHAPES[0]
    q, k, v, gq = (torch.randn(B, L, H, dh, generator=g, device=dev)
                   for L in (Lq3, Lk3, Lk3, Lq3))
    m = (_masks(g, B, Lq3, dev), _masks(g, B, Lk3, dev, False))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = A.fused_masked_attention(*leaves, *m, scale=scale)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    bias = torch.zeros(A._pair_mask(*m).shape, device=dev).masked_fill(
        ~A._pair_mask(*m), -10000.0)
    lib_out = sdpa(ql, kl, vl, attn_mask=bias, scale=scale)
    gl = gq.transpose(1, 2).contiguous()
    lib_f, _ = _sdpa_device(lambda: sdpa(ql.detach(), kl.detach(), vl.detach(),
                                         attn_mask=bias, scale=scale), 10)
    lib_b, _ = _sdpa_device(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), gl, retain_graph=True), 5)
    ms_f = _device_ms(lambda: A.fused_masked_attention(q, k, v, *m,
                                                       scale=scale), 10,
                      K3_NAMES[:1])
    ms_b = _device_ms(lambda: torch.autograd.grad(out, leaves, gq,
                                                  retain_graph=True), 5,
                      K3_NAMES[1:])
    plain_f = _time_ms(lambda: A.masked_attention_plain(q, k, v, *m, scale), 3)
    plain_b = _time_ms(lambda: A.masked_attention_bwd_plain(
        q, k, v, *m, gq, scale), 2)
    record("K3 D128", "K3", "masked_attention_fwd (K3f, fp32, 4 heads of "
           "128)", "masked_attention.cu", 126, worst["K3f", 128, "float32"],
           ms_f, plain_f, lib_f)
    record("K3b D128", "K3b", "masked_attention_bwd (K3b, fp32, 4 heads of "
           "128)", "masked_attention_bwd.cu", 156,
           worst["K3b", 128, "float32"], ms_b, plain_b, lib_b)
    del q, k, v, gq, leaves, out, ql, kl, vl, bias, lib_out, gl
    # K2 and K6, bf16
    dt = torch.bfloat16
    x, ws, m = _k2_inputs(g, B, Lq, L1, L2, dt, dev)
    gx = torch.randn(B, Lq, d, generator=g, device=dev).to(dt)
    for v, key, names, src, lines, plain, plain_bwd in (
            (1, "K2", K2_NAMES, "proj_two_block_attention", (776, 808),
             A.proj_two_block_attention_plain,
             A.proj_two_block_attention_bwd_plain),
            (2, "K6", K6_NAMES, "proj_two_block_attention_v2", (1198, 1253),
             A.proj_two_block_attention_v2_plain,
             A.proj_two_block_attention_v2_bwd_plain)):
        def fwd(*t):
            return A.fused_proj_two_block_attention(
                *t, *m, num_heads=H, scale=scale, version=v)
        leaves = [a.detach().requires_grad_() for a in tuple(x) + tuple(ws)]
        out = fwd(*leaves)
        ms_f = _device_ms(lambda: fwd(*x, *ws), 10, names)
        ms_b = _device_ms(lambda: torch.autograd.grad(
            out, leaves, gx, retain_graph=True), 5, names)
        plain_f = _time_ms(lambda: plain(*x, *ws, *m, H, scale), 3)
        plain_b = _time_ms(lambda: plain_bwd(*x, *ws, *m, gx, H, scale), 2)
        record(f"{key} D128", key, f"{src}_fwd ({key}f, bf16, {tag})",
               f"{src}.cu", lines[0], worst[f"{key}f", 128, "bfloat16"], ms_f,
               plain_f, None)
        record(f"{key}b D128", f"{key}b", f"{src}_bwd ({key}b, bf16, {tag})",
               f"{src}_bwd.cu", lines[1], worst[f"{key}b", 128, "bfloat16"],
               ms_b, plain_b, None)
        del leaves, out
    del x, ws, m, gx
    # K4, bf16, at the flagship K4 entry's shape
    t, m = _k4_inputs(g, B, *STREAM_SHAPES[1], dt, dev)
    gx = torch.randn(B, STREAM_SHAPES[1][0], d, generator=g,
                     device=dev).to(dt)

    def k4(*x):
        return K4.fused_layer_stream(*x[:3], _pairs(x[3:15]), x[15:], *m,
                                     num_heads=H, scale=scale)
    leaves = [a.detach().requires_grad_() for a in t]
    out = k4(*leaves)
    ms_f = _device_ms(lambda: k4(*t), 5, K4_NAMES)
    ms_b = _device_ms(lambda: torch.autograd.grad(out, leaves, gx,
                                                  retain_graph=True), 3,
                      K4_NAMES)
    plain_f = _time_ms(lambda: K4.layer_stream_plain(
        *t[:3], t[3:15], t[15:], *m, H, scale), 2)
    plain_b = _time_ms(lambda: K4.layer_stream_bwd_plain(
        *t[:3], t[3:15], t[15:], *m, gx, H, scale), 2)
    record("K4 D128", "K4", f"layer_stream_fwd (K4f, bf16, {tag})",
           "layer_stream.cu", 140, worst["K4f", 128, "bfloat16"], ms_f,
           plain_f, None)
    record("K4b D128", "K4b", f"layer_stream_bwd (K4b, bf16, {tag})",
           "layer_stream_bwd.cu", 178, worst["K4b", 128, "bfloat16"], ms_b,
           plain_b, None)
    for e in ("K4 D128", "K4b D128"):
        RESULT["kernels"][e]["replaces"] = \
            RESULT["kernels"][e]["replaces"].replace("attention.py",
                                                     "layer_kernel.py")
    del t, m, gx, leaves, out
    # K5, bf16
    Lv, Lu = DUAL_SHAPE
    t = [torch.randn(B, L, d, generator=g, device=dev).to(dt)
         for L in (Lv, Lu)] + _proj_weights(g, d, 12, dt, dev)
    m = (_masks(g, B, Lv, dev, False), _masks(g, B, Lu, dev))
    gs = tuple(torch.randn(B, L, d, generator=g, device=dev).to(dt)
               for L in (Lv, Lu))

    def k5(*x):
        return K5.fused_dual_stream_attention(
            x[0], x[1], _pairs(x[2:14]), _pairs(x[14:26]), *m, num_heads=H,
            scale=scale)
    leaves = [a.detach().requires_grad_() for a in t]
    outs = k5(*leaves)
    ms_f = _device_ms(lambda: k5(*t), 5, K5_NAMES)
    ms_b = _device_ms(lambda: torch.autograd.grad(outs, leaves, gs,
                                                  retain_graph=True), 3,
                      K5_NAMES)
    plain_f = _time_ms(lambda: K5.dual_stream_attention_plain(
        t[0], t[1], t[2:14], t[14:26], *m, H, scale), 2)
    plain_b = _time_ms(lambda: K5.dual_stream_attention_bwd_plain(
        t[0], t[1], t[2:14], t[14:26], *m, *gs, H, scale), 2)
    record("K5 D128", "K5", f"dual_stream_attention_fwd (K5f, bf16, {tag})",
           "dual_stream_attention.cu", 68, worst["K5f", 128, "bfloat16"],
           ms_f, plain_f, None)
    record("K5b D128", "K5b", f"dual_stream_attention_bwd (K5b, bf16, {tag})",
           "dual_stream_attention_bwd.cu", 104, worst["K5b", 128, "bfloat16"],
           ms_b, plain_b, None)
    del t, m, gs, leaves, outs
    torch.cuda.empty_cache()


def _device_share(run, n, names):
    """Share of device time in the kernels whose names contain one of
    `names` over n calls of run(), and the device time per call, from a
    torch.profiler trace; None when the trace holds no device times."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' time
    total = part = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        total += t
        if any(k in e.key for k in names):
            part += t
    return (part / total, total / 1e3 / n) if total > 0 else None


def _device_ms(fn, iters, names=None):
    """Device time per call of fn() in the kernels whose names contain one
    of `names` (all kernels if None), from _device_share after a warm-up
    call; None when the trace holds no device times. Unlike CUDA events
    around the calls, it leaves out the host's time between launches, which
    a kernel of ~0.1 ms behind a Python wrapper would otherwise be timed
    by."""
    fn()
    torch.cuda.synchronize()
    share = _device_share(fn, iters, names or ("",))
    return None if share is None else share[0] * share[1]


def _device_kernels(fn, iters):
    """Device ms per call of fn() by kernel name (torch.profiler's kernel
    rows, after a warm-up call); {} when the trace holds no device
    times."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if "CUDA" in str(getattr(e, "device_type", "")) and t > 0:
            out[e.key] = t / 1e3 / iters
    return out


def _sdpa_device(fn, iters):
    """SDPA's device ms per call (every kernel of the call) and the names
    of its kernels, the heaviest first."""
    rows = _device_kernels(fn, iters)
    if not rows:
        return None, []
    names = sorted(rows, key=rows.get, reverse=True)
    return sum(rows.values()), [n[:80] for n in names]


def _k1_device_times(A, g, dev, B, Lq, L1, L2, scale, heads=HEADS,
                     dt=torch.float32):
    """K1f (fp32 by default; dropout off and on) and K1b at one stream
    shape by device time (the kernels' own, not the wrapper's), beside
    SDPA's forward and backward over the concat construction
    (attention.py:362-371) with an additive -10000 mask; SDPA is never
    called by the port, and unlike K1 it does not give padded query rows
    the uniform softmax."""
    qkv, m = _k1_inputs(g, B, Lq, L1, L2, dt, dev, heads)
    q1, q2, kk1, kk2, v1, v2 = qkv
    gq = torch.randn(B, Lq, heads, D_MODEL // heads, generator=g,
                     device=dev).to(dt)
    leaves = [t.detach().requires_grad_() for t in qkv]
    out = A.fused_two_block_attention(*leaves, *m, scale=scale)
    qc = torch.cat([q1, q2], -1).transpose(1, 2).requires_grad_()
    kc = torch.cat([torch.cat([kk1, torch.zeros_like(kk1)], -1),
                    torch.cat([torch.zeros_like(kk2), kk2], -1)],
                   1).transpose(1, 2).requires_grad_()
    vc = torch.cat([v1, v2], 1).transpose(1, 2).requires_grad_()
    pair = A._pair_mask(m[0], torch.cat([m[1], m[2]], 1))
    bias = torch.zeros(pair.shape, device=dev, dtype=dt).masked_fill(
        ~pair, -10000.0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qc, kc, vc, attn_mask=bias, scale=scale)
    gc = gq.transpose(1, 2)

    def sdpa_fwd():
        return sdpa(qc.detach(), kc.detach(), vc.detach(), attn_mask=bias,
                    scale=scale)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (qc, kc, vc), gc,
                                   retain_graph=True)

    def k1f():
        return A.fused_two_block_attention(*qkv, *m, scale=scale)

    def k1f_drop():
        return A.fused_two_block_attention(*qkv, *m, scale=scale,
                                           dropout_rate=DROP_RATE, seed=5,
                                           deterministic=False)

    def k1b():
        return torch.autograd.grad(out, leaves, gq, retain_graph=True)
    # CUDA events around the calls where the trace holds no device times
    ms_sdpa, _ = _sdpa_device(sdpa_fwd, 10)
    ms_sdpa_bwd, names = _sdpa_device(sdpa_bwd, 5)
    return dict(
        k1f=_device_ms(k1f, 10, K1F_NAMES) or _time_ms(k1f, 10),
        k1f_drop=_device_ms(k1f_drop, 10, K1F_NAMES)
        or _time_ms(k1f_drop, 10),
        k1b=_device_ms(k1b, 5, K1B_NAMES) or _time_ms(k1b, 5),
        sdpa=ms_sdpa or _time_ms(sdpa_fwd, 10),
        sdpa_bwd=ms_sdpa_bwd or _time_ms(sdpa_bwd, 5), sdpa_kernels=names[:3])


def _k1_bf16_kernels(A, g, dev, k1, k1_plain, scale, B=1024):
    """bf16 K1f and K1b (the default config in bf16: phase train_bf16) on
    the bf16 two-block core at B=1024: against their plain versions at
    (40, 40, 100), and by device time at the four stream shapes beside
    SDPA's bf16 forward and backward on the same inputs (the kernels line's
    library_ms); bounds at the bf16 rate."""
    bf, H, Dh = torch.bfloat16, HEADS, D_MODEL // HEADS
    Lq, L1, L2 = STREAM_SHAPES[0]
    qkv, m = _k1_inputs(g, B, Lq, L1, L2, bf, dev)
    gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev).to(bf)
    err = _check("K1 bf16 B=1024", k1(qkv, m), k1_plain(qkv, m), bf)
    errb = _rel_err("K1b bf16 B=1024", _grads(lambda *t: k1(t, m), qkv, gq),
                    A.two_block_attention_bwd_plain(*qkv, *m, gq, scale),
                    BWD_TOL[bf])
    plain = _time_ms(lambda: k1_plain(qkv, m), 5)
    plainb = _time_ms(lambda: A.two_block_attention_bwd_plain(
        *qkv, *m, gq, scale), 3)
    del qkv, m, gq
    e = _elem(bf)

    def cost(sq, s1, s2):
        """bytes and seconds at the bf16 rate, forward and backward"""
        rows, elems = B * (sq + s1 + s2), B * H * Dh
        ops = elems * sq * (s1 + s2) / PEAK_FLOPS[bf]
        return (e * elems * (3 * sq + 2 * s1 + 2 * s2) + 4 * rows, 4.0 * ops,
                e * elems * (5 * sq + 4 * s1 + 4 * s2) + 4 * rows, 10.0 * ops)
    for s in STREAM_SHAPES:
        t = _k1_device_times(A, g, dev, B, *s, scale, dt=bf)
        bf_, of, bb, ob = cost(*s)
        if s == STREAM_SHAPES[0]:
            _record("K1 bf16", "two_block_attention_fwd (K1f, bf16)",
                    "two_block_mma.cuh", 527, err, t["k1f"], plain, bf_, of,
                    t["sdpa"])
            _record("K1b bf16", "two_block_attention_bwd (K1b, bf16)",
                    "two_block_mma.cuh", 558, errb, t["k1b"], plainb, bb, ob,
                    t["sdpa_bwd"])
        log(f"  K1 bf16 B=1024 {s}, device ms: K1f {_ms(t['k1f'])}, dropout "
            f"{_ms(t['k1f_drop'])} (sdpa {_ms(t['sdpa'])}; bound "
            f"{1e3 * max(bf_ / HBM_BYTES_PER_S, of):.3f}), K1b "
            f"{_ms(t['k1b'])} (sdpa backward {_ms(t['sdpa_bwd'])}; bound "
            f"{1e3 * max(bb / HBM_BYTES_PER_S, ob):.3f})")
    log(f"  K1 bf16 B=1024 {(Lq, L1, L2)}: plain K1f {plain:.3f} ms, plain "
        f"K1b {plainb:.3f} ms; max|err| K1f {err:.3g}, max rel err K1b "
        f"{errb:.3g}")


def _k3_kernels(A, g, dev):
    """K3f and K3b against their plain versions at the ablations' (Lq, Lk)
    shapes, at K3_MAX_SHAPE and with near-one-hot rows, B=64, fp32 and
    bf16, dropout off and on, padded rows; then their device times at
    B=1024 on both of CrossAtt's feature streams, (40, 100) and (100, 40),
    beside SDPA's."""
    scale = 1.0 / math.sqrt(D_MODEL // HEADS)
    H, Dh = HEADS, D_MODEL // HEADS

    def inputs(B, Lq, Lk, dt, amp=1.0):
        def r(L, a=1.0):
            return (a * torch.randn(B, L, H, Dh, generator=g, device=dev)
                    ).to(dt)
        return ((r(Lq, amp), r(Lk), r(Lk)),
                (_masks(g, B, Lq, dev), _masks(g, B, Lk, dev, False)))

    def k3(qkv, m, rate=0.0, seed=0):
        return A.fused_masked_attention(*qkv, *m, scale=scale,
                                        dropout_rate=rate, seed=seed,
                                        deterministic=rate == 0)

    worst = {}  # (kernel, dtype) -> largest error over the B=64 checks
    for dt in (torch.float32, torch.bfloat16):
        # and the largest shape; near-one-hot rows below, in draws of their
        # own
        cases = [(s, 1.0) for s in K3_SHAPES] + [(K3_MAX_SHAPE, 1.0)]
        for (Lq, Lk), amp in cases:
            qkv, m = inputs(64, Lq, Lk, dt, amp)
            gq = torch.randn(64, Lq, H, Dh, generator=g, device=dev).to(dt)
            errs = []
            for rate, seed in ((0.0, 0), (DROP_RATE, 7654321)):
                on = "drop" if rate else "eval"
                tag = f"{str(dt)[6:]} {(Lq, Lk)} x{amp:g} {on}"
                errs.append(_check(f"K3f {tag}", k3(qkv, m, rate, seed),
                                   A.masked_attention_plain(
                                       *qkv, *m, scale, rate, seed), dt))
                n = A.LAUNCHES["masked_attention_bwd"]
                got = _grads(lambda *t: k3(t, m, rate, seed), qkv, gq)
                if A.LAUNCHES["masked_attention_bwd"] != n + 1:
                    raise AssertionError("K3b did not launch")
                errs.append(_rel_err(f"K3b {tag}", got,
                                     A.masked_attention_bwd_plain(
                                         *qkv, *m, gq, scale, rate, seed),
                                     BWD_TOL[dt]))
            for name, e in (("K3f", max(errs[0], errs[2])),
                            ("K3b", max(errs[1], errs[3]))):
                worst[name, dt] = max(worst.get((name, dt), 0.0), e)
            log(f"  B=64 {str(dt)[6:]} {(Lq, Lk)} q x{amp:g}: K3f eval/drop "
                f"{errs[0]:.2g}/{errs[2]:.2g}, K3b eval/drop "
                f"{errs[1]:.2g}/{errs[3]:.2g}")
        rows = k3_onehot(A, dev, dt)
        for name in ("K3f", "K3b"):
            worst[name, dt] = max(worst[name, dt],
                                  max(r[name] for r in rows))
        k3_onehot_hold(rows, dt)
    torch.cuda.synchronize()

    B = 1024
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for dt, shapes in ((torch.float32, K3_SHAPES[:2]),
                       (torch.bfloat16, K3_SHAPES[:2])):
        for (Lq, Lk) in shapes:
            qkv, m = inputs(B, Lq, Lk, dt)
            gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev).to(dt)
            err_f = _check(f"K3f B=1024 {dt} {(Lq, Lk)}", k3(qkv, m),
                           A.masked_attention_plain(*qkv, *m, scale), dt)
            got = _grads(lambda *t: k3(t, m), qkv, gq)
            err_b = _rel_err(f"K3b B=1024 {dt} {(Lq, Lk)}", got,
                             A.masked_attention_bwd_plain(*qkv, *m, gq,
                                                          scale),
                             BWD_TOL[dt])
            del got
            leaves = [t.detach().requires_grad_() for t in qkv]
            out = k3(leaves, m)

            def fwd():
                return k3(qkv, m)

            def bwd():
                return torch.autograd.grad(out, leaves, gq,
                                           retain_graph=True)
            ms_f, ms_b = _time_ms(fwd, 20), _time_ms(bwd, 10)
            plain_f = _time_ms(lambda: A.masked_attention_plain(
                *qkv, *m, scale), 5)
            plain_b = _time_ms(lambda: A.masked_attention_bwd_plain(
                *qkv, *m, gq, scale), 3)
            # yardstick: SDPA over (B, H, L, D) with an additive -10000 pair
            # mask (added after the scale, where K3 fills before it); never
            # called by the port
            ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in qkv)
            bias = torch.zeros(A._pair_mask(*m).shape, device=dev, dtype=dt
                               ).masked_fill(~A._pair_mask(*m), -10000.0)

            def lib_fwd():
                return sdpa(ql.detach(), kl.detach(), vl.detach(),
                            attn_mask=bias, scale=scale)
            lib_out = sdpa(ql, kl, vl, attn_mask=bias, scale=scale)
            gl = gq.transpose(1, 2).contiguous()

            def lib_bwd():
                return torch.autograd.grad(lib_out, (ql, kl, vl), gl,
                                           retain_graph=True)
            lib_f, lib_b = _time_ms(lib_fwd, 20), _time_ms(lib_bwd, 10)
            # the kernels' own device time, without the wrapper's host time
            dev_f = _device_ms(fwd, 20, K3_NAMES[:1])
            dev_fd = _device_ms(lambda: k3(qkv, m, DROP_RATE, 5), 20,
                                K3_NAMES[:1])
            dev_b = _device_ms(bwd, 10, K3_NAMES[1:])
            dlib_f, _ = _sdpa_device(lib_fwd, 20)
            dlib_b, names = _sdpa_device(lib_bwd, 10)
            timed[dt, (Lq, Lk)] = dict(
                err_f=err_f, err_b=err_b, ms_f=ms_f, ms_b=ms_b,
                plain_f=plain_f, plain_b=plain_b, lib_f=lib_f, lib_b=lib_b,
                dev_f=dev_f, dev_fd=dev_fd, dev_b=dev_b, dlib_f=dlib_f, dlib_b=dlib_b)
            log(f"  K3 {str(dt)[6:]} B=1024 {(Lq, Lk)}: K3f {ms_f:.3f} ms "
                f"(device {_ms(dev_f)}, dropout {_ms(dev_fd)}; plain "
                f"{plain_f:.3f}, sdpa "
                f"{lib_f:.3f}, device {_ms(dlib_f)}), K3b {ms_b:.3f} ms "
                f"(device {_ms(dev_b)}; plain {plain_b:.3f}, sdpa backward "
                f"{lib_b:.3f}, device {_ms(dlib_b)}); max err K3f "
                f"{err_f:.3g}, K3b {err_b:.3g}; sdpa backward kernels "
                f"{names[:3]}")
            del qkv, m, gq, leaves, out, ql, kl, vl, bias, lib_out, gl

    # bytes: K3f reads q, k, v and writes out; K3b reads q, k, v, g and
    # writes dq, dk, dv; both read the two masks (int32). fp32 K3f and K3b
    # run every product three times on the TF32 tensor cores
    def cost(dt, Lq, Lk):
        elems, e = B * H * Dh, _elem(dt)
        masks = 4 * B * (Lq + Lk)
        peak = TF32X3_FLOPS if dt == torch.float32 else PEAK_FLOPS[dt]
        return ((e * elems * (2 * Lq + 2 * Lk) + masks,
                 4.0 * B * H * Lq * Lk * Dh / peak),
                (e * elems * (3 * Lq + 4 * Lk) + masks,
                 10.0 * B * H * Lq * Lk * Dh / peak))

    # both dtypes by the kernels' device time, beside SDPA's
    t = timed[torch.float32, K3_SHAPES[0]]
    (fb, fo), (bb, bo) = cost(torch.float32, *K3_SHAPES[0])
    _record("K3", "masked_attention_fwd (K3f, fp32)", "masked_attention.cu",
            126, max(worst["K3f", torch.float32], t["err_f"]),
            t["dev_f"] or t["ms_f"], t["plain_f"], fb, fo,
            t["dlib_f"] or t["lib_f"])
    _record("K3b", "masked_attention_bwd (K3b, fp32)",
            "masked_attention_bwd.cu", 156,
            max(worst["K3b", torch.float32], t["err_b"]),
            t["dev_b"] or t["ms_b"], t["plain_b"], bb, bo,
            t["dlib_b"] or t["lib_b"])
    t = timed[torch.bfloat16, K3_SHAPES[0]]
    (fb, fo), (bb, bo) = cost(torch.bfloat16, *K3_SHAPES[0])
    _record("K3 bf16", "masked_attention_fwd (K3f, bf16)",
            "masked_attention.cu", 126,
            max(worst["K3f", torch.bfloat16], t["err_f"]),
            t["dev_f"] or t["ms_f"], t["plain_f"], fb, fo,
            t["dlib_f"] or t["lib_f"])
    _record("K3b bf16", "masked_attention_bwd (K3b, bf16)",
            "masked_attention_bwd.cu", 156,
            max(worst["K3b", torch.bfloat16], t["err_b"]),
            t["dev_b"] or t["ms_b"], t["plain_b"], bb, bo,
            t["dlib_b"] or t["lib_b"])
    for dt in (torch.float32, torch.bfloat16):
        for (Lq, Lk) in K3_SHAPES[:2]:
            (fb, fo), (bb, bo) = cost(dt, Lq, Lk)
            log(f"  K3 {str(dt)[6:]} bounds at B=1024 {(Lq, Lk)}: K3f "
                f"{1e3 * max(fb / HBM_BYTES_PER_S, fo):.3f} ms, K3b "
                f"{1e3 * max(bb / HBM_BYTES_PER_S, bo):.3f} ms")


# near-one-hot rows: K3's q scaled by 50 (logits ~50) at (40, 100), B=64,
# in ONEHOT_DRAWS draws of inputs, each from a generator of its own seeded
# ONEHOT_SEED + i, so that no other check moves them. There the fp32 plain
# version is itself ~7e-5 off the exact value (the logits' rounding, ~50 x
# an fp32 ulp, grows through exp), so fp32 K3f is held against the function
# in fp64 at TOL[float32]; bf16 K3f against its plain version at TOL[bf16].
ONEHOT_AMP, ONEHOT_DRAWS, ONEHOT_SEED = 50.0, 32, 5000


def _masked_f64(A, q, k, v, mask_q, mask_k, scale, rate, seed):
    """K3f's function in fp64 (the plain version's order of operations):
    the exact value both fp32 computations approximate."""
    pair = A._pair_mask(mask_q, mask_k)
    l = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    l = torch.where(pair, l, -10000.0)
    if rate > 0:
        B, Lq, H = q.shape[:3]
        keep = A.dropout_keep(B, H, Lq, k.shape[1], seed, 0, rate, q.device,
                              salt_stride=1)
        l = torch.where(keep, l / (1.0 - rate), 0.0)
    p = torch.softmax(l * scale, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double())


def k3_onehot(A, dev, dt):
    """K3f's and K3b's errors against their plain versions on near-one-hot
    rows, dropout off and on, one row a (draw, rate): K3f's largest |err|
    and whether every element is within TOL (`K3f ok`), K3b's largest error
    relative to each gradient's largest value, and the largest |err| of
    K3f and of the plain version against the function in fp64 (`K3f
    exact`, `plain exact`) with whether every element of K3f is within TOL
    of it (`K3f exact ok`). Holds nothing itself."""
    (Lq, Lk), B, H, Dh = K3_SHAPES[0], 64, HEADS, D_MODEL // HEADS
    scale = 1.0 / math.sqrt(Dh)
    atol, rtol = TOL[dt]
    rows = []
    for i in range(ONEHOT_DRAWS):
        g = torch.Generator(device=dev).manual_seed(ONEHOT_SEED + i)

        def r(L, a=1.0):
            return (a * torch.randn(B, L, H, Dh, generator=g, device=dev)
                    ).to(dt)
        qkv = (r(Lq, ONEHOT_AMP), r(Lk), r(Lk))
        m = (_masks(g, B, Lq, dev), _masks(g, B, Lk, dev, False))
        gq = r(Lq)
        for rate, seed in ((0.0, 0), (DROP_RATE, 7654321)):
            def k3(*t):
                return A.fused_masked_attention(
                    *t, *m, scale=scale, dropout_rate=rate, seed=seed,
                    deterministic=rate == 0)
            got = k3(*qkv).float()
            want = A.masked_attention_plain(*qkv, *m, scale, rate,
                                            seed).float()
            exact = _masked_f64(A, *qkv, *m, scale, rate, seed)

            def within(ref):
                return bool(torch.isfinite(got).all() and not (
                    (got - ref).abs() > atol + rtol * ref.abs()).any())
            err = (got - want).abs()
            gb = _grads(k3, qkv, gq)
            wb = A.masked_attention_bwd_plain(*qkv, *m, gq, scale, rate, seed)
            rel = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30)).item()
                      for a, b in zip(gb, wb))
            rows.append({"draw": i, "rate": rate, "K3f": err.max().item(),
                         "K3f ok": within(want), "K3b": rel,
                         "K3f exact": (got - exact).abs().max().item(),
                         "K3f exact ok": within(exact),
                         "plain exact": (want - exact).abs().max().item()})
    return rows


def k3_onehot_hold(rows, dt):
    """Log the near-one-hot draws and their worst errors; fail where a draw
    is past TOL (K3f: fp32 against the function in fp64, bf16 against the
    plain version) or BWD_TOL (K3b)."""
    tag = f"{str(dt)[6:]} {K3_SHAPES[0]} q x{ONEHOT_AMP:g}"
    log(f"  B=64 {tag}, {len(rows) // 2} draws, dropout off and on: worst "
        f"K3f {max(r['K3f'] for r in rows):.3g} against the plain version "
        f"({sum(not r['K3f ok'] for r in rows)} of {len(rows)} past TOL), "
        f"K3b {max(r['K3b'] for r in rows):.3g}; against fp64: K3f "
        f"{max(r['K3f exact'] for r in rows):.3g} "
        f"({sum(not r['K3f exact ok'] for r in rows)} past TOL), the plain "
        f"version {max(r['plain exact'] for r in rows):.3g}")
    fp32 = dt == torch.float32
    for r in rows:
        if not r["K3f exact ok" if fp32 else "K3f ok"]:
            raise AssertionError(
                f"K3f {tag} draw {r['draw']} rate {r['rate']}: kernel "
                f"disagrees with " + ("the function in fp64" if fp32 else
                                     "its plain version") + " (max |err| "
                f"{r['K3f exact' if fp32 else 'K3f']:.3g}, tolerance "
                f"{TOL[dt]})")
        if r["K3b"] > BWD_TOL[dt]:
            raise AssertionError(
                f"K3b {tag} draw {r['draw']} rate {r['rate']}: max relative "
                f"err {r['K3b']:.3g} > {BWD_TOL[dt]}")


def _ms(x):
    return "not measured" if x is None else f"{x:.3f}"


def _record(key, name, src, line, err, ms, plain_ms, nbytes, ops_s,
            library_ms, tpu_file="attention.py"):
    """One kernel's entry of the kernels JSON line; the bound is the larger
    of its bytes over the memory rate and its operations over the peak
    rate of their type (ops_s: seconds at those peaks)."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    RESULT["kernels"][key] = dict(
        name=name, route="cuda",
        source=f"segmminterest_tpu_torch/core/csrc/{src}",
        replaces=f"segmminterest_tpu/core/{tpu_file}:{line}",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(by_bytes, ops_s) * 1e3,
        bound_by="bytes" if by_bytes >= ops_s else "operations",
        library_ms=library_ms)


def _proj_weights(g, d, n, dt, dev):
    ws = []
    for _ in range(n):  # nn.Linear layout (out, in) + bias
        ws += [(torch.randn(d, d, generator=g, device=dev) / math.sqrt(d)
                ).to(dt), (0.1 * torch.randn(d, generator=g, device=dev)
                           ).to(dt)]
    return ws


def _pairs(ts):
    return [(ts[i], ts[i + 1]) for i in range(0, len(ts), 2)]


def _proj_flops(B, d, Lq, L1, L2):
    """The six projections of one K2-style stream (2Lq + 2L1 + 2L2 rows)."""
    return 2.0 * B * d * d * (2 * Lq + 2 * L1 + 2 * L2)


def k2b_ops(B, Lq, L1, L2, d=D_MODEL):
    """bf16 K2b's operations at one stream shape, as its bodies run them:
    the recomputed projections and q k^T once; the core's dv = p^T g,
    dq = dl k and dk = dl^T q with p and dl as bf16 hi + lo halves (two
    products each), dp = g v^T once; dx and dW with dy in three bf16 parts
    (three products each). All at the bf16 tensor-core rate."""
    proj, qk = _proj_flops(B, d, Lq, L1, L2), 2.0 * B * Lq * (L1 + L2) * d
    return proj + qk + 7 * qk + 3 * 2 * proj


def k2b_cost(B, Lq, L1, L2, d=D_MODEL):
    """bf16 K2b's bound at one stream shape: (bytes, seconds at the bf16
    rate). Reads x, W and g once; writes dx, fp32 dW and db once."""
    e = _elem(torch.bfloat16)
    nbytes = (e * (2 * B * d * (Lq + L1 + L2) + B * Lq * d + 6 * (d * d + d))
              + 4 * 6 * (d * d + d) + 4 * B * (Lq + L1 + L2))
    return nbytes, k2b_ops(B, Lq, L1, L2, d) / PEAK_FLOPS[torch.bfloat16]


def k5b_cost(B, Lv, Lu, d=D_MODEL):
    """bf16 K5b's bound on one stream pair: (bytes, seconds at the bf16
    rate): K2b's operations on the video stream (Lv, Lv, Lu) and the user
    stream (Lu, Lv, Lu); xv, xu, gv, gu and the 12 projections read once,
    dxv, dxu and the fp32 dW and db written once."""
    e = _elem(torch.bfloat16)
    rows, params = B * d * (Lv + Lu), 12 * (d * d + d)
    nbytes = e * (3 * rows + params) + 4 * params + 4 * B * (Lv + Lu)
    ops = k2b_ops(B, Lv, Lv, Lu, d) + k2b_ops(B, Lu, Lv, Lu, d)
    return nbytes, ops / PEAK_FLOPS[torch.bfloat16]


# K5 runs on backbone 1's stream pair: video 40 long, user 100 long
DUAL_SHAPE = (40, 100)


def _k5_kernels(A, g, dev):
    """K5f and K5b (both streams of a layer in one launch) against their
    plain versions on backbone 1's stream pair, B=64, fp32 and bf16,
    dropout off and on; then their times at B=1024 in bf16 (the dtype of
    the production config, which runs them)."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    H, d = HEADS, D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    Lv, Lu = DUAL_SHAPE

    def inputs(B, dt):
        xv = torch.randn(B, Lv, d, generator=g, device=dev).to(dt)
        xu = torch.randn(B, Lu, d, generator=g, device=dev).to(dt)
        return ([xv, xu] + _proj_weights(g, d, 12, dt, dev),
                (_masks(g, B, Lv, dev, False), _masks(g, B, Lu, dev)))

    def k5(t, m, rate=0.0, seed=0):
        return K5.fused_dual_stream_attention(
            t[0], t[1], _pairs(t[2:14]), _pairs(t[14:26]), *m, num_heads=H,
            scale=scale, dropout_rate=rate, seed=seed,
            deterministic=rate == 0)

    def plain(t, m, rate=0.0, seed=0):
        return K5.dual_stream_attention_plain(t[0], t[1], t[2:14], t[14:26],
                                              *m, H, scale, rate, seed)

    def plain_bwd(t, m, gs, rate=0.0, seed=0):
        return K5.dual_stream_attention_bwd_plain(
            t[0], t[1], t[2:14], t[14:26], *m, *gs, H, scale, rate, seed)

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        t, m = inputs(64, dt)
        gs = tuple(torch.randn(64, L, d, generator=g, device=dev).to(dt)
                   for L in (Lv, Lu))
        errs = {}
        for rate, seed in ((0.0, 0), (DROP_RATE, 2468013)):
            on = "drop" if rate else "eval"
            tag = f"{str(dt)[6:]} {DUAL_SHAPE} {on}"
            got, want = k5(t, m, rate, seed), plain(t, m, rate, seed)
            errs[f"K5f {on}"] = max(_check(f"K5f {tag} {s}", a, b, dt)
                                    for s, a, b in zip("vu", got, want))
            n = A.LAUNCHES["dual_stream_attention_bwd"]
            grads = _grads(lambda *x: k5(x, m, rate, seed), t, gs)
            if A.LAUNCHES["dual_stream_attention_bwd"] != n + 1:
                raise AssertionError("K5b did not launch")
            errs[f"K5b {on}"] = _rel_err(f"K5b {tag}", grads,
                                         plain_bwd(t, m, gs, rate, seed),
                                         BWD_TOL[dt])
        for k, v in errs.items():
            worst[k.split()[0]] = max(worst.get(k.split()[0], 0.0), v)
        log(f"  B=64 {str(dt)[6:]} {DUAL_SHAPE}: " + ", ".join(
            f"{k} {v:.2g}" for k, v in errs.items()))
    torch.cuda.synchronize()

    B, dt = 1024, torch.bfloat16
    t, m = inputs(B, dt)
    gs = tuple(torch.randn(B, L, d, generator=g, device=dev).to(dt)
               for L in (Lv, Lu))
    err_f = max(_check(f"K5f B=1024 {s}", a, b, dt)
                for s, a, b in zip("vu", k5(t, m), plain(t, m)))
    # by device time (CUDA events where the trace holds none), as K5b
    ms_f = _device_ms(lambda: k5(t, m), 10, K5_NAMES) \
        or _time_ms(lambda: k5(t, m), 10)
    plain_f = _time_ms(lambda: plain(t, m), 3)
    leaves = [x.detach().requires_grad_() for x in t]
    out = k5(leaves, m)
    got = torch.autograd.grad(out, leaves, gs, retain_graph=True)
    err_b = _rel_err("K5b B=1024", got, plain_bwd(t, m, gs), BWD_TOL[dt])

    def k5b():
        return torch.autograd.grad(out, leaves, gs, retain_graph=True)
    # dW and db are summed in row chunks added in order: a second call
    # gives the same bits
    again = k5b()
    if not all(torch.equal(a, b) for a, b in zip(got[2:], again[2:])):
        raise AssertionError("K5b: dW or db differ between two calls")
    log("  K5b B=1024: dW and db bit-equal across two calls")
    del got, again
    dev_b = _device_ms(k5b, 5, K5_NAMES)
    ms_b = dev_b or _time_ms(k5b, 5)
    plain_b = _time_ms(lambda: plain_bwd(t, m, gs), 2)
    e = _elem(dt)
    # the two streams: video (Lv, Lv, Lu), user (Lu, Lv, Lu)
    shapes = ((Lv, Lv, Lu), (Lu, Lv, Lu))
    proj = sum(_proj_flops(B, d, *s) for s in shapes)
    core_f = sum(4.0 * B * s[0] * (s[1] + s[2]) * d for s in shapes)
    rows, masks = B * d * (Lv + Lu), 4 * B * (Lv + Lu)
    params = 12 * (d * d + d)
    bytes_f = e * (2 * rows + params) + masks
    _record("K5", "dual_stream_attention_fwd (K5f)",
            "dual_stream_attention.cu", 68,
            max(worst["K5f"], err_f), ms_f, plain_f, bytes_f,
            (proj + core_f) / PEAK_FLOPS[dt], None, "dual_kernel.py")
    # bf16 K5b runs on K2b's bodies: K2b's pricing on both streams
    _record("K5b", "dual_stream_attention_bwd (K5b)",
            "dual_stream_attention_bwd.cu", 104, max(worst["K5b"], err_b),
            ms_b, plain_b, *k5b_cost(B, Lv, Lu), None, "dual_kernel.py")
    log(f"  K5 bf16 B=1024 {DUAL_SHAPE}: K5f {ms_f:.3f} ms (plain "
        f"{plain_f:.3f}), K5b {ms_b:.3f} ms (device {_ms(dev_b)}; plain "
        f"{plain_b:.3f}; bound {RESULT['kernels']['K5b']['bound_ms']:.3f}); "
        f"max err K5f {err_f:.3g}, K5b {err_b:.3g}")
    del t, m, gs, leaves, out
    torch.cuda.empty_cache()


def _k4_inputs(g, B, Lq, L1, L2, dt, dev, ff=D_MODEL, d=D_MODEL):
    """K4's inputs (at the flagship width by default): xq, x1, x2, the
    twelve projection parameters, the ten epilogue ones (each LayerNorm its
    own fp32 scale and bias), and the three masks."""
    xs = [torch.randn(B, L, d, generator=g, device=dev).to(dt)
          for L in (Lq, L1, L2)]

    def dense(n_out, n_in):
        return [(torch.randn(n_out, n_in, generator=g, device=dev)
                 / math.sqrt(n_in)).to(dt),
                (0.1 * torch.randn(n_out, generator=g, device=dev)).to(dt)]

    def ln():
        return [1 + 0.1 * torch.randn(d, generator=g, device=dev),
                0.1 * torch.randn(d, generator=g, device=dev)]

    ep = dense(d, d) + ln() + dense(ff, d) + dense(d, ff) + ln()
    return (xs + _proj_weights(g, d, 6, dt, dev) + ep,
            (_masks(g, B, Lq, dev), _masks(g, B, L1, dev, False),
             _masks(g, B, L2, dev)))


def _k4_bodies(dev):
    """Which bodies K4f and K4b ran, by the kernels' names in a profiler
    trace of a forward and backward: bf16 the tensor-core ones (k4_body
    "mma"), fp32 K2's fp32 route (the pair projections and K1's 3xTF32
    core) around the CUDA-core epilogue and chain (k4_body "tf32"). Runs
    first in phase kernels: later in
    the phase, after many traces, the profiler has returned traces with no
    kernel rows. Its inputs come from a generator of its own, so that the
    phase's other checks draw what they drew before it."""
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = HEADS, D_MODEL
    g = torch.Generator(device=dev).manual_seed(1)
    for dt, want, refuse in (
            (torch.bfloat16, ("qkv_gemm", "proj_two_block_core_fwd",
                              "proj_two_block_core_bwd",
                              "layer_epilogue_fwd_mma",
                              "layer_epilogue_bwd_mma", "chain_dx",
                              "chain_dw"), ()),
            (torch.float32, ("proj_pairs_f32", "two_block_fwd_tf32",
                             "two_block_bwd_tf32",
                             "layer_epilogue_fwd_kernel",
                             "layer_epilogue_bwd_kernel", "dx_kernel",
                             "dw_kernel"), ("_mma", "qkv_gemm", "chain_d"))):
        t, m = _k4_inputs(g, 64, *STREAM_SHAPES[0], dt, dev)
        gx = torch.randn(64, STREAM_SHAPES[0][0], d, generator=g,
                         device=dev).to(dt)

        def step():
            return _grads(lambda *x: K4.fused_layer_stream(
                *x[:3], _pairs(x[3:15]), x[15:25], *m, num_heads=H,
                dropout_rate=DROP_RATE, seed=3, deterministic=False), t, gx)
        names = " ".join(_device_kernels(step, 3))
        missing = [n for n in want if n not in names]
        if missing or any(n in names for n in refuse) or \
                K4.k4_body(dt) != ("mma" if dt == torch.bfloat16
                                   else "tf32"):
            raise AssertionError(f"K4 {dt}: body {K4.k4_body(dt)}, kernels "
                                 f"{names[:600]} (missing {missing})")
        log(f"  K4 {str(dt)[6:]}: {K4.k4_body(dt)} body, kernels "
            f"{', '.join(want)}")


def _k6_k5_bodies(dev):
    """Which bodies K6 and K5 ran, by the kernels' names in profiler traces
    of their forward and of their backward alone: bf16 K2's tensor-core
    ones (k6_body / k5_body "mma"; K5's two cores in
    dual_stream_core_fwd_kernel and dual_stream_core_bwd_kernel), fp32
    K2's fp32 route (the pair projections and K1's 3xTF32 core; k6_body /
    k5_body "tf32") and, backward, the CUDA-core chain. A generator of its
    own, as _k4_bodies."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.core import dual_kernel as K5
    H, d = HEADS, D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    g = torch.Generator(device=dev).manual_seed(2)
    mma = ("qkv_gemm", "chain_dx", "chain_dw")
    tf32 = ("proj_pairs_f32", "two_block_fwd_tf32")
    for dt in (torch.bfloat16, torch.float32):
        bf16 = dt == torch.bfloat16
        x, ws, m = _k2_inputs(g, 64, *STREAM_SHAPES[0], dt, dev)
        leaves = [t.detach().requires_grad_() for t in tuple(x) + tuple(ws)]
        out = A.fused_proj_two_block_attention(
            *leaves, *m, num_heads=H, scale=scale, dropout_rate=DROP_RATE,
            seed=3, deterministic=False, version=2)
        gx = torch.randn_like(out)
        k6 = " ".join(_device_kernels(lambda: torch.autograd.grad(
            out, leaves, gx, retain_graph=True), 2))
        k6f = " ".join(_device_kernels(
            lambda: A.fused_proj_two_block_attention(
                *x, *ws, *m, num_heads=H, scale=scale, version=2), 2))
        Lv, Lu = DUAL_SHAPE
        xs = [torch.randn(64, L, d, generator=g, device=dev).to(dt)
              for L in (Lv, Lu)]
        leaves = [t.detach().requires_grad_()
                  for t in xs + _proj_weights(g, d, 12, dt, dev)]
        mv, mu = _masks(g, 64, Lv, dev, False), _masks(g, 64, Lu, dev)
        outs = K5.fused_dual_stream_attention(
            leaves[0], leaves[1], _pairs(leaves[2:14]), _pairs(leaves[14:]),
            mv, mu, num_heads=H, scale=scale, dropout_rate=DROP_RATE, seed=3,
            deterministic=False)
        gs = [torch.randn_like(o) for o in outs]
        k5 = " ".join(_device_kernels(lambda: torch.autograd.grad(
            outs, leaves, gs, retain_graph=True), 2))
        k5f = " ".join(_device_kernels(lambda: K5.fused_dual_stream_attention(
            xs[0], xs[1], _pairs(leaves[2:14]), _pairs(leaves[14:]), mv, mu,
            num_heads=H, scale=scale), 2))
        for name, names, body, want, refuse in (
                ("K6f", k6f, A.k6_body(dt),
                 ("qkv_gemm", "proj_two_block_core_fwd") if bf16 else tf32,
                 ("tf32",) if bf16 else ("qkv_gemm", "core_fwd")),
                ("K5f", k5f, K5.k5_body(dt),
                 ("qkv_gemm", "dual_stream_core_fwd") if bf16 else tf32,
                 ("tf32",) if bf16 else ("qkv_gemm", "core_fwd")),
                ("K6b", k6, A.k6_body(dt),
                 mma + ("proj_two_block_core_bwd",) if bf16
                 else ("proj_pairs_f32", "two_block_bwd_tf32", "dx_kernel",
                       "dw_kernel"),
                 ("tf32",) if bf16 else mma + ("core_bwd",)),
                ("K5b", k5, K5.k5_body(dt),
                 mma + ("dual_stream_core_bwd",) if bf16
                 else ("proj_pairs_f32", "two_block_bwd_tf32", "dx_kernel",
                       "dw_kernel"),
                 ("tf32",) if bf16 else mma + ("core_bwd",))):
            missing = [n for n in want if n not in names]
            if missing or any(n in names for n in refuse) or \
                    body != ("mma" if bf16 else "tf32"):
                raise AssertionError(f"{name} {dt}: body {body}, kernels "
                                     f"{names[:600]} (missing {missing})")
            log(f"  {name} {str(dt)[6:]}: {body} body, kernels "
                f"{', '.join(want)}")
        del out, outs, leaves, x, ws, xs


def _k4_kernels(A, g, dev):
    """K4f and K4b (a whole layer stream) against their plain versions on
    the four stream shapes, B=64, fp32 and bf16, dropout off and on; then
    their times at B=1024 in bf16 on the largest launch (100, 40, 100)."""
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = HEADS, D_MODEL
    ff = d
    scale = 1.0 / math.sqrt(d // H)

    def inputs(B, Lq, L1, L2, dt, ff=d):
        return _k4_inputs(g, B, Lq, L1, L2, dt, dev, ff)

    def k4(t, m, rate=0.0, seed=0):
        return K4.fused_layer_stream(
            *t[:3], _pairs(t[3:15]), t[15:25], *m, num_heads=H, scale=scale,
            dropout_rate=rate, seed=seed, deterministic=rate == 0)

    def plain(t, m, rate=0.0, seed=0):
        return K4.layer_stream_plain(*t[:3], t[3:15], t[15:25], *m, H, scale,
                                     rate, seed)

    def plain_bwd(t, m, gx, rate=0.0, seed=0):
        return K4.layer_stream_bwd_plain(*t[:3], t[3:15], t[15:25], *m, gx,
                                         H, scale, rate, seed)

    def check(name, got, want, dt):
        """fp32 as the other kernels; bf16 against the largest output: a
        y1 that rounds the other way before LN2 moves an output by an ulp
        of y1's size, however small that output is (measured up to ~1% of
        the largest output, a few ulps of it)."""
        if dt == torch.float32:
            return _check(name, got, want, dt)
        return _rel_err(name, [got], [want], BWD_TOL[dt])

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape in STREAM_SHAPES:
            t, m = inputs(64, *shape, dt)
            gx = torch.randn(64, shape[0], d, generator=g, device=dev).to(dt)
            errs = {}
            for rate, seed in ((0.0, 0), (DROP_RATE, 1357911)):
                on = "drop" if rate else "eval"
                tag = f"{str(dt)[6:]} {shape} {on}"
                errs[f"K4f {on}"] = check(f"K4f {tag}", k4(t, m, rate, seed),
                                          plain(t, m, rate, seed), dt)
                n = A.LAUNCHES["layer_stream_bwd"]
                grads = _grads(lambda *x: k4(x, m, rate, seed), t, gx)
                if A.LAUNCHES["layer_stream_bwd"] != n + 1:
                    raise AssertionError("K4b did not launch")
                errs[f"K4b {on}"] = _rel_err(f"K4b {tag}", grads,
                                             plain_bwd(t, m, gx, rate, seed),
                                             BWD_TOL[dt])
            for k, v in errs.items():
                worst[k.split()[0]] = max(worst.get(k.split()[0], 0.0), v)
            log(f"  B=64 {str(dt)[6:]} {shape}: " + ", ".join(
                f"{k} {v:.2g}" for k, v in errs.items()))
        # an MLP narrower than d, so that the epilogue's ff and d indexing
        # differ
        shape, narrow = STREAM_SHAPES[0], d // 2
        t, m = inputs(64, *shape, dt, narrow)
        gx = torch.randn(64, shape[0], d, generator=g, device=dev).to(dt)
        tag = f"{str(dt)[6:]} {shape} ff={narrow} drop"
        e_f = check(f"K4f {tag}", k4(t, m, DROP_RATE, 97531),
                    plain(t, m, DROP_RATE, 97531), dt)
        e_b = _rel_err(f"K4b {tag}",
                       _grads(lambda *x: k4(x, m, DROP_RATE, 97531), t, gx),
                       plain_bwd(t, m, gx, DROP_RATE, 97531), BWD_TOL[dt])
        worst["K4f"], worst["K4b"] = (max(worst["K4f"], e_f),
                                      max(worst["K4b"], e_b))
        log(f"  B=64 {tag}: K4f {e_f:.2g}, K4b {e_b:.2g}")
    torch.cuda.synchronize()

    B, dt, (Lq, L1, L2) = 1024, torch.bfloat16, STREAM_SHAPES[1]
    t, m = inputs(B, Lq, L1, L2, dt)
    gx = torch.randn(B, Lq, d, generator=g, device=dev).to(dt)
    err_f = check("K4f B=1024", k4(t, m), plain(t, m), dt)
    ms_f = _device_ms(lambda: k4(t, m), 10, K4_NAMES) \
        or _time_ms(lambda: k4(t, m), 10)
    plain_f = _time_ms(lambda: plain(t, m), 3)
    leaves = [x.detach().requires_grad_() for x in t]
    out = k4(leaves, m)

    def k4b():
        return torch.autograd.grad(out, leaves, gx, retain_graph=True)
    got = k4b()
    err_b = _rel_err("K4b B=1024", got, plain_bwd(t, m, gx), BWD_TOL[dt])
    # dW, db and the LayerNorm gradients are sums in ordered row chunks: a
    # second call gives the same bits
    again = k4b()
    if not all(torch.equal(a, b) for a, b in zip(got[3:], again[3:])):
        raise AssertionError("K4b: dW, db or the LayerNorm gradients differ "
                             "between two calls")
    log("  K4b B=1024: dW, db and the LayerNorm gradients bit-equal across "
        "two calls")
    del got, again
    ms_b = _device_ms(k4b, 5, K4_NAMES) or _time_ms(k4b, 5)
    plain_b = _time_ms(lambda: plain_bwd(t, m, gx), 2)
    e = _elem(dt)
    proj = _proj_flops(B, d, Lq, L1, L2)
    core_f = 4.0 * B * Lq * (L1 + L2) * d          # QK^T and PV
    epi = 2.0 * B * Lq * (d * d + 2 * d * ff)      # the three Denses
    params = 6 * (d * d + d) + d * d + 2 * d * ff + 2 * d + ff
    rows_in, masks = B * d * (Lq + L1 + L2), 4 * B * (Lq + L1 + L2)
    ln = 4 * 4 * d
    bytes_f = e * (rows_in + B * Lq * d + params) + ln + masks
    bytes_b = e * (2 * rows_in + B * Lq * d + params) + 4 * (params + 4 * d) \
        + ln + masks
    # K4b as its bf16 bodies run it, all at the bf16 rate: the recomputed
    # forward (projections, QK^T and PV, the three Denses) once; the core's
    # dV = p^T g with p and g (d_att, fp32) in two parts each (four
    # products), dP = g v^T (two), dQ and dK with dl in two (two each), ten
    # products of core_f / 2; the chain's dx and dW of the projections and
    # the epilogue's dgrad and dW with their fp32 operand in three parts
    ops_b = (proj + core_f + epi + 5 * core_f + 3 * 2 * proj + 3 * 2 * epi) \
        / PEAK_FLOPS[dt]
    _record("K4", "layer_stream_fwd (K4f)", "layer_stream.cu", 140,
            max(worst["K4f"], err_f), ms_f, plain_f, bytes_f,
            (proj + core_f + epi) / PEAK_FLOPS[dt], None, "layer_kernel.py")
    _record("K4b", "layer_stream_bwd (K4b)", "layer_stream_bwd.cu", 178,
            max(worst["K4b"], err_b), ms_b, plain_b, bytes_b, ops_b, None,
            "layer_kernel.py")
    log(f"  K4 bf16 B=1024 {(Lq, L1, L2)}: K4f {ms_f:.3f} ms (plain "
        f"{plain_f:.3f}), K4b {ms_b:.3f} ms (plain {plain_b:.3f}); max err "
        f"K4f {err_f:.3g}, K4b {err_b:.3g}")
    del leaves, out
    # the other three launch shapes of a layer, by device time
    for shape in (STREAM_SHAPES[0],) + STREAM_SHAPES[2:]:
        t, m = inputs(B, *shape, dt)
        gx = torch.randn(B, shape[0], d, generator=g, device=dev).to(dt)
        leaves = [x.detach().requires_grad_() for x in t]
        out = k4(leaves, m)
        ms_f = _device_ms(lambda: k4(t, m), 5, K4_NAMES)
        ms_b = _device_ms(lambda: torch.autograd.grad(
            out, leaves, gx, retain_graph=True), 3, K4_NAMES)
        log(f"  B=1024 {shape}, device ms: K4f bf16 {_ms(ms_f)}, K4b bf16 "
            f"{_ms(ms_b)}")
        del leaves, out
    del t, m, gx
    torch.cuda.empty_cache()


# K6 (version 2 of K2) is also checked where the wrapper swaps the blocks:
# L1 unaligned, L2 a multiple of 8
V2_SWAPPED = (12, 12, 40)
K2_KEYS = ("proj_two_block_attention", "proj_two_block_attention_bwd")
K6_KEYS = ("proj_two_block_attention_v2", "proj_two_block_attention_v2_bwd")


def _k6_kernels(A, g, dev, cost_f, cost_b):
    """K6f and K6b (version=2) against their plain versions at the four
    stream shapes and a swapped one, B=64, fp32 and bf16, dropout off and
    on; then their times at B=1024 in bf16 beside K2f and K2b on the same
    inputs (in turns: K2, K6, K6, K2). cost_*: K2's (bytes, seconds at the
    peak rates) at (40, 40, 100), B=1024."""
    H, d = HEADS, D_MODEL
    scale = 1.0 / math.sqrt(d // H)

    def attn(x, ws, m, version, rate=0.0, seed=0):
        return A.fused_proj_two_block_attention(
            *x, *ws, *m, num_heads=H, scale=scale, dropout_rate=rate,
            seed=seed, deterministic=rate == 0, version=version)

    def kernel_order(x, ws, m):
        """The plain versions take the blocks in the order K6 runs them."""
        t = tuple(x) + tuple(ws)
        if x[1].shape[1] % 8:
            return A.swap_blocks(t), (m[0], m[2], m[1]), True
        return t, m, False

    def plain(x, ws, m, rate=0.0, seed=0):
        t, mm, _ = kernel_order(x, ws, m)
        return A.proj_two_block_attention_v2_plain(*t, *mm, H, scale, rate,
                                                   seed)

    def plain_bwd(x, ws, m, gx, rate=0.0, seed=0):
        t, mm, swapped = kernel_order(x, ws, m)
        grads = A.proj_two_block_attention_v2_bwd_plain(*t, *mm, gx, H, scale,
                                                        rate, seed)
        return A.swap_blocks(grads) if swapped else grads

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape in STREAM_SHAPES + (V2_SWAPPED,):
            x, ws, m = _k2_inputs(g, 64, *shape, dt, dev)
            gx = torch.randn(64, shape[0], d, generator=g, device=dev).to(dt)
            errs = {}
            for rate, seed in ((0.0, 0), (DROP_RATE, 8642097)):
                on = "drop" if rate else "eval"
                tag = f"{str(dt)[6:]} {shape} {on}"
                n = dict(A.LAUNCHES)
                errs[f"K6f {on}"] = _check(f"K6f {tag}",
                                           attn(x, ws, m, 2, rate, seed),
                                           plain(x, ws, m, rate, seed), dt)
                grads = _grads(lambda *t: attn(t[:3], t[3:], m, 2, rate, seed),
                               tuple(x) + tuple(ws), gx)
                ran = {k: A.LAUNCHES[k] - n[k] for k in K2_KEYS + K6_KEYS}
                if ran != {K2_KEYS[0]: 0, K2_KEYS[1]: 0, K6_KEYS[0]: 2,
                           K6_KEYS[1]: 1}:
                    raise AssertionError(f"K6 {tag}: launches {ran}")
                errs[f"K6b {on}"] = _rel_err(f"K6b {tag}", grads,
                                             plain_bwd(x, ws, m, gx, rate, seed),
                                             BWD_TOL[dt])
            for k, v in errs.items():
                worst[k.split()[0]] = max(worst.get(k.split()[0], 0.0), v)
            log(f"  B=64 {str(dt)[6:]} {shape}: " + ", ".join(
                f"{k} {v:.2g}" for k, v in errs.items()))
    torch.cuda.synchronize()

    B, dt = 1024, torch.bfloat16
    for i, shape in enumerate(STREAM_SHAPES):
        x, ws, m = _k2_inputs(g, B, *shape, dt, dev)
        gx = torch.randn(B, shape[0], d, generator=g, device=dev).to(dt)
        leaves = [t.detach().requires_grad_() for t in tuple(x) + tuple(ws)]
        outs = {v: attn(leaves[:3], leaves[3:], m, v) for v in (1, 2)}
        ms = {}
        # by device time (the kernels' rows of a profiler trace; CUDA
        # events where the trace holds none), in turns: K2, K6, K6, K2
        for v in (1, 2, 2, 1):
            names = K2_NAMES if v == 1 else K6_NAMES

            def fwd():
                return attn(x, ws, m, v)

            def bwd():
                return torch.autograd.grad(outs[v], leaves, gx,
                                           retain_graph=True)
            f = _device_ms(fwd, 10 if i == 0 else 5, names) \
                or _time_ms(fwd, 10 if i == 0 else 5)
            b = _device_ms(bwd, 5 if i == 0 else 3, names) \
                or _time_ms(bwd, 5 if i == 0 else 3)
            ms.setdefault(v, []).append((f, b))
        (k2f, k2b), (k6f, k6b) = (
            tuple(sum(t[j] for t in ms[v]) / 2 for j in (0, 1)) for v in (1, 2))
        bound = 1e3 * max(k2b_cost(B, *shape)[0] / HBM_BYTES_PER_S,
                          k2b_cost(B, *shape)[1])
        log(f"  B=1024 bf16 {shape}, device ms: K6f {k6f:.3f}, K6b "
            f"{k6b:.3f} (bound {bound:.3f}); K2f {k2f:.3f}, K2b {k2b:.3f} "
            "(same inputs, in turns)")
        if i:
            continue
        err_f = _check("K6f B=1024", outs[2], plain(x, ws, m), dt)
        got = torch.autograd.grad(outs[2], leaves, gx, retain_graph=True)
        err_b = _rel_err("K6b B=1024", got, plain_bwd(x, ws, m, gx),
                         BWD_TOL[dt])
        # dW and db are summed in row chunks added in order: a second call
        # gives the same bits
        again = torch.autograd.grad(outs[2], leaves, gx, retain_graph=True)
        if not all(torch.equal(a, b) for a, b in zip(got[3:], again[3:])):
            raise AssertionError("K6b: dW or db differ between two calls")
        log("  K6b B=1024: dW and db bit-equal across two calls")
        del got, again
        plain_f = _time_ms(lambda: plain(x, ws, m), 5)
        plain_b = _time_ms(lambda: plain_bwd(x, ws, m, gx), 3)
        _record("K6", "proj_two_block_attention_v2_fwd (K6f)",
                "proj_two_block_attention_v2.cu", 1198,
                max(worst["K6f"], err_f), k6f, plain_f, *cost_f, None)
        _record("K6b", "proj_two_block_attention_v2_bwd (K6b)",
                "proj_two_block_attention_v2_bwd.cu", 1253,
                max(worst["K6b"], err_b), k6b, plain_b, *cost_b, None)
        log(f"  K6 bf16 B=1024 {shape}: plain K6f {plain_f:.3f} ms, plain "
            f"K6b {plain_b:.3f} ms; max err K6f {err_f:.3g}, K6b {err_b:.3g}")
    del x, ws, m, gx, leaves, outs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
def _flagship_cfg(csv_path):
    from segmminterest_tpu_torch.utils.config import InterestConfig
    return InterestConfig(sample_csv=csv_path, d_model=D_MODEL, nhead=HEADS,
                          num_layers_enc=6, user_input_type="both",
                          photo_input_type="both", fusion_heads=2,
                          exposure_prob=[1.0] * 40, seed=7)


def _device_int8_table(rows, dev, seed=0, chunk=1 << 18):
    """(int8 rows, float32 (N, 1) scales) synthesised on the card chunk by
    chunk: no host copy of the table."""
    from segmminterest_tpu_torch.core.numerics import quantize_rows_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.empty(rows, FEAT_DIM, dtype=torch.int8, device=dev)
    scale = torch.empty(rows, 1, dtype=torch.float32, device=dev)
    for s in range(0, rows, chunk):
        e = min(rows, s + chunk)
        q, sc = quantize_rows_int8(
            torch.randn(e - s, FEAT_DIM, generator=g, device=dev))
        table[s:e], scale[s:e] = q, sc
    return table, scale


CSV_ARGS = dict(n_users=150, per_user=(250, 300), n_videos=10_000, seed=1)


def _data(ctx):
    """The synthetic interactions, their reader and segment map, and the
    3,920,483-row int8 table on the card; built once, for every phase that
    needs them."""
    if "reader" in ctx:
        return ctx
    from segmminterest_tpu_torch.data.feature_store import FeatureStore
    from segmminterest_tpu_torch.data.reader import SeqReader
    from segmminterest_tpu_torch.data.synthetic import (synthetic_lineid_map,
                                                        write_synthetic_csv)
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    csv_path = write_synthetic_csv(os.path.join(WORK, "inter.csv"),
                                   **CSV_ARGS)
    reader = SeqReader.from_single_csv(csv_path, min_interactions=100,
                                       num_warmup=80)
    lineid_map = synthetic_lineid_map(reader, PRODUCTION_ROWS)
    # the iterator ships line ids only; the table itself lives on the card
    stub = np.broadcast_to(np.zeros((1, FEAT_DIM), np.float32),
                           (PRODUCTION_ROWS, FEAT_DIM))
    store = FeatureStore(stub, lineid_map)
    table = _device_int8_table(PRODUCTION_ROWS, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"  data: {len(reader.tables['train'])} train / "
        f"{len(reader.tables['test'])} test interactions, {len(lineid_map)} "
        f"segments, table {PRODUCTION_ROWS} x {FEAT_DIM} int8 on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    ctx.update(reader=reader, store=store, table=table, csv=csv_path)
    return ctx


def _cli_files(ctx):
    """A small float32 memmap and its segment map for the CLIs
    (FeatureStore.open reads one memmap row per lineid-map entry: ~200k rows
    here, the size bench.py:75 uses). Removed at the end of the run."""
    if "memmap" in ctx:
        return ctx["memmap"], ctx["lineid"]
    from segmminterest_tpu_torch.data.synthetic import synthetic_lineid_map
    cli_map = synthetic_lineid_map(_data(ctx)["reader"])
    rows = len(cli_map)
    memmap = os.path.join(WORK, "feat.dat")
    mm = np.memmap(memmap, dtype="float32", mode="w+",
                   shape=(rows, FEAT_DIM))
    rs = np.random.default_rng(2)
    for s in range(0, rows, 50_000):
        e = min(rows, s + 50_000)
        mm[s:e] = rs.standard_normal((e - s, FEAT_DIM), dtype=np.float32)
    mm.flush()
    del mm
    lineid_path = os.path.join(WORK, "lineid.json")
    with open(lineid_path, "w") as f:
        json.dump(cli_map, f)
    ctx.update(memmap=memmap, lineid=lineid_path, memmap_rows=rows)
    return memmap, lineid_path


SERVING_CALLS = 25      # calls in the one timed window of each batch size


def phase_serving(ctx):
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.checkpoint import CheckPointer
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import export_logits as X

    dev = torch.device("cuda")
    _data(ctx)
    reader, store, table, csv_path = (ctx["reader"], ctx["store"],
                                      ctx["table"], ctx["csv"])
    n_test = len(reader.tables["test"])

    cfg = X.apply_serving_preset(_flagship_cfg(csv_path))
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=table, device=dev)
    ckpt_dir = os.path.join(WORK, "ckpt")
    ckpt = CheckPointer("main_metric", ckpt_dir, mode="max")
    ckpt.save_checkpoint(engine.init_state(), 0, {"main_metric": 0.5})
    state = ckpt.load_checkpoint(engine.init_state(), mode="best")["state"]

    def iterator(batch_size, table_key="test"):
        return BatchIterator(reader, reader.tables[table_key], batch_size,
                             shuffle=False, feature_store=store,
                             seed=cfg.seed, transform=engine.batch_transform)

    # warm run: kernel build, allocator, and the iterator's row tables (a
    # one-off set-up per split) stay out of the timed run
    it = iterator(cfg.test_batch_size)
    X.export_split_logits(engine, state, it)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    logits = X.export_split_logits(engine, state, it)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    n_batches = len(it)
    if len(logits) != n_test or any(
            len(v) != 40 or not np.isfinite(v).all() for v in logits.values()):
        raise AssertionError("serving: not every test row has 40 finite "
                             "logits")
    if launches["proj_two_block_attention"] != 20 * n_batches or \
            launches["two_block_attention"] != 0:
        raise AssertionError(f"serving: launches {launches}, expected K2 = "
                             f"20 x {n_batches} batches and K1 = 0")
    RESULT["launches"]["K2"] = launches["proj_two_block_attention"]
    log(f"  serving: {n_test} interactions in {n_batches} batches of "
        f"{cfg.test_batch_size}: {n_test / wall:.1f} interactions/s, "
        f"{1e3 * wall / n_batches:.1f} ms per batch (host pipeline included,"
        f" iterator set-up excluded); launches {launches}")

    # device latency per batch size (a full batch already on the card):
    # the mean of all calls in one window of SERVING_CALLS, host stalls
    # included (batches of 256 and fewer wait on the host)
    for bs in (1024, 512, 256, 128):
        batch = next(iter(BatchIterator(
            reader, reader.tables["train"], bs, feature_store=store,
            seed=cfg.seed, prefetch_size=0)))
        dev_batch = {"_dev": engine.put_batch(batch)}
        ms = _time_ms(lambda: engine.eval_step(state, dev_batch),
                      SERVING_CALLS)
        log(f"  latency B={bs}: {ms:.1f} ms per batch "
            f"({1e3 * bs / ms:.1f} interactions/s)")

    # the exporter's CLI itself, over the small float32 memmap
    memmap, lineid_path = _cli_files(ctx)
    A.reset_launch_counts()
    out_dir = os.path.join(WORK, "cli_logits")
    out_path = X.main([
        "--sample_csv", csv_path, "--min_interactions", "100",
        "--num_warmup", "80", "--memmap", memmap, "--lineid_map",
        lineid_path, "--serving", "1", "--splits", "test", "--seed", "7",
        "--work_dir", ckpt_dir, "--parse_work_dir", "0", "--out_dir",
        out_dir])
    with open(out_path) as f:
        cli = json.load(f)
    if set(cli) != set(logits) or not all(
            np.isfinite(v).all() and len(v) == 40 for v in cli.values()):
        raise AssertionError("CLI: logit keys differ from the test split or "
                             "are not finite")
    if A.LAUNCHES["proj_two_block_attention"] != 20 * n_batches:
        raise AssertionError(f"CLI: launches {A.LAUNCHES}")
    log(f"  CLI export_logits --serving 1 over a {ctx['memmap_rows']}-row "
        f"memmap: {len(cli)} rows, launches {dict(A.LAUNCHES)}")
    ctx.update(cfg=cfg, ckpt=ckpt)


def phase_default(ctx):
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    reader, store, ckpt = ctx["reader"], ctx["store"], ctx["ckpt"]
    base = ctx["cfg"].replace(compute_dtype="float32", table_quant="int8")
    batches = [b for _, b in zip(range(2), BatchIterator(
        reader, reader.tables["test"], 1024, feature_store=store, seed=7,
        prefetch_size=0))]

    def engine_for(device, table, **kw):
        eng = InterestEngine(base.replace(**kw), reader.n_users,
                             reader.n_items, feature_table=table,
                             device=device)
        return eng, ckpt.load_checkpoint(eng.init_state(), "best")["state"]

    k1_eng, k1_state = engine_for("cuda", ctx["table"],
                                  fused_attention=True, fuse_qkv=False)
    A.reset_launch_counts()
    k1_logits = [k1_eng.eval_step(k1_state, b)[1] for b in batches]
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    if launches["two_block_attention"] != 20 * len(batches) or \
            launches["proj_two_block_attention"] != 0:
        raise AssertionError(f"default config: launches {launches}, "
                             f"expected K1 = 20 x {len(batches)}")
    RESULT["launches"]["K1"] = launches["two_block_attention"]
    # a B=1024 batch of the default config served, the batch on the card
    dev_batch = {"_dev": k1_eng.put_batch(batches[0])}
    ms = _time_ms(lambda: k1_eng.eval_step(k1_state, dev_batch), 5)
    share = _device_share(lambda: k1_eng.eval_step(k1_state, dev_batch), 3,
                          K1F_NAMES)
    log(f"  default config served (fp32, K1, B=1024): {ms:.1f} ms a batch"
        + ("" if share is None else f", device {share[1]:.1f} ms, K1f "
           f"{100 * share[0]:.1f}% of it"))

    k2_eng, k2_state = engine_for("cuda", ctx["table"],
                                  fused_attention=True, fuse_qkv=True)
    A.reset_launch_counts()
    k2_logits = [k2_eng.eval_step(k2_state, b)[1] for b in batches]
    if A.LAUNCHES["proj_two_block_attention"] != 20 * len(batches):
        raise AssertionError(f"fp32 K2 run: launches {A.LAUNCHES}")
    del k2_eng
    co_eng, co_state = engine_for("cuda", ctx["table"],
                                  fused_attention=False, fuse_qkv=False)
    co_logits = [co_eng.eval_step(co_state, b)[1] for b in batches]
    del co_eng
    # same params, same function, all fp32: only summation order differs
    # (projections over 512 terms, five layers with LayerNorm) -> 1e-3 on
    # O(1) logits
    err = max((a - b).abs().max().item()
              for a, b in zip(k1_logits, k2_logits))
    err_co = max((a - b).abs().max().item()
                 for a, b in zip(k1_logits, co_logits))
    mag = max(a.abs().max().item() for a in k1_logits)
    log(f"  default config (K1, fp32): launches {launches}; max |logit| "
        f"{mag:.3g}; |K1 - K2| {err:.3g}, |K1 - composed| {err_co:.3g}")
    if not (err <= 1e-3 and err_co <= 1e-3):
        raise AssertionError(f"fp32 routes disagree: K1-K2 {err}, "
                             f"K1-composed {err_co}")

    # one 32-row batch on the CPU (plain versions, fp32)
    small = next(iter(BatchIterator(reader, reader.tables["test"], 32,
                                    feature_store=store, seed=7,
                                    prefetch_size=0)))
    gpu = k1_eng.eval_step(k1_state, small)[1].cpu()
    cpu_table = tuple(t.cpu() for t in ctx["table"])
    cpu_eng, cpu_state = engine_for("cpu", cpu_table, fused_attention=True,
                                    fuse_qkv=False)
    cpu = cpu_eng.eval_step(cpu_state, small)[1]
    err = (gpu - cpu).abs().max().item()
    log(f"  card vs CPU (plain versions), 32 rows fp32: max |diff| {err:.3g}")
    if not err <= 1e-3:
        raise AssertionError(f"card and CPU logits differ by {err}")


# ---------------------------------------------------------------------------
# training

TRAIN_STEPS = 10        # production config, timed after 2 warm-up steps
DEFAULT_TRAIN_STEPS = 3
# attention launches per flagship step: 2 backbones x 5 run layers x 2
# streams forward; the last layer's user stream reaches no output, so its
# backward never runs: 18 backward launches
FWD_PER_STEP, BWD_PER_STEP = 20, 18
# K2f and K2b: bf16 (qkv_gemm_kernel, proj_two_block_core_*, chain_dx_kernel,
# chain_dw_kernel, chain_dw_reduce_kernel) and fp32 (k2_body "tf32": the
# projections, K1's 3xTF32 core with its query windows summed, and the
# CUDA-core chain's dx_kernel, dw_kernel, dw_reduce_kernel)
K2_NAMES = ("proj_two_block", "qkv_gemm", "dx_kernel", "dw_kernel",
            "dw_reduce_kernel", "proj_pairs_f32", "two_block_fwd_tf32",
            "two_block_bwd_tf32", "tf32_sum_windows")
# K4f and K4b: K2's kernels (their attention) and the epilogue's, bf16
# (layer_epilogue_*_mma_kernel) and fp32 (layer_epilogue_*_kernel), with
# ln_partial_sum_kernel
K4_NAMES = K2_NAMES + ("layer_epilogue", "ln_partial_sum")
# K5 (bf16: qkv_gemm_kernel, dual_stream_core_*_kernel, chain_dx_kernel,
# chain_dw_kernel, chain_dw_reduce_kernel; fp32: K2's) and K6 (K2's
# kernels, its cores with K6's keys)
K5_NAMES = K2_NAMES + ("dual_stream",)
K6_NAMES = K2_NAMES
# K1f and K1b (fp32: two_block_bwd_tf32_kernel, bf16: two_block_bwd_kernel)
# K1's kernels by name, forward and backward: fp32 its 3xTF32 bodies (and
# their window sums), bf16 the two-block core's, in one chunk or on the
# key-chunk path
K1F_NAMES = ("two_block_fwd", "two_block_core_fwd", "k2_chunked_fwd")
K1B_NAMES = ("two_block_bwd", "tf32_sum_windows", "two_block_core_bwd",
             "k2_chunked_bwd")
K1_NAMES = K1F_NAMES + K1B_NAMES
# K3f and K3b, fp32 (masked_*_tf32_kernel) and bf16 (masked_*_mma_kernel)
K3_NAMES = ("masked_fwd", "masked_bwd", "tf32_sum_windows")


def _production_train_cfg(csv_path, **kw):
    """The production training configuration (bench.py:363-371 through
    tools/perf_ab.py): flagship both/both, B=1024, bf16, the six QKV
    projections inside K2, int8 table, no remat; dropout 0.1."""
    return _flagship_cfg(csv_path).replace(
        train_batch_size=1024, compute_dtype="bfloat16",
        fused_attention=True, fuse_qkv=True, table_quant="int8",
        remat=False, **kw)


def _train_steps(engine, batches):
    """Train on `batches` (already on the card); per-step host time after a
    synchronise, the losses and the launch counts of the run."""
    from segmminterest_tpu_torch.core import attention as A
    state = engine.init_state()
    A.reset_launch_counts()
    times, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, ld = engine.train_step(state, b)
        loss = float(ld["loss"])  # synchronises
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    counts = dict(A.LAUNCHES)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    return state, times, losses, counts


def _expect(counts, want, what):
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"{k} = {v}")


def _kernel_share(engine, batches, names=None):
    """_device_share over training steps on `batches` (default names: K2f
    + K2b)."""
    state = engine.init_state()
    todo = iter(batches)

    def step():
        nonlocal state
        state, _ = engine.train_step(state, next(todo))
    return _device_share(step, len(batches), names or K2_NAMES)


def phase_train(ctx):
    """The production training configuration at full width over the
    3.9M-row int8 table, through the engine's own functions; then the
    K7b route (SEGMM_ATTN_V3_BWD's switch) for two steps."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    _data(ctx)
    reader, store = ctx["reader"], ctx["store"]
    cfg = _production_train_cfg(ctx["csv"])
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    it = BatchIterator(reader, reader.tables["train"], cfg.train_batch_size,
                       shuffle=True, feature_store=store, seed=cfg.seed,
                       transform=engine.batch_transform)
    batches = [b for _, b in zip(range(TRAIN_STEPS + 2), it)]
    if len(batches) < TRAIN_STEPS + 2:
        raise AssertionError(f"only {len(batches)} training batches")
    _, times, losses, counts = _train_steps(engine, batches)
    n = len(batches)
    _expect(counts, {"proj_two_block_attention": FWD_PER_STEP * n,
                     "proj_two_block_attention_bwd": BWD_PER_STEP * n,
                     "two_block_attention": 0, "two_block_attention_bwd": 0,
                     "proj_two_block_attention_qkv_bwd": 0}, "production train")
    RESULT["launches"]["K2b"] = counts[
        "proj_two_block_attention_bwd"]
    steady = times[2:]
    rows = sum(int(b["row_mask"].sum()) for b in batches[2:])
    ms = 1e3 * sum(steady) / len(steady)
    log(f"  production train (bf16, K2, int8 table, no remat, B=1024): "
        f"{ms:.1f} ms per step, {rows / sum(steady):.1f} interactions/s over "
        f"{len(steady)} steps after 2 warm-up steps; losses "
        f"{[round(x, 4) for x in losses]}; launches {counts}")
    log(f"  peak device memory so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    share = _kernel_share(engine, batches[:2])
    if share is None:
        log("  K2f + K2b share of the step: not measured (the profiler "
            "trace holds no device times)")
    else:
        log(f"  K2f + K2b share of device time: {100 * share[0]:.1f}% of "
            f"{share[1]:.1f} ms device time per step (torch.profiler, 2 "
            "steps)")

    # the K7b route: the qkv pass alone, dx and dW by torch.matmul
    A.ATTN_V3_BWD = True
    _, times7, losses7, counts7 = _train_steps(engine, batches[:3])
    A.ATTN_V3_BWD = False
    _expect(counts7, {"proj_two_block_attention_qkv_bwd": BWD_PER_STEP * 3,
                      "proj_two_block_attention_bwd": 0}, "K7b train")
    RESULT["launches"]["K7b"] = counts7[
        "proj_two_block_attention_qkv_bwd"]
    log(f"  K7b route (SEGMM_ATTN_V3_BWD=1): {1e3 * times7[-1]:.1f} ms for "
        f"the last of 3 steps; losses {[round(x, 4) for x in losses7]}")
    del engine
    torch.cuda.empty_cache()


def phase_train_default(ctx):
    """The default configuration (K1 route, fp32, remat of each encoder
    layer) for a few steps; then one 32-row fp32 step on the card against
    the same step on the CPU, on the K2 route and on the K1 route."""
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    _data(ctx)
    reader, store = ctx["reader"], ctx["store"]
    cfg = _flagship_cfg(ctx["csv"]).replace(train_batch_size=1024,
                                            table_quant="int8")
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    batches = [b for _, b in zip(range(DEFAULT_TRAIN_STEPS), BatchIterator(
        reader, reader.tables["train"], 1024, shuffle=True,
        feature_store=store, seed=cfg.seed,
        transform=engine.batch_transform))]
    _, times, losses, counts = _train_steps(engine, batches)
    n = len(batches)
    # layer remat runs each layer's forward twice
    _expect(counts, {"two_block_attention": 2 * FWD_PER_STEP * n,
                     "two_block_attention_bwd": BWD_PER_STEP * n,
                     "proj_two_block_attention": 0,
                     "proj_two_block_attention_bwd": 0}, "default train")
    RESULT["launches"]["K1b"] = counts["two_block_attention_bwd"]
    rows = sum(int(b["row_mask"].sum()) for b in batches[1:])
    share = _kernel_share(engine, batches[:2], K1_NAMES)
    log("  K1f + K1b share of device time: " + (
        "not measured (no device times in the trace)" if share is None else
        f"{100 * share[0]:.1f}% of {share[1]:.1f} ms device time per step "
        "(torch.profiler, 2 steps)"))
    log(f"  default train (fp32, K1, layer remat, B=1024): "
        f"{1e3 * sum(times[1:]) / (n - 1):.1f} ms per step, "
        f"{rows / sum(times[1:]):.1f} interactions/s (steps 2-{n}); losses "
        f"{[round(x, 4) for x in losses]}; launches {counts}")
    del engine
    torch.cuda.empty_cache()

    # 32 rows, fp32, dropout off (nn.Dropout draws from another generator
    # on each device): the card against the CPU's plain versions, on the K2
    # route and on the K1 route (18 K1b on the card, none on the CPU)
    from segmminterest_tpu_torch.core import attention as A
    small = next(iter(BatchIterator(reader, reader.tables["train"], 32,
                                    feature_store=store, seed=7,
                                    prefetch_size=0)))
    for route, fuse_qkv, key in (
            ("K2", True, "proj_two_block_attention_bwd"),
            ("K1", False, "two_block_attention_bwd")):
        one = cfg.replace(train_batch_size=32, dropout=0.0,
                          fuse_qkv=fuse_qkv)
        got = {}
        for dev, table in (("cuda", ctx["table"]),
                           ("cpu", tuple(t.cpu() for t in ctx["table"]))):
            eng = InterestEngine(one, reader.n_users, reader.n_items,
                                 feature_table=table, device=dev)
            A.reset_launch_counts()
            _, ld = eng.train_step(eng.init_state(), small)
            got[dev] = (float(ld["loss"]), float(eng.last_grad_norm),
                        A.LAUNCHES[key])
            del eng, table
        if got["cuda"][2] != BWD_PER_STEP or got["cpu"][2] != 0:
            raise AssertionError(f"32-row {route} step launches of {key}: "
                                 f"{got}")
        dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
        log(f"  32-row fp32 step, {route} route, card vs CPU: loss "
            f"{got['cuda'][0]:.6f} vs {got['cpu'][0]:.6f} (rel {dl:.2g}), "
            f"grad norm {got['cuda'][1]:.6f} vs {got['cpu'][1]:.6f} (rel "
            f"{dg:.2g}); {got['cuda'][2]} {key} launches on the card")
        # fp32 through five layers in another summation order: 1e-4
        # relative
        if not (dl <= 1e-4 and dg <= 1e-4):
            raise AssertionError(f"card and CPU {route} training steps "
                                 f"differ: {got}")


# bf16 through five layers on two devices that round at different places:
# the 32-row step's loss and gradient norm agree to this, relative
BF16_STEP_RTOL = 2e-2


def phase_train_bf16(ctx):
    """The default configuration with compute_dtype bfloat16 (fused
    attention without fuse_qkv: K1 in bf16, on the bf16 two-block core;
    layer remat) for a few steps at B=1024: 40 K1f + 18 K1b a step, K1's
    share of the step's device time; a test batch served (20 K1f); one
    32-row bf16 step, dropout off, on the card against the same step on
    the CPU's plain versions."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    _data(ctx)
    reader, store = ctx["reader"], ctx["store"]
    cfg = _flagship_cfg(ctx["csv"]).replace(
        train_batch_size=1024, table_quant="int8", compute_dtype="bfloat16")
    if not (cfg.fused_attention and not cfg.fuse_qkv):
        raise AssertionError("the default config no longer runs K1")
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    batches = [b for _, b in zip(range(DEFAULT_TRAIN_STEPS), BatchIterator(
        reader, reader.tables["train"], 1024, shuffle=True,
        feature_store=store, seed=cfg.seed,
        transform=engine.batch_transform))]
    state, times, losses, counts = _train_steps(engine, batches)
    n = len(batches)
    _expect(counts, {"two_block_attention": 2 * FWD_PER_STEP * n,
                     "two_block_attention_bwd": BWD_PER_STEP * n,
                     "proj_two_block_attention": 0,
                     "proj_two_block_attention_bwd": 0}, "bf16 default train")
    RESULT["launches"]["K1 bf16"] = counts["two_block_attention"]
    RESULT["launches"]["K1b bf16"] = counts["two_block_attention_bwd"]
    rows = sum(int(b["row_mask"].sum()) for b in batches[1:])
    share = _kernel_share(engine, batches[:2], K1_NAMES)
    log("  bf16 K1f + K1b share of device time: " + (
        "not measured (no device times in the trace)" if share is None else
        f"{100 * share[0]:.1f}% of {share[1]:.1f} ms device time per step "
        "(torch.profiler, 2 steps)"))
    log(f"  bf16 default train (K1 on the bf16 core, layer remat, B=1024): "
        f"{1e3 * sum(times[1:]) / (n - 1):.1f} ms per step, "
        f"{rows / sum(times[1:]):.1f} interactions/s (steps 2-{n}); losses "
        f"{[round(x, 4) for x in losses]}; launches {counts}")
    test = next(iter(BatchIterator(reader, reader.tables["test"], 1024,
                                   feature_store=store, seed=7,
                                   prefetch_size=0)))
    dev_batch = {"_dev": engine.put_batch(test)}
    A.reset_launch_counts()
    logits = engine.eval_step(state, dev_batch)[1]
    torch.cuda.synchronize()
    if A.LAUNCHES["two_block_attention"] != FWD_PER_STEP or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"bf16 default served: launches {A.LAUNCHES}, "
                             "or non-finite logits")
    ms = _time_ms(lambda: engine.eval_step(state, dev_batch), 5)
    log(f"  bf16 default served (K1f, B=1024): {ms:.1f} ms a batch, "
        f"{tuple(logits.shape)} finite logits")
    del engine, state
    torch.cuda.empty_cache()

    small = next(iter(BatchIterator(reader, reader.tables["train"], 32,
                                    feature_store=store, seed=7,
                                    prefetch_size=0)))
    one = cfg.replace(train_batch_size=32, dropout=0.0)
    got = {}
    for dev, table in (("cuda", ctx["table"]),
                       ("cpu", tuple(t.cpu() for t in ctx["table"]))):
        eng = InterestEngine(one, reader.n_users, reader.n_items,
                             feature_table=table, device=dev)
        A.reset_launch_counts()
        _, ld = eng.train_step(eng.init_state(), small)
        got[dev] = (float(ld["loss"]), float(eng.last_grad_norm),
                    A.LAUNCHES["two_block_attention_bwd"])
        del eng, table
    if got["cuda"][2] != BWD_PER_STEP or got["cpu"][2] != 0:
        raise AssertionError(f"32-row bf16 step launches of K1b: {got}")
    dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
    log(f"  32-row bf16 step, K1 route, card vs CPU: loss "
        f"{got['cuda'][0]:.6f} vs {got['cpu'][0]:.6f} (rel {dl:.2g}), grad "
        f"norm {got['cuda'][1]:.6f} vs {got['cpu'][1]:.6f} (rel {dg:.2g}); "
        f"{got['cuda'][2]} K1b launches on the card")
    if not (dl <= BF16_STEP_RTOL and dg <= BF16_STEP_RTOL):
        raise AssertionError(f"card and CPU bf16 K1 training steps differ: "
                             f"{got}")


# launches per flagship step of the ablations (2 backbones x 5 run layers):
# CrossAtt runs both streams (K3), SelfAtt the video stream only; the last
# layer's user stream reaches no output, so its backward never runs
CROSS_FWD, CROSS_BWD = 20, 18
SELF_FWD, SELF_BWD = 10, 10
NO_LAUNCHES = {"two_block_attention": 0, "two_block_attention_bwd": 0,
               "proj_two_block_attention": 0, "proj_two_block_attention_bwd": 0,
               "masked_attention": 0, "masked_attention_bwd": 0}
ABLATION_STEPS = 3


def phase_ablation(ctx):
    """The ablation models at the flagship width over the 3.9M-row int8
    table, through the engine's own functions: CrossAtt and SelfAtt trained
    in the default config (fp32, K3, layer remat, dropout 0.1), CrossAtt
    served with the --serving preset (bf16, K3), one step each of the other
    ablations and of fuse_projections, and one 32-row fp32 CrossAtt step
    on the card against the CPU."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import export_logits as X

    _data(ctx)
    reader, store = ctx["reader"], ctx["store"]
    base = _flagship_cfg(ctx["csv"]).replace(train_batch_size=1024,
                                             table_quant="int8")
    batches = None

    def train(cfg, n, share_of=None):
        nonlocal batches
        engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                feature_table=ctx["table"], device="cuda")
        if batches is None:
            batches = [b for _, b in zip(range(ABLATION_STEPS), BatchIterator(
                reader, reader.tables["train"], 1024, shuffle=True,
                feature_store=store, seed=cfg.seed,
                transform=engine.batch_transform))]
        _, times, losses, counts = _train_steps(engine, batches[:n])
        if share_of:
            share = _kernel_share(engine, batches[:2], share_of)
            log("  K3f + K3b share of device time: " + (
                "not measured (no device times in the trace)" if share is None
                else f"{100 * share[0]:.1f}% of {share[1]:.1f} ms device time"
                " per step (torch.profiler, 2 steps)"))
        del engine
        torch.cuda.empty_cache()
        return times, losses, counts

    def expect(counts, n, what, **want):
        _expect(counts, {k: n * want.get(k, 0) for k in NO_LAUNCHES}, what)

    for abl, fwd, bwd in (("CrossAtt", CROSS_FWD, CROSS_BWD),
                          ("SelfAtt", SELF_FWD, SELF_BWD)):
        n = ABLATION_STEPS
        times, losses, counts = train(base.replace(ablation_type=abl), n,
                                      K3_NAMES)
        # layer remat runs each layer's forward twice
        expect(counts, n, f"{abl} train", masked_attention=2 * fwd,
               masked_attention_bwd=bwd)
        if abl == "CrossAtt":
            RESULT["launches"]["K3"] = counts["masked_attention"]
            RESULT["launches"]["K3b"] = counts["masked_attention_bwd"]
        rows = sum(int(b["row_mask"].sum()) for b in batches[1:n])
        log(f"  {abl} train (fp32, K3, layer remat, B=1024): "
            f"{1e3 * sum(times[1:]) / (n - 1):.1f} ms per step, "
            f"{rows / sum(times[1:]):.1f} interactions/s (steps 2-{n}); "
            f"losses {[round(x, 4) for x in losses]}; launches {counts}")

    # CrossAtt in the production training config (bf16, int8 table, no
    # remat, dropout 0.1): K3 in bf16, 20 K3f + 18 K3b per step (fuse_qkv
    # does not apply: CrossAtt's route is K3 whatever the flag says)
    n = ABLATION_STEPS
    times, losses, counts = train(
        _production_train_cfg(ctx["csv"], ablation_type="CrossAtt"), n,
        K3_NAMES)
    expect(counts, n, "CrossAtt production train", masked_attention=CROSS_FWD,
           masked_attention_bwd=CROSS_BWD)
    RESULT["launches"]["K3 bf16"] = counts["masked_attention"]
    RESULT["launches"]["K3b bf16"] = counts["masked_attention_bwd"]
    rows = sum(int(b["row_mask"].sum()) for b in batches[1:n])
    log(f"  CrossAtt production train (bf16, K3, int8 table, no remat, "
        f"B=1024): {1e3 * sum(times[1:]) / (n - 1):.1f} ms per step, "
        f"{rows / sum(times[1:]):.1f} interactions/s (steps 2-{n}); losses "
        f"{[round(x, 4) for x in losses]}; launches {counts}")

    # CrossAtt served: --serving 1 (bf16, int8 table), K3 in bf16
    cfg = X.apply_serving_preset(base.replace(ablation_type="CrossAtt"))
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    state = engine.init_state()
    dev_batch = {"_dev": engine.put_batch(batches[0])}
    A.reset_launch_counts()
    _, logits, _ = engine.eval_step(state, dev_batch)
    torch.cuda.synchronize()
    expect(dict(A.LAUNCHES), 1, "CrossAtt serving",
           masked_attention=CROSS_FWD)
    if logits.shape != (1024, 40) or not torch.isfinite(logits).all():
        raise AssertionError("CrossAtt serving: logits not (1024, 40) finite")
    ms = _time_ms(lambda: engine.eval_step(state, dev_batch), 5)
    share = _device_share(lambda: engine.eval_step(state, dev_batch), 3,
                          K3_NAMES[:1])
    log(f"  CrossAtt serving (--serving 1: bf16, int8, K3) latency B=1024: "
        f"{ms:.1f} ms per batch ({1e3 * 1024 / ms:.1f} interactions/s); "
        f"{CROSS_FWD} K3f per forward; K3f share of device time: " + (
            "not measured (no device times in the trace)" if share is None
            else f"{100 * share[0]:.1f}% of {share[1]:.1f} ms device time "
            "per batch (torch.profiler, 3 batches)"))
    del engine, state
    torch.cuda.empty_cache()

    # one step each: the MLP ablations launch no attention kernel; noPos and
    # fuse_projections run the 'ours' K1 route
    for what, kw, want in (
            ("CrossMLP", dict(ablation_type="CrossMLP"), {}),
            ("SelfMLP", dict(ablation_type="SelfMLP"), {}),
            ("w/oAtt", dict(ablation_type="w/oAtt"), {}),
            ("noPos", dict(ablation_type="noPos"),
             dict(two_block_attention=2 * FWD_PER_STEP,
                  two_block_attention_bwd=BWD_PER_STEP)),
            ("fuse_projections", dict(fuse_projections=True),
             dict(two_block_attention=2 * FWD_PER_STEP,
                  two_block_attention_bwd=BWD_PER_STEP))):
        times, losses, counts = train(base.replace(**kw), 1)
        expect(counts, 1, what, **want)
        log(f"  {what}: one step, loss {losses[0]:.4f}, "
            f"{1e3 * times[0]:.1f} ms (first step); launches "
            f"{ {k: v for k, v in counts.items() if v} }")

    # 32 rows, fp32, CrossAtt on K3, dropout off: card against CPU
    small = next(iter(BatchIterator(reader, reader.tables["train"], 32,
                                    feature_store=store, seed=7,
                                    prefetch_size=0)))
    one = base.replace(ablation_type="CrossAtt", train_batch_size=32,
                       dropout=0.0)
    got = {}
    for dev, table in (("cuda", ctx["table"]),
                       ("cpu", tuple(t.cpu() for t in ctx["table"]))):
        eng = InterestEngine(one, reader.n_users, reader.n_items,
                             feature_table=table, device=dev)
        A.reset_launch_counts()
        _, ld = eng.train_step(eng.init_state(), small)
        got[dev] = (float(ld["loss"]), float(eng.last_grad_norm),
                    A.LAUNCHES["masked_attention_bwd"])
        del eng, table
    if got["cuda"][2] != CROSS_BWD or got["cpu"][2] != 0:
        raise AssertionError(f"32-row CrossAtt step launches: {got}")
    dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
    log(f"  32-row fp32 CrossAtt step, card vs CPU: loss "
        f"{got['cuda'][0]:.6f} vs {got['cpu'][0]:.6f} (rel {dl:.2g}), grad "
        f"norm {got['cuda'][1]:.6f} vs {got['cpu'][1]:.6f} (rel {dg:.2g})")
    # fp32 through five layers in another summation order: 1e-4 relative
    if not (dl <= 1e-4 and dg <= 1e-4):
        raise AssertionError(f"card and CPU CrossAtt steps differ: {got}")


# launches per flagship step of the fused variants (2 backbones x 5 run
# layers): fuse_dual runs K5 on the feature backbone (Lv 40, Lu 100) and K2
# on the ID backbone, whose user stream is one long (segformerx.py:366-367);
# the last layer's user stream reaches no output, so its K2b never runs,
# while its K5b runs with a zero user gradient. fuse_layer runs K4 on every
# stream.
K2_STEP = {"proj_two_block_attention": FWD_PER_STEP,
           "proj_two_block_attention_bwd": BWD_PER_STEP}
DUAL_STEP = {"dual_stream_attention": 5, "dual_stream_attention_bwd": 5,
             "proj_two_block_attention": 10,
             "proj_two_block_attention_bwd": 9}
LAYER_STEP = {"layer_stream": FWD_PER_STEP, "layer_stream_bwd": BWD_PER_STEP}
FUSED_STEPS = 6         # timed after 2 warm-up steps
FUSED_KERNELS = ("proj_two_block_attention", "proj_two_block_attention_bwd",
                 "dual_stream_attention", "dual_stream_attention_bwd",
                 "layer_stream", "layer_stream_bwd", "two_block_attention",
                 "two_block_attention_bwd")


def phase_fused_variants(ctx):
    """The production training configuration with fuse_dual and with
    fuse_layer beside the K2 one (same batches, same card): ms per step,
    interactions/s, peak device memory and the launch counts; each served
    at B=1024; the default config with fuse_layer, which must not remat;
    one 32-row fp32 step of each on the card against the CPU."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    _data(ctx)
    reader, store = ctx["reader"], ctx["store"]
    batches = None

    def expect(counts, n, what, want):
        _expect(counts, {k: n * want.get(k, 0) for k in FUSED_KERNELS}, what)

    for name, kw, want in (("K2 (fuse_qkv)", {}, K2_STEP),
                           ("fuse_dual", dict(fuse_dual=True), DUAL_STEP),
                           ("fuse_layer", dict(fuse_layer=True), LAYER_STEP)):
        cfg = _production_train_cfg(ctx["csv"], **kw)
        engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                feature_table=ctx["table"], device="cuda")
        if batches is None:
            batches = [b for _, b in zip(range(FUSED_STEPS), BatchIterator(
                reader, reader.tables["train"], 1024, shuffle=True,
                feature_store=store, seed=cfg.seed,
                transform=engine.batch_transform))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, times, losses, counts = _train_steps(engine, batches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = len(batches)
        expect(counts, n, f"{name} train", want)
        steady = times[2:]
        rows = sum(int(b["row_mask"].sum()) for b in batches[2:])
        log(f"  {name} train (bf16, int8 table, no remat, B=1024): "
            f"{1e3 * sum(steady) / len(steady):.1f} ms per step, "
            f"{rows / sum(steady):.1f} interactions/s over {len(steady)} "
            f"steps after 2 warm-up steps; peak device memory {peak:.2f} GiB"
            f" (the 3.9M-row int8 table included); losses "
            f"{[round(x, 4) for x in losses]}; launches per step "
            f"{ {k: v // n for k, v in counts.items() if v} }")
        if name == "fuse_dual":
            RESULT["launches"]["K5"] = counts["dual_stream_attention"]
            RESULT["launches"]["K5b"] = counts["dual_stream_attention_bwd"]
        elif name == "fuse_layer":
            RESULT["launches"]["K4"] = counts["layer_stream"]
            RESULT["launches"]["K4b"] = counts["layer_stream_bwd"]
        # served: the eval forward of a full batch already on the card
        dev_batch = {"_dev": engine.put_batch(batches[0])}
        A.reset_launch_counts()
        _, logits, _ = engine.eval_step(state, dev_batch)
        torch.cuda.synchronize()
        fwd = {k: v for k, v in want.items() if not k.endswith("_bwd")}
        expect(dict(A.LAUNCHES), 1, f"{name} serving", fwd)
        if logits.shape != (1024, 40) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name} serving: logits not (1024, 40) "
                                 "finite")
        ms = _time_ms(lambda: engine.eval_step(state, dev_batch), 5)
        log(f"  {name} served (bf16) B=1024: {ms:.1f} ms per batch "
            f"({1e3 * 1024 / ms:.1f} interactions/s)")
        del engine, state, dev_batch
        torch.cuda.empty_cache()

    # the default config (fp32, remat on) with fuse_layer: K4 saves only
    # its inputs, so no layer is recomputed: 20 K4f per step, not 40
    cfg = _flagship_cfg(ctx["csv"]).replace(train_batch_size=1024,
                                            table_quant="int8",
                                            fuse_layer=True)
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    _, times, losses, counts = _train_steps(engine, batches[:2])
    expect(counts, 2, "fuse_layer default config (remat on)", LAYER_STEP)
    log(f"  fuse_layer, default config (fp32, --remat 1): {FWD_PER_STEP} K4f "
        f"+ {BWD_PER_STEP} K4b per step, no remat; "
        f"{1e3 * times[1]:.1f} ms for the second step; losses "
        f"{[round(x, 4) for x in losses]}")
    del engine
    torch.cuda.empty_cache()

    # 32 rows, fp32, dropout off: the card against the CPU's plain versions
    small = next(iter(BatchIterator(reader, reader.tables["train"], 32,
                                    feature_store=store, seed=7,
                                    prefetch_size=0)))
    cpu_table = tuple(t.cpu() for t in ctx["table"])
    base = _flagship_cfg(ctx["csv"]).replace(train_batch_size=32,
                                             table_quant="int8", dropout=0.0)
    for name, kw, key in (("fuse_dual", dict(fuse_dual=True),
                           "dual_stream_attention_bwd"),
                          ("fuse_layer", dict(fuse_layer=True),
                           "layer_stream_bwd")):
        got = {}
        for dev, table in (("cuda", ctx["table"]), ("cpu", cpu_table)):
            eng = InterestEngine(base.replace(**kw), reader.n_users,
                                 reader.n_items, feature_table=table,
                                 device=dev)
            A.reset_launch_counts()
            _, ld = eng.train_step(eng.init_state(), small)
            got[dev] = (float(ld["loss"]), float(eng.last_grad_norm),
                        A.LAUNCHES[key])
            del eng
        if not got["cuda"][2] or got["cpu"][2]:
            raise AssertionError(f"32-row {name} step launches: {got}")
        dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
        log(f"  32-row fp32 {name} step, card vs CPU: loss "
            f"{got['cuda'][0]:.6f} vs {got['cpu'][0]:.6f} (rel {dl:.2g}), "
            f"grad norm {got['cuda'][1]:.6f} vs {got['cpu'][1]:.6f} (rel "
            f"{dg:.2g})")
        # fp32 through five layers in another summation order: 1e-4
        if not (dl <= 1e-4 and dg <= 1e-4):
            raise AssertionError(f"card and CPU {name} steps differ: {got}")
    del cpu_table


V2_STEPS = 6            # timed after 2 warm-up steps
V2_SERVED = 3           # batches served at B=1024


def _launches(counts, per, n):
    """counts of K2 and K6 against `per` launches of each per step."""
    return {k: counts[k] for k in K2_KEYS + K6_KEYS}, {
        k: n * per.get(k, 0) for k in K2_KEYS + K6_KEYS}


def _subprocess_json(args, env, what, nice=0):
    """Run `python -m args` from the checkout's root with `env` (at
    `nice`); its stdout's last JSON object and its stderr. Logs the wall
    time and when each of its log lines came, for where a CLI run's time
    goes."""
    t0 = time.time()
    proc = subprocess.run((["nice", "-n", str(nice)] if nice else [])
                          + [sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    marks = []
    for ln in proc.stderr.splitlines():
        try:
            t = time.mktime(time.strptime(ln[:19], "%Y-%m-%d %H:%M:%S"))
        except ValueError:
            continue
        marks.append(f"+{t - t0:.0f} s {ln[24:70]}")
    log(f"  {what}: {time.time() - t0:.1f} s wall; log lines at "
        + "; ".join(marks[:3] + marks[-3:]))
    start = proc.stdout.rfind("\n{\n") + 1
    return (json.loads(proc.stdout[start:]) if "{" in proc.stdout else None,
            proc.stderr)


def _logged_launches(stderr, what):
    lines = [ln for ln in stderr.splitlines() if "kernel launches: " in ln]
    if not lines:
        raise AssertionError(f"{what}: no 'kernel launches' log line")
    return json.loads(lines[-1].split("kernel launches: ", 1)[1])


def phase_attn_v2(ctx):
    """SEGMM_ATTN_V2's route (K6 on every fuse_qkv stream): the production
    training configuration for V2_STEPS steps (20 K6f + 18 K6b and no K2
    per step), V2_SERVED batches served at B=1024 (20 K6f each), one 32-row
    fp32 step on the card against the CPU; then skip_train's CLI under the
    switch in this process (the flag SEGMM_ATTN_V2=1 sets at import) and
    export_logits --serving 1 on the checkpoint it wrote in a process of
    its own, SEGMM_ATTN_V2=1 in its environment, which runs on beside
    phases wide and train_cli (checked at the end of train_cli)."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    _data(ctx)
    reader, store = ctx["reader"], ctx["store"]
    per_step = {K6_KEYS[0]: FWD_PER_STEP, K6_KEYS[1]: BWD_PER_STEP}
    A.ATTN_V2 = True
    try:
        cfg = _production_train_cfg(ctx["csv"])
        engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                feature_table=ctx["table"], device="cuda")
        batches = [b for _, b in zip(range(V2_STEPS), BatchIterator(
            reader, reader.tables["train"], 1024, shuffle=True,
            feature_store=store, seed=cfg.seed,
            transform=engine.batch_transform))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, times, losses, counts = _train_steps(engine, batches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, want = _launches(counts, per_step, len(batches))
        if got != want:
            raise AssertionError(f"v2 train: launches {got}, expected {want}")
        RESULT["launches"]["K6b"] = counts[K6_KEYS[1]]
        steady = times[2:]
        rows = sum(int(b["row_mask"].sum()) for b in batches[2:])
        log(f"  v2 production train (bf16, K6, int8 table, no remat, "
            f"B=1024): {1e3 * sum(steady) / len(steady):.1f} ms per step, "
            f"{rows / sum(steady):.1f} interactions/s over {len(steady)} steps"
            f" after 2 warm-up steps; peak device memory {peak:.2f} GiB; "
            f"losses {[round(x, 4) for x in losses]}; launches per step "
            f"{ {k: v // len(batches) for k, v in got.items()} }")

        dev_batches = [{"_dev": engine.put_batch(b)}
                       for b in batches[:V2_SERVED]]
        A.reset_launch_counts()
        for b in dev_batches:
            _, logits, _ = engine.eval_step(state, b)
            if logits.shape != (1024, 40) or not torch.isfinite(logits).all():
                raise AssertionError("v2 serving: logits not (1024, 40) "
                                     "finite")
        torch.cuda.synchronize()
        got, want = _launches(dict(A.LAUNCHES), {K6_KEYS[0]: FWD_PER_STEP},
                              V2_SERVED)
        if got != want:
            raise AssertionError(f"v2 serving: launches {got}, expected "
                                 f"{want}")
        RESULT["launches"]["K6"] = got[K6_KEYS[0]]
        ms = _time_ms(lambda: [engine.eval_step(state, b)
                               for b in dev_batches], 1, warmup=0)
        log(f"  v2 served (bf16, K6) B=1024: {ms / V2_SERVED:.1f} ms per "
            f"batch over {V2_SERVED} batches ({1e3 * 1024 * V2_SERVED / ms:.1f}"
            f" interactions/s); {FWD_PER_STEP} K6f per forward")
        del engine, state, dev_batches
        torch.cuda.empty_cache()

        # 32 rows, fp32, dropout off: K6 on the card against the CPU's plain
        # version of it
        small = next(iter(BatchIterator(reader, reader.tables["train"], 32,
                                        feature_store=store, seed=7,
                                        prefetch_size=0)))
        one = _flagship_cfg(ctx["csv"]).replace(
            train_batch_size=32, table_quant="int8", dropout=0.0,
            fused_attention=True, fuse_qkv=True)
        got = {}
        for dev, table in (("cuda", ctx["table"]),
                           ("cpu", tuple(t.cpu() for t in ctx["table"]))):
            eng = InterestEngine(one, reader.n_users, reader.n_items,
                                 feature_table=table, device=dev)
            A.reset_launch_counts()
            _, ld = eng.train_step(eng.init_state(), small)
            got[dev] = (float(ld["loss"]), float(eng.last_grad_norm),
                        A.LAUNCHES[K6_KEYS[1]], A.LAUNCHES[K2_KEYS[1]])
            del eng, table
        if got["cuda"][2:] != (BWD_PER_STEP, 0) or got["cpu"][2:] != (0, 0):
            raise AssertionError(f"32-row v2 step launches: {got}")
        dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
        log(f"  32-row fp32 v2 step, card vs CPU: loss {got['cuda'][0]:.6f} "
            f"vs {got['cpu'][0]:.6f} (rel {dl:.2g}), grad norm "
            f"{got['cuda'][1]:.6f} vs {got['cpu'][1]:.6f} (rel {dg:.2g})")
        # fp32 through five layers in another summation order: 1e-4
        if not (dl <= 1e-4 and dg <= 1e-4):
            raise AssertionError(f"card and CPU v2 steps differ: {got}")
    finally:
        A.ATTN_V2 = False

    # the CLIs under the switch: skip_train here with the flag
    # SEGMM_ATTN_V2=1 sets at import, export_logits in a process of its
    # own with SEGMM_ATTN_V2=1 in its environment
    from segmminterest_tpu_torch.tasks import skip_train
    memmap, lineid = _cli_files(ctx)
    env = dict(os.environ, SEGMM_ATTN_V2="1")
    common = ["--sample_csv", ctx["csv"], "--min_interactions", "100",
              "--num_warmup", "80", "--memmap", memmap, "--lineid_map",
              lineid, "--seed", "7"]
    t0 = time.perf_counter()
    A.reset_launch_counts()
    A.ATTN_V2 = True
    try:
        with _Records("segmminterest_tpu_torch.engine.train") as logs:
            res = skip_train.main(common + [
                "--debug", "1", "--compute_dtype", "bfloat16", "--fuse_qkv",
                "1", "--table_quant", "int8", "--remat", "0", "--ckpt_dir",
                os.path.join(WORK, "train_cli_v2")])
        version = logs.args_of("projection-fused attention")[0]
    finally:
        A.ATTN_V2 = False
    launches, steps = res["kernel_launches"], res["steps"]
    if version != 2 or steps < 1 or \
            launches.get(K6_KEYS[1]) != BWD_PER_STEP * steps or \
            any(k in launches for k in K2_KEYS) or \
            not all(math.isfinite(v) for v in res["test_metrics"].values()):
        raise AssertionError(f"skip_train SEGMM_ATTN_V2=1: {steps} steps, "
                             f"launches {launches}, metrics "
                             f"{res['test_metrics']}")
    log(f"  skip_train CLI, SEGMM_ATTN_V2=1 ({time.perf_counter() - t0:.1f} "
        f"s): {steps} steps, test HR@5 {res['test_metrics']['HR@5']:.4f}; "
        f"launches {launches}")
    out_dir = os.path.join(WORK, "trained_v2_logits")
    n_test = len(ctx["reader"].tables["test"])

    def export():
        _, err = _subprocess_json(
            ["segmminterest_tpu_torch.tasks.export_logits"] + common + [
                "--serving", "1", "--splits", "test", "--work_dir",
                res["work_dir"], "--out_dir", out_dir], env,
            "export_logits (v2)")
        launches = _logged_launches(err, "export_logits (v2)")
        with open(os.path.join(out_dir, "interest_logits.json")) as f:
            served = json.load(f)
        if len(served) != n_test or not all(
                len(v) == 40 and np.isfinite(v).all()
                for v in served.values()) \
                or not launches.get(K6_KEYS[0]) or \
                any(k in launches for k in K2_KEYS):
            raise AssertionError(f"export_logits SEGMM_ATTN_V2=1: "
                                 f"{len(served)} rows of {n_test}, launches "
                                 f"{launches}")
        log(f"  export_logits --serving 1, SEGMM_ATTN_V2=1: {len(served)} "
            f"rows of 40 finite logits; launches {launches}")
    # its own process, beside phases wide and train_cli (neither times
    # anything)
    _in_background(ctx, "export_logits (v2)", export)


def _in_background(ctx, what, fn):
    """Run fn() in a thread beside the next, untimed phases; its failure
    fails the run where _join_background reads it (at the end of phase
    train_cli, or of the run). Returns its future."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    done = pool.submit(fn)
    ctx.setdefault("background", []).append((what, done, pool))
    return done


def _join_background(ctx):
    for what, done, pool in ctx.pop("background", []):
        t0 = time.perf_counter()
        try:
            done.result()
        finally:
            pool.shutdown()
        log(f"  {what}: done in the background ({time.perf_counter() - t0:.1f}"
            " s waited for it)")


# skip_train --nhead 4 (4 heads of 128 at d_model 512): one training step
# per route at B=256 over the flagship's table; the route's kernels (the
# entries "<K> D128" of the kernels JSON line) must launch
WIDE_ROUTES = (
    ("K1", "default", {}, ("two_block_attention", "two_block_attention_bwd")),
    ("K3", "default", dict(ablation_type="CrossAtt"),
     ("masked_attention", "masked_attention_bwd")),
    ("K2", "production", {},
     ("proj_two_block_attention", "proj_two_block_attention_bwd")),
    ("K6", "production", {}, K6_KEYS),
    ("K5", "production", dict(fuse_dual=True),
     ("dual_stream_attention", "dual_stream_attention_bwd")),
    ("K4", "production", dict(fuse_layer=True),
     ("layer_stream", "layer_stream_bwd")))


def phase_wide(ctx):
    """One training step per attention route at 4 heads of 128 (skip_train
    --nhead 4 at d_model 512), B=256: the default config (fp32, K1; K3
    under CrossAtt) and the production config (bf16, K2; K6 under
    SEGMM_ATTN_V2's switch, K5 under fuse_dual, K4 under fuse_layer), each
    with its kernels' launch counts nonzero and a finite loss."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    _data(ctx)
    _start_segrec_seq_clis(ctx)
    _start_segrec_runner_clis(ctx)
    _start_mmrec_background(ctx)
    reader, store = ctx["reader"], ctx["store"]
    for key, base, kw, keys in WIDE_ROUTES:
        cfg = (_flagship_cfg(ctx["csv"]).replace(table_quant="int8")
               if base == "default" else _production_train_cfg(ctx["csv"]))
        cfg = cfg.replace(nhead=WIDE_HEADS, train_batch_size=256, **kw)
        A.ATTN_V2 = key == "K6"
        try:
            engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                    feature_table=ctx["table"], device="cuda")
            batch = next(iter(BatchIterator(
                reader, reader.tables["train"], 256, shuffle=True,
                feature_store=store, seed=cfg.seed,
                transform=engine.batch_transform)))
            _, times, losses, counts = _train_steps(engine, [batch])
        finally:
            A.ATTN_V2 = False
        if not all(counts[k] for k in keys):
            raise AssertionError(f"{key} at {WIDE_HEADS} heads: launches "
                                 f"{counts}")
        RESULT["launches"][f"{key} D128"] = counts[keys[0]]
        RESULT["launches"][f"{key}b D128"] = counts[keys[1]]
        log(f"  {key} route, {cfg.compute_dtype}, {WIDE_HEADS} heads of "
            f"{cfg.d_model // WIDE_HEADS}, B=256: loss {losses[0]:.4f}, "
            f"{1e3 * times[0]:.0f} ms (first step); launches "
            f"{ {k: counts[k] for k in keys} }")
        del engine
        torch.cuda.empty_cache()


def phase_train_cli(ctx):
    """skip_train's CLI (production flags, --debug 1) over the small
    memmap, then export_logits serving the checkpoint it wrote; phase
    segrec_seq's CLI runs beside it (started by phase wide where that
    ran), waited for at its end."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.tasks import export_logits as X
    from segmminterest_tpu_torch.tasks import skip_train

    _data(ctx)
    _start_segrec_seq_clis(ctx)
    _start_segrec_runner_clis(ctx)
    _start_mmrec_background(ctx)
    memmap, lineid = _cli_files(ctx)
    common = ["--sample_csv", ctx["csv"], "--min_interactions", "100",
              "--num_warmup", "80", "--memmap", memmap, "--lineid_map",
              lineid, "--seed", "7"]
    A.reset_launch_counts()
    res = skip_train.main(common + [
        "--debug", "1", "--compute_dtype", "bfloat16", "--fuse_qkv", "1",
        "--table_quant", "int8", "--remat", "0", "--ckpt_dir",
        os.path.join(WORK, "train_cli")])
    work = res["work_dir"]
    ctx.update(cli_work=work, cli_common=common)
    for f in ("ckpt-latest.pt", "final_results.json"):
        if not os.path.exists(os.path.join(work, f)):
            raise AssertionError(f"skip_train wrote no {f}")
    if not any(f.startswith("ckpt-best-") for f in os.listdir(work)):
        raise AssertionError("skip_train wrote no ckpt-best-*.pt")
    steps = res["steps"]
    if steps < 1 or \
            A.LAUNCHES["proj_two_block_attention_bwd"] != BWD_PER_STEP * steps:
        raise AssertionError(f"skip_train CLI: {steps} steps, launches "
                             f"{A.LAUNCHES}")
    metrics = res["test_metrics"]
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"skip_train CLI: test metrics {metrics}")
    log(f"  skip_train CLI: {steps} steps, test HR@5 {metrics['HR@5']:.4f}, "
        f"{res['interactions_per_sec']:.1f} interactions/s; launches "
        f"{dict(A.LAUNCHES)}")
    out_path = X.main(common + ["--serving", "1", "--splits", "test",
                                "--work_dir", work, "--out_dir",
                                os.path.join(WORK, "trained_logits")])
    with open(out_path) as f:
        served = json.load(f)
    n_test = len(ctx["reader"].tables["test"])
    if len(served) != n_test or not all(
            len(v) == 40 and np.isfinite(v).all() for v in served.values()):
        raise AssertionError("export_logits of the trained checkpoint: "
                             f"{len(served)} rows of {n_test}")
    log(f"  export_logits --serving 1 of the trained checkpoint: "
        f"{len(served)} rows of 40 finite logits")

    # the ablation CLI (default config: fp32, K3, layer remat) and its
    # checkpoint served with --serving 1 (bf16, K3)
    abl = ["--ablation_type", "CrossAtt"]
    A.reset_launch_counts()
    res = skip_train.main(common + abl + [
        "--debug", "1", "--table_quant", "int8", "--ckpt_dir",
        os.path.join(WORK, "train_cli_crossatt")])
    steps = res["steps"]
    if steps < 1 or A.LAUNCHES["masked_attention_bwd"] != CROSS_BWD * steps \
            or A.LAUNCHES["two_block_attention"] or \
            not all(math.isfinite(v) for v in res["test_metrics"].values()):
        raise AssertionError(f"skip_train --ablation_type CrossAtt: {steps} "
                             f"steps, launches {A.LAUNCHES}, metrics "
                             f"{res['test_metrics']}")
    log(f"  skip_train --ablation_type CrossAtt: {steps} steps, test HR@5 "
        f"{res['test_metrics']['HR@5']:.4f}; launches {dict(A.LAUNCHES)}")
    A.reset_launch_counts()
    out_path = X.main(common + abl + [
        "--serving", "1", "--splits", "test", "--work_dir", res["work_dir"],
        "--out_dir", os.path.join(WORK, "trained_crossatt_logits")])
    with open(out_path) as f:
        served = json.load(f)
    if len(served) != n_test or not all(
            len(v) == 40 and np.isfinite(v).all() for v in served.values()) \
            or not A.LAUNCHES["masked_attention"] or \
            A.LAUNCHES["proj_two_block_attention"]:
        raise AssertionError("export_logits of the CrossAtt checkpoint: "
                             f"{len(served)} rows, launches {A.LAUNCHES}")
    log(f"  export_logits --serving 1 --ablation_type CrossAtt: "
        f"{len(served)} rows of 40 finite logits; launches "
        f"{ {k: v for k, v in A.LAUNCHES.items() if v} }")

    # --fuse_layer 1 (default config: fp32, K4, remat off under K4), then
    # its checkpoint served with --serving 1 --fuse_layer 1 (bf16 K4: the
    # preset's fuse_qkv is superseded)
    fl = ["--fuse_layer", "1"]
    A.reset_launch_counts()
    res = skip_train.main(common + fl + [
        "--debug", "1", "--table_quant", "int8", "--ckpt_dir",
        os.path.join(WORK, "train_cli_fuse_layer")])
    steps = res["steps"]
    if steps < 1 or A.LAUNCHES["layer_stream_bwd"] != BWD_PER_STEP * steps \
            or A.LAUNCHES["proj_two_block_attention"] or \
            A.LAUNCHES["two_block_attention"] or \
            not all(math.isfinite(v) for v in res["test_metrics"].values()):
        raise AssertionError(f"skip_train --fuse_layer 1: {steps} steps, "
                             f"launches {A.LAUNCHES}, metrics "
                             f"{res['test_metrics']}")
    log(f"  skip_train --fuse_layer 1: {steps} steps, test HR@5 "
        f"{res['test_metrics']['HR@5']:.4f}; launches "
        f"{ {k: v for k, v in A.LAUNCHES.items() if v} }")
    A.reset_launch_counts()
    out_path = X.main(common + fl + [
        "--serving", "1", "--splits", "test", "--work_dir", res["work_dir"],
        "--out_dir", os.path.join(WORK, "trained_fuse_layer_logits")])
    with open(out_path) as f:
        served = json.load(f)
    if len(served) != n_test or not all(
            len(v) == 40 and np.isfinite(v).all() for v in served.values()) \
            or not A.LAUNCHES["layer_stream"] or \
            A.LAUNCHES["proj_two_block_attention"]:
        raise AssertionError("export_logits --fuse_layer 1: "
                             f"{len(served)} rows, launches {A.LAUNCHES}")
    log(f"  export_logits --serving 1 --fuse_layer 1: {len(served)} rows of "
        f"40 finite logits; launches "
        f"{ {k: v for k, v in A.LAUNCHES.items() if v} }")
    _join_background(ctx)


# ---------------------------------------------------------------------------
# the watch-time task, the statistics tasks and the dataset builders

OURS_VALID_STEP = 12    # two validations in the epoch of 24 steps at B=1024
BASELINES = ("wlr", "d2q", "tpm")
BASELINE_TIMED = 20     # device-resident steps timed per baseline


class _Records(logging.Handler):
    """The records a logger emits while the handler is installed."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.logger, self.records = logging.getLogger(name), []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self.records = []
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def args_of(self, prefix):
        found = [r.args for r in self.records if r.msg.startswith(prefix)]
        if not found:
            raise AssertionError(f"no log line '{prefix}...'")
        return found[-1]


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return math.isfinite(x)


def phase_watchtime(ctx):
    """The watch-time task (tasks/watchtime.py): --method ours at the
    flagship width over the small memmap in the CLI's default config (fp32,
    K1, layer remat, B=1024, one epoch) with its K1 launches counted, the
    baselines at B=1024 (the CLI, then their steps timed on a batch on the
    card, then a 32-row step of each against the CPU); the statistics tasks
    in this process and in one that sees no card (the same files); the
    three dataset builders, whose directory reads back as the CSV's split
    and trains skip_train on the card."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.data.reader import SeqReader
    from segmminterest_tpu_torch.tasks import watchtime as W

    _data(ctx)
    memmap, lineid = _cli_files(ctx)
    reader = ctx["reader"]
    split = ["--sample_csv", ctx["csv"], "--min_interactions", "100",
             "--num_warmup", "80"]
    logs = _Records(W.__name__)

    # Ours: the flagship both/both model trained and tested with the
    # watch-time metrics
    A.reset_launch_counts()
    t0 = time.perf_counter()
    with logs:
        res = W.main(split + [
            "--method", "ours", "--seed", "7", "--memmap", memmap,
            "--lineid_map", lineid, "--user_input_type", "both",
            "--photo_input_type", "both", "--epochs", "1",
            "--train_batch_size", "1024", "--valid_batch_size", "1024",
            "--test_batch_size", "1024", "--valid_step",
            str(OURS_VALID_STEP), "--early_stop", "0", "--ckpt_dir",
            os.path.join(WORK, "watchtime_ours")])
    wall = time.perf_counter() - t0
    steps, batch, ips = logs.args_of("ours:")[:3]

    def n_batches(split_name):
        return -(-len(reader.tables[split_name]) // 1024)
    # a step runs each layer's forward twice (remat); every evaluation
    # batch (before training, each validation, the test split) once
    evals = (1 + steps // OURS_VALID_STEP) * n_batches("dev") \
        + n_batches("test")
    counts = dict(A.LAUNCHES)
    _expect(counts, {"two_block_attention": 2 * FWD_PER_STEP * steps
                     + FWD_PER_STEP * evals,
                     "two_block_attention_bwd": BWD_PER_STEP * steps,
                     "proj_two_block_attention": 0,
                     "proj_two_block_attention_bwd": 0},
            "watchtime --method ours")
    if steps != n_batches("train") or batch != 1024 or not _finite(res) \
            or not {"LeaveMSE", "TOP1MSE", "MAES", "pred_leave"} <= set(res):
        raise AssertionError(f"watchtime --method ours: {steps} steps at "
                             f"B={batch}, results {res}")
    log(f"  watchtime --method ours (fp32, K1, layer remat, B=1024): {steps} "
        f"steps, {ips:.1f} interactions/s ({1024e3 / ips:.1f} ms a step, "
        f"host included), {wall:.1f} s wall; LeaveMSE (MSE, MAE) "
        f"{res['LeaveMSE']}, TOP1MSE {res['TOP1MSE']}, HR@1 "
        f"{res['HR@1']:.4f}; launches {counts['two_block_attention']} K1f "
        f"+ {counts['two_block_attention_bwd']} K1b ({steps} steps, "
        f"{evals} evaluation batches)")

    # the baselines through the CLI, B=1024, --debug 1 (at most 6 steps)
    for m in BASELINES:
        with logs:
            r = W.main(split + ["--method", m, "--batch_size", "1024",
                                "--debug", "1", "--epochs", "1",
                                "--valid_step", "3", "--early_stop", "0"])
        what, n, b, ms = logs.args_of(f"%s: %d steps")[:4]
        if not (_finite(r) and 0 <= r["HR1"] <= 1 and b == 1024):
            raise AssertionError(f"watchtime --method {m}: {r}")
        log(f"  watchtime --method {m}: HR1 {r['HR1']:.4f}, MAE "
            f"{r['MAE']:.4f}; {n} steps at B=1024, {ms:.3f} ms a step "
            "(host included)")

    # their steps on a batch on the card, and 32 rows card against CPU,
    # each built by the CLI's own make_baseline
    train_t = reader.tables["train"]
    dev = torch.device("cuda")

    def first(bs):
        return next(iter(BatchIterator(reader, train_t, bs, shuffle=True,
                                       seed=7, prefetch_size=0)))
    big, small = first(1024), first(32)
    for m in BASELINES:
        args = W.build_parser().parse_args(split + ["--method", m,
                                                    "--seed", "7"])
        base = W.make_baseline(args, reader, m, dev)
        b = W.to_device(big, dev)
        ms = _time_ms(lambda: W.train_step(base.model, base.opt,
                                           base.train_loss, b),
                      BASELINE_TIMED)
        got = {}
        for d in ("cuda", "cpu"):
            model, _, loss_of = W.make_baseline(
                args, reader, m, torch.device(d), dropout=False)[:3]
            loss = loss_of(model, W.to_device(small, d))
            loss.backward()
            gn = math.sqrt(sum(float(p.grad.double().square().sum())
                               for p in model.parameters()))
            got[d] = (loss.item(), gn)
        dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
        log(f"  {m} step at B=1024, batch on the card: {ms:.3f} ms "
            f"(CUDA events, {BASELINE_TIMED} steps"
            f"{', dropout 0.2' if m == 'tpm' else ''}); 32-row fp32 step "
            f"card vs CPU: loss {got['cuda'][0]:.6f} vs {got['cpu'][0]:.6f} "
            f"(rel {dl:.2g}), grad norm {got['cuda'][1]:.6f} vs "
            f"{got['cpu'][1]:.6f} (rel {dg:.2g})")
        # fp32 MLPs, TF32 off: the same sums in another order
        if not (dl <= 1e-4 and dg <= 1e-4):
            raise AssertionError(f"{m}: card and CPU steps differ: {got}")

    # the statistics tasks (host only): here, and in a process that sees
    # no card; their files must be the same
    sdir = os.path.join(WORK, "stats")
    st = split + ["--debug", "1"]
    runs = {"here": None, "no_card": dict(os.environ, CUDA_VISIBLE_DEVICES="")}
    t0 = time.perf_counter()
    for name, env in runs.items():
        ev = st + ["--out", os.path.join(sdir, f"{name}.json")]
        ex = st + ["--out_dir", os.path.join(sdir, name)]
        if env is None:
            from segmminterest_tpu_torch.tasks import (
                export_statistics_logits, stats_eval)
            os.makedirs(sdir, exist_ok=True)
            with contextlib.redirect_stdout(io.StringIO()):  # its JSON
                stats_eval.main(ev)
            export_statistics_logits.main(ex)
        else:
            _subprocess_json(["segmminterest_tpu_torch.tasks.stats_eval"]
                             + ev, env, "stats_eval, no card")
            _subprocess_json(
                ["segmminterest_tpu_torch.tasks.export_statistics_logits"]
                + ex, env, "export_statistics_logits, no card")
    files = sorted(os.listdir(os.path.join(sdir, "here")))
    pairs = [(os.path.join(sdir, "here.json"),
              os.path.join(sdir, "no_card.json"))] + [
        (os.path.join(sdir, "here", f), os.path.join(sdir, "no_card", f))
        for f in files]
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{a} and {b} differ")
    with open(pairs[0][0]) as f:
        evaluated = json.load(f)
    if len(evaluated) != 12 or len(files) != 4 or not _finite(
            [v["all"] for v in evaluated.values()]):
        raise AssertionError(f"statistics tasks: {sorted(evaluated)}, "
                             f"{files}")
    log(f"  stats_eval ({len(evaluated)} test types) and "
        f"export_statistics_logits ({len(files)} files): the same bytes "
        f"with and without the card ({time.perf_counter() - t0:.1f} s); "
        f"prob_view_pos_static HR@1 "
        f"{evaluated['prob_view_pos_static']['all']['HR@1']:.4f}")

    # the dataset builders, with no pandas; the built directory reads back
    # as the CSV's split and trains on the card
    from segmminterest_tpu_torch.tasks import (build_interactions,
                                               build_leave_rank_data,
                                               build_segrec_data, skip_train)
    bdir = os.path.join(WORK, "built")
    raw = ["--inter_csv", ctx["csv"], "--min_interactions", "100",
           "--num_warmup", "80"]
    t0 = time.perf_counter()
    build_interactions.main(raw + ["--out", os.path.join(bdir, "SegMM")])
    build_segrec_data.main(raw + ["--out", bdir, "--name", "SegRec",
                                  "--kg_meta", "1"])
    build_leave_rank_data.main(raw + ["--out", bdir])
    built_s = time.perf_counter() - t0
    if "pandas" in sys.modules:
        raise AssertionError("a builder imported pandas")
    for f in ("SegRec/test.csv", "SegRec_CTR/item_meta.csv",
              "SegMMstep1RankingDefault/dev.csv", "SegMMdefault.inter",
              "photo_id2frame_id_leave.json"):
        if not os.path.getsize(os.path.join(bdir, f)):
            raise AssertionError(f"builder wrote no {f}")
    back = SeqReader.from_dir(os.path.join(bdir, "SegMM"))
    for s in ("train", "dev", "test"):
        for fld in ("user_raw", "video_raw", "time_ms", "labels",
                    "user_idx", "item_idx", "position"):
            if not np.array_equal(getattr(back.tables[s], fld),
                                  getattr(reader.tables[s], fld)):
                raise AssertionError(f"built {s} {fld} differs from the "
                                     "CSV's split")
    if back.user_input_dict != reader.user_input_dict:
        raise AssertionError("built user_input_dict differs")
    A.reset_launch_counts()
    res = skip_train.main(["--path", os.path.join(bdir, "SegMM"),
                           "--user_input_type", "id", "--photo_input_type",
                           "id", "--debug", "1", "--seed", "7", "--ckpt_dir",
                           os.path.join(WORK, "built_train")])
    if res["steps"] < 1 or not A.LAUNCHES["two_block_attention_bwd"] or \
            not _finite(res["test_metrics"]):
        raise AssertionError(f"skip_train --path <built>: {res['steps']} "
                             f"steps, launches {A.LAUNCHES}, "
                             f"{res['test_metrics']}")
    log(f"  build_interactions, build_segrec_data, build_leave_rank_data: "
        f"{built_s:.1f} s, no pandas; the built SegMM/ reads back as the "
        f"CSV's split; skip_train --path on it (id/id): {res['steps']} "
        f"steps, test HR@5 {res['test_metrics']['HR@5']:.4f}, "
        f"{A.LAUNCHES['two_block_attention_bwd']} K1b")


# ---------------------------------------------------------------------------
# the JAX package's .msgpack checkpoints, written here without flax

def _mp_len(out, n, fix, fix_n, codes):
    if fix is not None and n < fix_n:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    else:
        out += bytes((codes[2],)) + struct.pack(">I", n)


def _mp_pack(obj, out):
    """msgpack as flax's to_bytes writes it (msgpack-python's packb with
    use_bin_type): arrays (numpy, or torch bf16) as ext type 1, (shape,
    dtype name, C-order bytes)."""
    if obj is None or obj is True or obj is False:
        out += {None: b"\xc0", False: b"\xc2", True: b"\xc3"}[obj]
    elif isinstance(obj, int):
        out += (bytes((obj,)) if 0 <= obj < 128 else
                struct.pack(">b", obj) if -32 <= obj < 0 else
                b"\xd3" + struct.pack(">q", obj))
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        _mp_len(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, bytes):
        _mp_len(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, dict):
        _mp_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _mp_pack(k, out)
            _mp_pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _mp_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _mp_pack(v, out)
    else:
        t = obj.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else \
            str(t.numpy().dtype)
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy().tobytes()
        payload = bytearray()
        _mp_pack([list(t.shape), name, raw], payload)
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out += bytes((0xd4 + (1, 2, 4, 8, 16).index(n), 1))
        else:
            _mp_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
            out.append(1)
        out += payload


def _flax_tree(model, state_dict, chunked=()):
    """The flax params tree of a port state dict (the inverse of
    models/convert.py's rules: Linear weight -> Dense kernel (in, out),
    Embedding -> embedding, LayerNorm weight -> scale, layers.{i} ->
    layer_{i}, {stream}_proj.{j} -> {stream}_proj_{j}); the keys in
    `chunked` as flax's chunked leaves, in three flat chunks."""
    mods = dict(model.named_modules())
    tree = {}
    for key, t in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        m = mods[mod]
        if isinstance(m, torch.nn.Linear) and leaf == "weight":
            leaf, t = "kernel", t.T.contiguous()
        elif isinstance(m, torch.nn.Embedding):
            leaf = "embedding"
        elif isinstance(m, torch.nn.LayerNorm) and leaf == "weight":
            leaf = "scale"
        path = []
        for p in mod.split(".") if mod else []:
            if p.isdigit():
                path[-1] = ("layer_" if path[-1] == "layers"
                            else path[-1] + "_") + p
            else:
                path.append(p)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if key in chunked:
            flat = t.reshape(-1)
            k = -(-flat.numel() // 3)
            t = {"__msgpack_chunked_array__": True,
                 "shape": {str(i): s for i, s in enumerate(t.shape)},
                 "chunks": {str(i): flat[i * k:(i + 1) * k]
                            for i in range(3)}}
        node[leaf] = t
    return tree


def phase_msgpack(ctx):
    """The flagship weights phase train_cli trained, written as the JAX
    package's CheckPointer writes them (flax's msgpack layout and ext
    types; the PE tables as bf16 leaves, the item embedding as a chunked
    leaf), served by export_logits --work_dir with --serving 1: the logits
    bit for bit those served from a ckpt-latest.pt of the same weights. A
    directory holding both kinds raises. The run's AdamW state goes beside
    the params as optax's state; training resumed from the .msgpack and
    from its .pt twin gives the same losses, bit for bit."""
    from segmminterest_tpu_torch.engine.checkpoint import (CheckPointer,
                                                           msgpack_restore)
    from segmminterest_tpu_torch.models.convert import flax_to_state_dict
    from segmminterest_tpu_torch.models.interest import SegInterestModel
    from segmminterest_tpu_torch.tasks import export_logits as X

    if "cli_work" not in ctx:
        raise AssertionError("phase msgpack serves the checkpoint of phase "
                             "train_cli: run that first")
    work, common, reader = ctx["cli_work"], ctx["cli_common"], ctx["reader"]
    saved = torch.load(os.path.join(work, "ckpt-latest.pt"),
                       map_location="cpu", weights_only=True)
    sd = {k: (v.to(torch.bfloat16) if k.endswith("_pe") else v)
          for k, v in saved["state"]["params"].items()}
    with torch.device("meta"):
        model = SegInterestModel(
            d_model=D_MODEL, num_heads=HEADS, num_layers=6, ff_dim=D_MODEL,
            n_users=reader.n_users, n_items=reader.n_items, fusion_heads=2)
    chunked = [max(sd, key=lambda k: sd[k].numel())]
    tree = _flax_tree(model, sd, chunked)
    # the AdamW state as optax's chain(clip_by_global_norm, adamw) state:
    # {"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2": {}}}, the PE
    # tables' moments in bf16 as their params
    opt = saved["state"]["opt_state"]
    names = list(saved["state"]["params"])
    moments = {m: {n: opt["state"][i][k] for i, n in enumerate(names)}
               for m, k in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    moments = {m: {n: (v.to(torch.bfloat16) if n.endswith("_pe") else v)
                   for n, v in d.items()} for m, d in moments.items()}
    count = int(opt["state"][0]["step"])
    opt_tree = {"0": {}, "1": {"0": {
        "count": torch.tensor(count, dtype=torch.int32),
        "mu": _flax_tree(model, moments["mu"]),
        "nu": _flax_tree(model, moments["nu"])}, "1": {}, "2": {}}}
    packed = bytearray()
    _mp_pack({"state": {"params": tree, "opt_state": opt_tree},
              "num_epochs": 1, "metrics": {"main_metric": 0.5}}, packed)
    name = os.path.basename(work.rstrip("/"))
    mdir = os.path.join(WORK, "msgpack", name)
    pdir = os.path.join(WORK, "msgpack_pt", name)
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, "ckpt-latest.msgpack"), "wb") as f:
        f.write(packed)
    twin = {k: v.float() for k, v in sd.items()}  # bf16 is exact in fp32
    twin_opt = {"state": {i: {
        "step": torch.tensor(float(count)),
        "exp_avg": moments["mu"][n].float(),
        "exp_avg_sq": moments["nu"][n].float()} for i, n in enumerate(names)},
        "param_groups": opt["param_groups"]}
    CheckPointer("main_metric", pdir, mode="max").save_checkpoint(
        {"params": twin, "opt_state": twin_opt}, 1)
    # the encoder's layout is the reader's and the converter's: the file
    # reads back to the same tensors
    back = flax_to_state_dict(msgpack_restore(bytes(packed))["state"]
                              ["params"], model)
    if any(not torch.equal(back[k], v) for k, v in twin.items()):
        raise AssertionError("the .msgpack file reads back other weights")
    served = {}
    for kind, d in (("msgpack", mdir), ("pt", pdir)):
        t0 = time.perf_counter()
        out = X.main(common + ["--serving", "1", "--splits", "test",
                               "--ckpt_mode", "latest", "--work_dir", d,
                               "--out_dir", os.path.join(WORK, f"{kind}_logits")])
        with open(out) as f:
            served[kind] = json.load(f)
        log(f"  export_logits --serving 1 --work_dir <{kind}>: "
            f"{len(served[kind])} rows ({time.perf_counter() - t0:.1f} s)")
    n_test = len(reader.tables["test"])
    if len(served["msgpack"]) != n_test or served["msgpack"] != served["pt"]:
        diff = max(float(np.abs(np.subtract(served["msgpack"][k],
                                            served["pt"][k])).max())
                   for k in served["pt"] if k in served["msgpack"])
        raise AssertionError(f".msgpack served {len(served['msgpack'])} "
                             f"rows of {n_test}, max |diff| from .pt {diff}")
    both = os.path.join(WORK, "msgpack_both")
    os.makedirs(both, exist_ok=True)
    for src in (os.path.join(mdir, "ckpt-latest.msgpack"),
                os.path.join(pdir, "ckpt-latest.pt")):
        dst = os.path.join(both, os.path.basename(src))
        if not os.path.lexists(dst):
            os.symlink(src, dst)
    try:
        CheckPointer("main_metric", both).load_checkpoint(
            {"params": twin}, "latest")
        raise AssertionError("a directory with both kinds was read")
    except ValueError as e:
        if "msgpack" not in str(e) or ".pt" not in str(e):
            raise
    n_bf16 = sum(k.endswith("_pe") for k in sd)
    log(f"  .msgpack ({len(packed) / 2**20:.1f} MiB, {len(sd)} leaves, "
        f"{n_bf16} bf16, {chunked[0]} chunked): logits bit for bit the .pt "
        "twin's; a directory with both kinds raises")
    # training resumed from each (skip_train --load 1's route): the same
    # losses, bit for bit
    losses = {kind: _resume_losses(ctx, d, RESUME_STEPS)
              for kind, d in (("msgpack", mdir), ("pt", pdir))}
    ctx.pop("resume_table")
    if losses["msgpack"] != losses["pt"] or not _finite(losses["pt"]):
        raise AssertionError(f"resumed losses: {losses}")
    log(f"  training resumed from the .msgpack (params and optax's AdamW "
        f"state, count {count}) and from its .pt twin: {RESUME_STEPS} steps, "
        f"losses {losses['pt']} bit for bit")


RESUME_STEPS = 2


def _resume_losses(ctx, work_dir, steps):
    """train_cli's configuration (bf16, K2, int8 table, no remat, --debug's
    B=128) resumed from work_dir's ckpt-latest on the card: the losses of
    `steps` steps on the train split's first batches."""
    from segmminterest_tpu_torch.core.numerics import quantize_table_int8
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.data.feature_store import FeatureStore
    from segmminterest_tpu_torch.engine.checkpoint import CheckPointer
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import skip_train

    memmap, lineid = _cli_files(ctx)
    cfg = skip_train.config_from_args(skip_train.build_parser().parse_args(
        ctx["cli_common"] + ["--debug", "1", "--compute_dtype", "bfloat16",
                             "--fuse_qkv", "1", "--table_quant", "int8",
                             "--remat", "0"]))
    reader = ctx["reader"]
    store = FeatureStore.open(memmap, lineid)
    if "resume_table" not in ctx:  # the int8 table, quantized once
        ctx["resume_table"] = tuple(
            torch.from_numpy(a).cuda()
            for a in quantize_table_int8(np.asarray(store.feat)))
    torch.manual_seed(cfg.seed)  # nn.Dropout's masks
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["resume_table"])
    ckpt = CheckPointer("main_metric", work_dir, mode="max")
    state = ckpt.load_checkpoint(engine.init_state(), "latest")["state"]
    it = BatchIterator(reader, reader.tables["train"], cfg.train_batch_size,
                       shuffle=True, feature_store=store, seed=cfg.seed,
                       prefetch_size=0)
    out = []
    for _, batch in zip(range(steps), it):
        state, ld = engine.train_step(state, batch)
        out.append(float(ld["loss"]))
    return out


# ---------------------------------------------------------------------------
# SegRec (Task 2) fed by Task 1's logits

SEGREC_EPOCHS = 1       # epochs of each segrec.main run
SEGREC_B = 512          # segrec.main's --batch_size default
SEGREC_TIMED = 10       # full-width steps timed per model
SEGREC_MODELS = ("ClipWDRec", "ClipDINRec")
SEGREC_RTOL = 1e-6      # card against CPU, the 32-row steps
# ClipDINRec's fp32 step is conditioned worse: its BatchNorms take
# E[x^2] - E[x]^2 in fp32 (flax's fast variance) over 1,280 rows of one
# scale, and its attention sums unnormalised sigmoid scores. Its gradient
# norm reads 2.4e-6 relative against fp64 on the CPU alone at the inputs
# of the weights-of-ones step (tests/test_torch_segrec.py::
# test_chip_step_fp32_against_fp64, which holds each model's step here to
# fp64 on the CPU); two fp32 runs may differ by twice that: held to 1e-5
SEGREC_RTOL_CLIPDIN = 1e-5
SEGREC_TRIES = 20       # batches tried for a 32-row step with a gradient
# the side-by-side segrec.main runs: (model, flags); the CTR runs go
# SEGREC_EPOCHS epochs, the ranking legs (--model_mode TopK over the SegMM
# split, 100 candidates a row, at SEGREC_RANK_EVAL_B rows an evaluation
# batch) one
SEGREC_RANK_EVAL_B = 128
SEGREC_CLI = (("ClipWDRec", ()), ("ClipDINRec", ()),
              ("DIEN", ("--alpha_aux", "0.1")), ("ClipCANRec", ()),
              ("ClipWDRec", ("--model_mode", "TopK")),
              ("ClipDINRec", ("--model_mode", "TopK")))
# the other context models at segrec.main's defaults, and DIEN and CAN
# once more with the auxiliary loss on (segrec.main passes CAN no
# --alpha_aux, as the JAX CLI does: its run draws the history negatives
# and trains CAN as without)
SEGREC_CONTEXT = ("FM", "DeepFM", "AFM", "xDeepFM", "SAM", "DCN", "DCNv2",
                  "AutoInt", "FinalMLP", "AdaGIN", "DIEN", "CAN", "SDIM",
                  "ETA", "ClipDCNv2Rec", "ClipAutoIntRec", "ClipFinalMLPRec",
                  "ClipAdaGINRec", "ClipDIENRec", "ClipCANRec")
SEGREC_CONTEXT_TIMED = tuple((n, ()) for n in SEGREC_CONTEXT) + (
    ("DIEN", ("--alpha_aux", "0.1")), ("CAN", ("--alpha_aux", "0.1")))
# the context models' 32-row steps, card against CPU: 1e-5 relative, or
# SEGREC_COND times what fp32 rounding alone moves the CPU's step from
# fp64 (the most of its loss, gradient norm and scores) where that is
# more. DCNv2's and ClipDCNv2Rec's six crosses on N(0, 1) weights (the JAX
# model's init) amplify rounding: on the CPU their fp32 gradient norms sit
# 5.1e-4 and 4.3e-3 from fp64, their scores 1.8e-4 and 2.8e-4, and the
# card's loss 2.1e-5 from the CPU's where the CPU's sits 1.3e-6 from fp64;
# the other models' within 2.3e-6
SEGREC_RTOL_CONTEXT = 1e-5
SEGREC_COND = 4


def _segrec_lineid(corpus, rows, n_lines=None):
    """"{item}-{frame}" -> line over the corpus's items (the dense item ids
    SegRec's feeds look segments up by), the first min(duration, 40)
    segments of each, at most `rows` entries; lines strided over `n_lines`
    table rows (None: one row per entry, the layout FeatureStore.open reads
    from a memmap)."""
    dur = np.minimum(corpus.item_features_arr["i_duration"], 40)
    total = min(rows, int(dur[1:].sum()))
    stride = 1 if n_lines is None else max(1, n_lines // max(1, total))
    n_lines = total if n_lines is None else n_lines
    out, line = {}, 0
    for iid in range(1, corpus.n_items):
        for f in range(int(dur[iid])):
            if line == total:
                return out
            out[f"{iid}-{f}"] = (line * stride) % n_lines
            line += 1
    return out


def _segrec_model(name, corpus, frames, seed=0, extra=()):
    """segrec.main's model at its defaults (emb 64, [64] layers), or with
    the flags `extra`."""
    from segmminterest_tpu_torch.segrec import main as M
    args = M.build_parser().parse_args(["--model_name", name, *extra])
    args.random_seed = seed
    return M.build_model(args, corpus, use_frames=frames)


def _segrec_builder(corpus, name, store, clip, phase="train", extra=()):
    """segrec.main's CTR builder of `phase` for model `name` under the
    flags `extra` (--alpha_aux draws DIEN's history negatives)."""
    from segmminterest_tpu_torch.segrec import main as M
    from segmminterest_tpu_torch.segrec.feeds import FeedBuilder
    args = M.build_parser().parse_args(["--model_name", name, *extra])
    hist = name in M.SEQ_MODELS
    return FeedBuilder(corpus, phase, task="ctr", include_history=hist,
                       neg_history=args.alpha_aux > 0 and hist,
                       clip_weights=clip, feature_store=store, seed=0)


def phase_segrec(ctx):
    """SegRec fed by Task 1 on the card: (a) build_interactions and
    build_segrec_data over the synthetic CSV, export_logits --serving 1 of
    train_cli's flagship checkpoint over the three splits (K2f's launches
    counted), then segrec.main over those logits and a segment table in
    six processes side by side (SEGREC_CLI: ClipWDRec, ClipDINRec, DIEN
    --alpha_aux 0.1 and ClipCANRec in CTR mode, ClipWDRec and ClipDINRec
    --model_mode TopK: finite metrics, each process's peak device memory);
    (c) meanwhile, untimed, one 32-row fp32 step of each case of
    _segrec_checks and _segrec_seq_checks on the card and on the CPU; (b)
    then
    ClipWDRec's and ClipDINRec's training steps and an evaluation batch at
    B=512 over a 3,920,483-row fp32 table on the card: ms per step,
    interactions/s, peak device memory. The table stays for phase
    segrec_models."""
    from segmminterest_tpu_torch.tasks import build_interactions
    from segmminterest_tpu_torch.tasks import build_segrec_data

    if "cli_work" not in ctx:
        raise AssertionError("phase segrec serves the checkpoint of phase "
                             "train_cli: run that first")
    memmap, lineid = _cli_files(ctx)
    sdir = os.path.join(WORK, "segrec")
    t0 = time.perf_counter()
    split = ["--min_interactions", "100", "--num_warmup", "80"]
    task1 = os.path.join(sdir, "task1")
    build_interactions.main(["--inter_csv", ctx["csv"], "--out", task1]
                            + split)
    build_segrec_data.main(["--inter_csv", ctx["csv"], "--out", sdir,
                            "--name", "SegMM"] + split)
    log(f"  build_interactions + build_segrec_data: "
        f"{time.perf_counter() - t0:.1f} s")
    _segrec_cli_and_checks(ctx, sdir, task1, memmap, lineid,
                           dict(os.environ))
    _segrec_tables(ctx)


def _segrec_cli_and_checks(ctx, sdir, task1, memmap, lineid, env):
    """Phase segrec's (a) and (c): Task 1's logits through export_logits,
    then segrec.main in processes side by side beside the 32-row checks."""
    from concurrent.futures import ThreadPoolExecutor

    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.segrec.corpus import Corpus
    from segmminterest_tpu_torch.segrec.feeds import ClipWeights
    from segmminterest_tpu_torch.tasks import export_logits as X

    # (a) Task 1's logits through export_logits, then segrec.main
    A.reset_launch_counts()
    t0 = time.perf_counter()
    logits_path = X.main(["--path", task1, "--memmap", memmap,
                          "--lineid_map", lineid, "--seed", "7",
                          "--serving", "1", "--work_dir", ctx["cli_work"],
                          "--out_dir", os.path.join(sdir, "logits")])
    reader = ctx["reader"]
    n_batches = sum(-(-len(reader.tables[s]) // 1024)
                    for s in ("train", "dev", "test"))
    k2f = A.LAUNCHES["proj_two_block_attention"]
    if k2f != FWD_PER_STEP * n_batches:
        raise AssertionError(f"export_logits --serving 1: {k2f} K2f "
                             f"launches for {n_batches} batches")
    with open(logits_path) as f:
        n_logits = len(json.load(f))
    log(f"  export_logits --serving 1 over train/dev/test: {n_logits} rows, "
        f"{n_batches} batches, {k2f} K2f launches "
        f"({time.perf_counter() - t0:.1f} s)")
    corpus = Corpus(sdir, "SegMM_CTR")
    seg_map = _segrec_lineid(corpus, ctx["memmap_rows"])
    seg_lineid = os.path.join(sdir, "lineid.json")
    with open(seg_lineid, "w") as f:
        json.dump(seg_map, f)

    def run_main(case):
        name, extra = case
        ranking = "--model_mode" in extra
        argv = ["segmminterest_tpu_torch.segrec.main", "--model_name", name,
                "--path", sdir, "--clip_weight_path", logits_path,
                "--clip_feature_memmap", memmap, "--lineid_map", seg_lineid,
                *extra]
        argv += (["--dataset", "SegMM", "--epoch", "1",
                  "--eval_batch_size", str(SEGREC_RANK_EVAL_B)] if ranking
                 else ["--dataset", "SegMM_CTR",
                       "--epoch", str(SEGREC_EPOCHS)])
        return _subprocess_json(argv, env, "segrec.main " + " ".join(
            [name, *extra]))
    # side by side, and beside the untimed 32-row checks (c) and phase
    # segrec_seq's 32-row checks: none is timed
    rank = Corpus(sdir, "SegMM")
    seq_cache = ctx.setdefault("segrec_seq_builders", {})
    with ThreadPoolExecutor(len(SEGREC_CLI)) as pool:
        running = [pool.submit(run_main, case) for case in SEGREC_CLI]
        id2 = [json.load(open(os.path.join(sdir, "SegMM_CTR", f)))
               for f in ("id2user.json", "id2item.json")]
        clip = ClipWeights(logits_path, *id2)
        _segrec_checks(corpus, clip)
        _segrec_seq_checks(rank, seq_cache, torch.device("cuda"))
        if "segrec_runner_prep" in ctx:
            _segrec_runner_checks(ctx)
        _mmrec_checks(ctx)
        results = [f.result() for f in running]
    for (name, extra), (res, err) in zip(SEGREC_CLI, results):
        ranking = "--model_mode" in extra
        keys = (("HR@5", "NDCG@5", "HR@50", "NDCG@50") if ranking
                else ("AUC", "LOG_LOSS", "WUAUC"))
        got = {s: {k: res[s][k] for k in keys} for s in ("dev", "test")}
        if not _finite(got):
            raise AssertionError(f"segrec.main {name} {extra}: metrics "
                                 f"{got}")
        peak = [ln.split("peak device memory: ", 1)[1] for ln in
                err.splitlines() if "peak device memory: " in ln]
        what = (f"TopK, 1 epoch, B={SEGREC_B}, evaluation batches of "
                f"{SEGREC_RANK_EVAL_B} rows x 100 candidates" if ranking
                else f"CTR, {SEGREC_EPOCHS} epochs, B={SEGREC_B}")
        log(f"  segrec.main {' '.join([name, *extra])} ({what}): dev "
            f"{got['dev']}, test {got['test']}; peak device memory "
            f"{peak[-1] if peak else 'not logged'}")
    ctx["segrec"] = dict(sdir=sdir, corpus=corpus, logits=logits_path,
                         lineid=seg_lineid, clip=clip)
    ctx["segrec_rank"] = rank   # phase segrec_seq's ranking corpus


def _segrec_tables(ctx):
    """Phase segrec's (b), its timed steps, after the CLIs have ended."""
    from segmminterest_tpu_torch.data.feature_store import FeatureStore
    from segmminterest_tpu_torch.segrec.runner import CTRRunner, RunnerConfig
    sr = ctx["segrec"]
    corpus, clip = sr["corpus"], sr["clip"]

    # (b) full width: the fp32 table of 3,920,483 rows on the card
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.empty(PRODUCTION_ROWS, FEAT_DIM, device=dev)
    for s in range(0, PRODUCTION_ROWS, 1 << 19):
        e = min(PRODUCTION_ROWS, s + (1 << 19))
        table[s:e] = torch.randn(e - s, FEAT_DIM, generator=g, device=dev)
    full_map = _segrec_lineid(corpus, 10 ** 9, PRODUCTION_ROWS)
    stub = np.broadcast_to(np.zeros((1, FEAT_DIM), np.float32),
                           (PRODUCTION_ROWS, FEAT_DIM))
    store = FeatureStore(stub, full_map)
    covered = float(np.mean([k in clip.table for k in (
        clip._key(u, i, t) for u, i, t in zip(
            corpus.data_df["train"]["user_id"],
            corpus.data_df["train"]["item_id"],
            corpus.data_df["train"]["time"]))]))
    log(f"  table {PRODUCTION_ROWS} x {FEAT_DIM} fp32 on the card "
        f"({table.numel() * 4 / 1e9:.2f} GB); {len(full_map)} segments of "
        f"{corpus.n_items - 1} items; Task-1 logits for {covered:.1%} of the "
        "train rows")
    for name in SEGREC_MODELS:
        b = _segrec_builder(corpus, name, store, clip)
        feeds = list(itertools.islice(b.batches(SEGREC_B, shuffle=True),
                                      SEGREC_TIMED + 2))
        r = CTRRunner(_segrec_model(name, corpus, True),
                      RunnerConfig(batch_size=SEGREC_B,
                                   eval_batch_size=SEGREC_B,
                                   metrics=("AUC",)),
                      feat_table=table, device=dev)
        for feed in feeds[:2]:  # warm-up
            r.train_step(feed, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for i, feed in enumerate(feeds[2:]):
            loss = r.train_step(feed, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(feeds[2:])
        peak = torch.cuda.max_memory_allocated()
        if not math.isfinite(float(loss)):
            raise AssertionError(f"{name}: loss {float(loss)}")
        eval_ms = _time_ms(lambda: r.eval_scores(feeds[0]), 10)
        log(f"  {name} CTR at B={SEGREC_B} over the fp32 table: "
            f"{ms:.2f} ms/step ({SEGREC_B / ms * 1e3:.0f} interactions/s, "
            f"{len(feeds) - 2} steps after 2 warm-up, host batches "
            f"assembled before), eval batch {eval_ms:.2f} ms, peak device "
            f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
            f"GiB above the {base / 2**30:.2f} GiB held before)")
        del r
    # phase segrec_models steps the context models over the same table
    ctx["segrec"].update(table=table, store=store, clip=clip)
    del table


def _segrec_checks(corpus, clip):
    """Phase segrec's (c): one 32-row fp32 step of each case of
    _segrec_steps on the card and on the CPU: ClipWDRec, ClipDINRec,
    WideDeep and DIN (1e-6; ClipDINRec 1e-5), then each context model of
    SEGREC_CONTEXT with interest weights of ones (SEGREC_RTOL_CONTEXT, or
    SEGREC_COND times the CPU's step's own fp32 rounding where that is
    more); each beside the CPU's fp32 step against fp64."""
    dev = torch.device("cuda")
    for name, what, tried, card, cpu, fp64 in _segrec_steps(
            corpus, clip, dev):
        err, rounding = _rel_errs(card, cpu), _rel_errs(cpu, fp64)
        if max(err) > (SEGREC_RTOL_CLIPDIN if name == "ClipDINRec"
                       else SEGREC_RTOL):
            raise AssertionError(f"{name} 32-row step ({what}): card "
                                 f"{card[:2]}, CPU {cpu[:2]}, relative "
                                 f"errors {err}")
        log(f"  {name} 32-row fp32 step ({what}, batch {tried}), card "
            f"against the CPU: loss {card[0]:.6f} ({err[0]:.1e} relative), "
            f"gradient norm {card[1]:.6f} ({err[1]:.1e}), evaluation "
            f"scores {err[2]:.1e}; the CPU's against fp64: "
            + ", ".join(f"{e:.1e}" for e in rounding))
    for name, what, tried, card, cpu, fp64 in _segrec_steps(
            corpus, None, dev,
            cases=[(n, None, ()) for n in SEGREC_CONTEXT]):
        err, rounding = _rel_errs(card, cpu), _rel_errs(cpu, fp64)
        limit = max(SEGREC_RTOL_CONTEXT, SEGREC_COND * max(rounding))
        if max(err) > limit:
            raise AssertionError(f"{name} 32-row step ({what}): card "
                                 f"{card[:2]}, CPU {cpu[:2]}, relative "
                                 f"errors {err} against {limit}")
        log(f"  {name} 32-row fp32 step ({what}, batch {tried}), card "
            f"against the CPU: loss {card[0]:.6f} ({err[0]:.1e} relative), "
            f"gradient norm {card[1]:.6f} ({err[1]:.1e}), evaluation "
            f"scores {err[2]:.1e}; the CPU's against fp64: "
            + ", ".join(f"{e:.1e}" for e in rounding)
            + f"; limit {limit:.1e}")


def _rel_errs(got, want):
    """|got - want| relative to |want| for the loss and the gradient norm,
    to max |want| for the scores; 0 where both are 0 (a batch whose rows
    all sit at BCE's clamp has no gradient)."""
    out = [abs(a - b) / abs(b) if b else float(a != 0)
           for a, b in zip(got[:2], want[:2])]
    scale = np.abs(want[2]).max()
    return out + [float(np.abs(got[2] - want[2]).max() / scale)
                  if scale else float(np.abs(got[2]).max() != 0)]


def _segrec_steps(corpus, clip, dev, cases=None):
    """One 32-row CTR step of each case on `dev`, on the CPU and on the CPU
    in fp64, from the same weights and batch: (name, what, batch number,
    then (loss, gradient norm, evaluation scores before the step) on dev,
    on the CPU and in fp64). Each model with interest weights of ones,
    whose inputs do not depend on how train_cli's run went (`--debug`
    stops its epochs early, and the abandoned prefetch thread draws from
    the iterator's generator); then the Clip models under `clip`'s Task-1
    logits, and ClipDINRec with them under --norm_interest_type softmax.
    The first batch of SEGREC_TRIES with a gradient is taken. Raw Task-1
    logits can push every row of every batch past BCE's clamp (the sum of
    40 weighted segments), and their cases then compare the first batch's
    loss and scores; every other case must have a gradient."""
    import copy

    from segmminterest_tpu_torch.data.feature_store import FeatureStore
    from segmminterest_tpu_torch.segrec.runner import CTRRunner, RunnerConfig
    small = torch.randn(4096, FEAT_DIM, generator=torch.Generator()
                        .manual_seed(5))
    small_store = FeatureStore(small.numpy(),
                               _segrec_lineid(corpus, 10 ** 9, 4096))

    def step(model, feed, frames, where, dtype=torch.float32):
        r = CTRRunner(copy.deepcopy(model).to(dtype),
                      RunnerConfig(batch_size=32),
                      feat_table=small.to(dtype) if frames else None,
                      device=where)
        # AdaGIN's Gumbel noise drawn on the host from one seed: the card
        # and the CPU draw the same (no dropout here)
        r.generator = torch.Generator()
        scores = r.eval_scores(feed).astype(np.float64)
        loss = float(r.train_step(feed, 0))
        norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in r.model.parameters())))
        return loss, norm, scores

    out = []
    softmax = ("--norm_interest_type", "softmax")
    cases = cases or (
        [(n, None, ()) for n in SEGREC_MODELS + ("WideDeep", "DIN")]
        + [(n, clip, ()) for n in SEGREC_MODELS]
        + [("ClipDINRec", clip, softmax)])
    for name, weights, extra in cases:
        frames = name.startswith("Clip")
        need_grad = weights is None or bool(extra)
        b = _segrec_builder(corpus, name, small_store if frames else None,
                            weights, extra=extra)
        model = _segrec_model(name, corpus, frames, extra=extra)
        first = None
        for tried, feed in zip(range(1, SEGREC_TRIES + 1),
                               b.batches(32, shuffle=True)):
            cpu = step(model, feed, frames, "cpu")
            first = first or (tried, feed, cpu)
            if cpu[1] > 0:
                break
        else:
            if need_grad:
                raise AssertionError(f"{name}: no gradient in "
                                     f"{SEGREC_TRIES} 32-row batches")
            tried, feed, cpu = first
        what = ("weights of ones" if weights is None else
                " ".join(("Task-1 logits",) + extra))
        if not cpu[1]:
            what += ", no gradient in any batch"
        out.append((name, what, tried, step(model, feed, frames, dev), cpu,
                    step(model, feed, frames, "cpu", torch.float64)))
    return out


def phase_segrec_models(ctx):
    """SegRec's other context models on the card, after phase segrec and
    over its fp32 table: (a) each of SEGREC_CONTEXT at segrec.main's
    defaults (CTR, emb 64, [64] layers, B=512; the Clip variants over the
    3,920,483-row table), DIEN and CAN once more with --alpha_aux 0.1:
    SEGREC_TIMED training steps timed after 2, an evaluation batch, ms a
    step, interactions/s, peak device memory; (b) ClipDINRec's ranking
    evaluation at segrec.main's default --eval_batch_size 512 (100
    candidates a row) over the CLIs' segment table: whether it fits on the
    card (a finding either way, not a failure). Their 32-row steps card
    against CPU run in phase segrec (_segrec_checks)."""
    from segmminterest_tpu_torch.data.feature_store import FeatureStore
    from segmminterest_tpu_torch.segrec.feeds import FeedBuilder
    from segmminterest_tpu_torch.segrec.runner import (CTRRunner,
                                                       RankingRunner,
                                                       RunnerConfig)
    from segmminterest_tpu_torch.segrec.corpus import Corpus

    if "segrec" not in ctx:
        raise AssertionError("phase segrec_models runs on phase segrec's "
                             "data and table: run that first")
    sr = ctx.pop("segrec")
    corpus, table, store, clip = (sr["corpus"], sr["table"], sr["store"],
                                  sr["clip"])
    sdir, seg_lineid = sr["sdir"], sr["lineid"]
    dev = torch.device("cuda")
    # (a) each model's steps at full width; the host batches of each kind
    # of builder made once, before
    feeds = {}
    for name, extra in SEGREC_CONTEXT_TIMED:
        b = _segrec_builder(corpus, name, store, clip, extra=extra)
        kind = (b.include_history, b.neg_history)
        if kind not in feeds:
            b.actions_before_epoch()   # the history negatives, if any
            feeds[kind] = list(itertools.islice(
                b.batches(SEGREC_B, shuffle=True), SEGREC_TIMED + 2))
        batches = feeds[kind]
        model = _segrec_model(name, corpus, name.startswith("Clip"),
                              extra=extra)
        r = CTRRunner(model, RunnerConfig(batch_size=SEGREC_B,
                                          eval_batch_size=SEGREC_B,
                                          metrics=("AUC",)),
                      feat_table=table, device=dev)
        for feed in batches[:2]:  # warm-up
            r.train_step(feed, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for i, feed in enumerate(batches[2:]):
            loss = r.train_step(feed, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches[2:])
        peak = torch.cuda.max_memory_allocated()
        if not math.isfinite(float(loss)):
            raise AssertionError(f"{name} {extra}: loss {float(loss)}")
        eval_ms = _time_ms(lambda: r.eval_scores(batches[0]), 3, warmup=1)
        log(f"  {' '.join([name, *extra])} CTR at B={SEGREC_B}: "
            f"{ms:.2f} ms/step ({SEGREC_B / ms * 1e3:.0f} interactions/s, "
            f"{len(batches) - 2} steps after 2), eval batch {eval_ms:.2f} "
            f"ms, peak device memory {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} "
            "held)")
        del r, model
    del feeds, table, sr, store
    torch.cuda.empty_cache()

    # (b) ClipDINRec's ranking evaluation at the CLI's default batch
    rank = Corpus(sdir, "SegMM")
    seg_store = FeatureStore.open(ctx["memmap"], seg_lineid)
    b = FeedBuilder(rank, "test", task="ranking", include_history=True,
                    clip_weights=clip, feature_store=seg_store, seed=0)
    feed = next(b.batches(512, shuffle=False))
    r = RankingRunner(_segrec_model("ClipDINRec", rank, True),
                      RunnerConfig(eval_batch_size=512),
                      feat_table=seg_store.feat, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        scores = r.eval_scores(feed)
        fits = f"fits ({time.perf_counter() - t0:.2f} s)"
        if not np.isfinite(scores[feed["row_mask"]]).all():
            raise AssertionError("ClipDINRec ranking evaluation: scores "
                                 "not finite")
    except torch.cuda.OutOfMemoryError as e:
        fits = f"does not fit: {str(e).splitlines()[0][:160]}"
    log(f"  ClipDINRec ranking evaluation at --eval_batch_size 512 "
        f"({int(feed['row_mask'].sum())} rows x {feed['item_id'].shape[1]} "
        f"candidates x 40 segments): {fits}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del r
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# SegRec's general and sequential models, ranking mode

SEGREC_SEQ = ("BPRMF", "BUIR", "NeuMF", "LightGCN", "DirectAU", "POP",
              "SASRec", "GRU4Rec", "Caser", "NARM", "FPMC", "TiSASRec",
              "ComiRec", "ContraRec", "TiMiRec", "SRGNN", "CLRec",
              "FourierTA", "S3Rec")
# each model at segrec.main's defaults (ranking, emb 64, --history_max 20,
# --num_neg 1, B=512) with its own loss route (DirectAU's is asked for,
# as in the JAX CLI), then S3Rec's pretrain (stage 1) and TiMiRec's
# pretrain stage; S3Rec and TiMiRec above run their defaults, the
# finetune stages
SEGREC_SEQ_CASES = tuple(
    (n, ("--loss_n", "DirectAU") if n == "DirectAU" else ())
    for n in SEGREC_SEQ) + (("S3Rec", ("--s3rec_stage", "1")),
                            ("TiMiRec", ("--timirec_stage", "pretrain")))
# segrec.main --model_mode TopK runs in phase segrec's pool (one epoch;
# BPRMF over every item), and S3Rec's stage 1 then stage 2 --load 1 in one
# thread of it
SEGREC_SEQ_CLI = (("SASRec", ()), ("BPRMF", ("--test_all", "1")),
                  ("BUIR", ()), ("ContraRec", ()))
SEGREC_FULL_SORT_ROWS = 32   # rows of the full-sort evaluation batch


def _segrec_seq_args(name, extra=()):
    from segmminterest_tpu_torch.segrec import main as M
    return M.build_parser().parse_args(["--model_name", name,
                                        "--model_mode", "TopK", *extra])


def _segrec_seq_builders(cache, corpus, args):
    """segrec.main's train and dev builders for `args` (ranking), one pair
    per kind of feed (histories, ContraRec's views, SRGNN's graphs,
    S3Rec's pretrain corpus), made once and kept in `cache`."""
    from segmminterest_tpu_torch.segrec import main as M
    kind = (args.model_name in M.SEQ_MODELS, args.model_name == "ContraRec",
            args.model_name == "SRGNN",
            args.model_name == "S3Rec" and args.s3rec_stage == 1)
    if kind not in cache:
        cache[kind] = M.feed_builders(args, corpus, "ranking",
                                      phases=("train", "dev"))
    return cache[kind]


def _segrec_seq_runner(name, extra, corpus, dev, batch_size=SEGREC_B,
                       dtype=torch.float32, model=None):
    """A RankingRunner on `dev` of segrec.main's model and loss route."""
    import copy

    from segmminterest_tpu_torch.segrec import main as M
    from segmminterest_tpu_torch.segrec.runner import (RankingRunner,
                                                       RunnerConfig)
    args = _segrec_seq_args(name, extra)
    model = copy.deepcopy(model) if model is not None else \
        M.build_model(args, corpus, use_frames=False)
    if hasattr(model, "sync_targets"):
        model.sync_targets()
    return RankingRunner(model.to(dtype), RunnerConfig(
        batch_size=batch_size, eval_batch_size=batch_size,
        loss_n=M.loss_name(args, "ranking"), ctc_temp=args.ctc_temp),
        device=dev)


def _candidate_shuffle(feed, seed):
    """The runner's candidate shuffle of item_id, from a fixed seed (a
    pretrain batch has no candidates)."""
    if "item_id" not in feed:
        return feed
    items = feed["item_id"]
    perm = np.argsort(np.random.default_rng(seed).random(items.shape), -1)
    return dict(feed, item_id=np.take_along_axis(items, perm, 1),
                unshuffle=np.argsort(perm, -1))


def _segrec_seq_steps(corpus, cache, dev):
    """One 32-row step of each case of SEGREC_SEQ_CASES on `dev`, on the
    CPU and on the CPU in fp64, from the same weights and batch: (case,
    then (loss, gradient norm, evaluation scores of a 32-row dev batch
    before the step) on dev, on the CPU, in fp64)."""
    import copy
    out = []
    for name, extra in SEGREC_SEQ_CASES:
        args = _segrec_seq_args(name, extra)
        bs = _segrec_seq_builders(cache, corpus, args)
        bs["train"].actions_before_epoch()
        feed = _candidate_shuffle(next(bs["train"].batches(32,
                                                           shuffle=True)), 0)
        dev_feed = next(bs["dev"].batches(32, shuffle=False))
        from segmminterest_tpu_torch.segrec import main as M
        model = M.build_model(args, corpus, use_frames=False)

        def step(where, dtype=torch.float32):
            r = _segrec_seq_runner(name, extra, corpus, where, 32, dtype,
                                   model=copy.deepcopy(model))
            r.generator = torch.Generator()
            scores = r.eval_scores(dev_feed).astype(np.float64)
            loss = float(r.train_step(feed, 0))
            norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in r.model.parameters())))
            return loss, norm, scores
        out.append(((name, extra), step(dev), step("cpu"),
                    step("cpu", torch.float64)))
    return out


def _segrec_seq_checks(corpus, cache, dev):
    """Phase segrec_seq's (b), run in phase segrec beside its CLIs: one
    32-row fp32 step of each general and sequential model (and of S3Rec's
    and TiMiRec's pretrain) on the card and on the CPU: loss, gradient
    norm and a dev batch's scores within SEGREC_RTOL_CONTEXT, or
    SEGREC_COND times the CPU's own fp32-vs-fp64 rounding where that is
    more."""
    for (name, extra), card, cpu, fp64 in _segrec_seq_steps(corpus, cache,
                                                            dev):
        err, rounding = _rel_errs(card, cpu), _rel_errs(cpu, fp64)
        limit = max(SEGREC_RTOL_CONTEXT, SEGREC_COND * max(rounding))
        what = " ".join([name, *extra])
        if max(err) > limit:
            raise AssertionError(f"{what} 32-row step: card {card[:2]}, CPU "
                                 f"{cpu[:2]}, relative errors {err} against "
                                 f"{limit}")
        log(f"  {what} 32-row fp32 ranking step, card against the CPU: loss "
            f"{card[0]:.6f} ({err[0]:.1e} relative), gradient norm "
            f"{card[1]:.6f} ({err[1]:.1e}), dev scores {err[2]:.1e}; the "
            "CPU's against fp64: " + ", ".join(f"{e:.1e}" for e in rounding)
            + f"; limit {limit:.1e}")


def _segrec_seq_cli(sdir, env, case):
    """segrec.main --model_mode TopK for one epoch over phase segrec's
    SegMM split (no Task-1 logits, no segment table): finite HR and
    NDCG; (result, stderr)."""
    name, extra = case
    what = "segrec.main " + " ".join([name, "--model_mode TopK", *extra])
    res, err = _subprocess_json(
        ["segmminterest_tpu_torch.segrec.main", "--model_name", name,
         "--path", sdir, "--dataset", "SegMM", "--model_mode", "TopK",
         "--epoch", "1", *extra], env, what)
    got = {s: {k: res[s][k] for k in ("HR@5", "NDCG@5", "HR@50", "NDCG@50")}
           for s in ("dev", "test")}
    if not _finite(got):
        raise AssertionError(f"{what}: metrics {got}")
    peak = [ln.split("peak device memory: ", 1)[1] for ln in
            err.splitlines() if "peak device memory: " in ln]
    log(f"  {what}: dev {got['dev']}, test {got['test']}; peak device "
        f"memory {peak[-1] if peak else 'not logged'}")
    return res, err


def _start_segrec_seq_clis(ctx):
    """Phase segrec_seq's CLI runs (SEGREC_SEQ_CLI, then S3Rec's two stages
    in one thread) over a SegMM split of the synthetic CSV built here, in
    processes of their own beside phases wide and train_cli, which time
    nothing; train_cli's end waits for them. Started once."""
    from concurrent.futures import ThreadPoolExecutor

    from segmminterest_tpu_torch.tasks import build_segrec_data
    if "segrec_seq_clis" in ctx:
        return
    ctx["segrec_seq_clis"] = True
    _data(ctx)
    sdir = os.path.join(WORK, "segrec_seq")
    build_segrec_data.main(["--inter_csv", ctx["csv"], "--out", sdir,
                            "--name", "SegMM", "--min_interactions", "100",
                            "--num_warmup", "80"])
    env = dict(os.environ)

    def run():
        with ThreadPoolExecutor(len(SEGREC_SEQ_CLI) + 1) as pool:
            running = ([pool.submit(_segrec_seq_cli, sdir, env, case)
                        for case in SEGREC_SEQ_CLI]
                       + [pool.submit(_segrec_s3rec_cli, sdir, env)])
            for f in running:
                f.result()
    _in_background(ctx, "segrec_seq's CLI runs", run)


def _segrec_s3rec_cli(sdir, env):
    """S3Rec's two stages through segrec.main in one thread: stage 1
    (pretrain) saves its state to --model_path, stage 2 loads it in part
    (--load 1) and trains on."""
    pt = os.path.join(sdir, "s3rec_stage1.pt")
    _segrec_seq_cli(sdir, env, ("S3Rec", ("--s3rec_stage", "1",
                                          "--model_path", pt)))
    stage1 = set(torch.load(pt, weights_only=True))
    _, err = _segrec_seq_cli(sdir, env, ("S3Rec", (
        "--s3rec_stage", "2", "--load", "1", "--model_path", pt)))
    stage2 = set(torch.load(pt, weights_only=True))
    if "(partial)" not in err or not {"mip_norm.weight", "sp_norm.weight"} \
            <= stage1 - stage2:
        raise AssertionError("S3Rec stage 2 did not load stage 1 in part")


def phase_segrec_seq(ctx):
    """SegRec's general and sequential models in ranking mode on the card
    over phase segrec's SegMM split (its CLI runs went beside phases wide
    and train_cli, its 32-row checks beside phase segrec's CLIs): each
    case of SEGREC_SEQ_CASES at
    segrec.main's defaults (emb 64, --history_max 20, --num_neg 1, B=512)
    with its loss route, SEGREC_TIMED steps timed after 2 on batches made
    before (ms, rows/s: interactions, or S3Rec's pretrain chunks of up to
    20; peak device memory above what is held), an
    evaluation batch of 512 rows x 100 candidates, and a full-sort batch
    (SEGREC_FULL_SORT_ROWS rows x every item): finite, each row's target
    scored at column 0 and at its own id's column with the same bits; the
    host ms of one batch of SRGNN's and of ContraRec's feeds."""
    if "segrec_rank" not in ctx:
        raise AssertionError("phase segrec_seq runs on phase segrec's data: "
                             "run that first")
    corpus = ctx.pop("segrec_rank")
    cache = ctx.pop("segrec_seq_builders", {})
    dev = torch.device("cuda")
    n_items = corpus.n_items
    for name in ("SRGNN", "ContraRec"):
        b = _segrec_seq_builders(cache, corpus, _segrec_seq_args(name))
        b["train"].actions_before_epoch()
        t0 = time.perf_counter()
        next(b["train"].batches(SEGREC_B, shuffle=True))
        log(f"  {name}'s feeds: {(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"on the host for one batch of {SEGREC_B} rows")
    batches = {}
    for name, extra in SEGREC_SEQ_CASES:
        args = _segrec_seq_args(name, extra)
        bs = _segrec_seq_builders(cache, corpus, args)
        key = id(bs["train"])
        if key not in batches:
            # as many epochs as it takes (S3Rec's pretrain corpus of
            # 20-item chunks fills 3 batches an epoch)
            def epochs(b=bs["train"]):
                while True:
                    b.actions_before_epoch()
                    yield from b.batches(SEGREC_B, shuffle=True)
            batches[key] = [_candidate_shuffle(f, i) for i, f in enumerate(
                itertools.islice(epochs(), SEGREC_TIMED + 2))]
            batches[key, "dev"] = next(bs["dev"].batches(SEGREC_B,
                                                         shuffle=False))
        feeds, dev_feed = batches[key], batches[key, "dev"]
        r = _segrec_seq_runner(name, extra, corpus, dev)
        for i, feed in enumerate(feeds[:2]):   # warm-up
            r.train_step(feed, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for i, feed in enumerate(feeds[2:]):
            loss = r.train_step(feed, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(feeds[2:])
        peak = torch.cuda.max_memory_allocated()
        what = " ".join([name, *extra])
        if not math.isfinite(float(loss)):
            raise AssertionError(f"{what}: loss {float(loss)}")
        eval_ms = _time_ms(lambda: r.eval_scores(dev_feed), 3, warmup=1)
        # full sort: [target] + every item id, the dev batch's first rows
        rows = SEGREC_FULL_SORT_ROWS
        full = {k: v[:rows] for k, v in dev_feed.items()}
        target = full["item_id"][:, 0]
        full["item_id"] = np.concatenate(
            [target[:, None], np.broadcast_to(np.arange(1, n_items),
                                              (rows, n_items - 1))], 1)
        scores = r.eval_scores(full)
        real = np.flatnonzero(full["row_mask"])
        if not np.isfinite(scores[real]).all() or not np.array_equal(
                scores[real, 0], scores[real, target[real]]):
            raise AssertionError(f"{what}: full-sort scores not finite, or "
                                 "the target's two columns differ")
        log(f"  {what} ranking at B={SEGREC_B}: {ms:.2f} ms/step "
            f"({SEGREC_B / ms * 1e3:.0f} rows/s, {len(feeds) - 2} "
            f"steps after 2), eval batch {eval_ms:.2f} ms ({SEGREC_B} rows x "
            f"{dev_feed['item_id'].shape[1]} candidates), peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
            f"{base / 2**30:.2f} held); full sort over {n_items - 1} items: "
            "target columns bit-equal")
        del r
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# SegRec's other runners: leave-frame ranking, Impression mode, the KG family

SEGREC_RUNNERS_DIR = os.path.join(WORK, "segrec_runners")
# each case at segrec.main's defaults (emb 64, --history_max 20, --num_neg
# 1, B=512; Impression: 20 | 20 slots, the rerankers' --n_blocks 4,
# --num_hidden_unit 64 over a BPRMF ranker; KDA's --n_dft 64, Chorus's
# --lr_scale 0.1); a KG model over SegRec (r_next_watch, i_category),
# Impression over SegRec_CTR's impressions, --leave_rank 1 over
# SegMMstep1Ranking
SEGREC_RUNNER_CASES = (
    ("CFKG", ()), ("SLRCPlus", ()), ("Chorus", ("--stage", "1")),
    ("Chorus", ("--stage", "2")), ("KDA", ()),
    ("BPRMF", ("--model_mode", "Impression")),
    ("SASRec", ("--model_mode", "Impression")),
    ("PRM", ("--model_mode", "Impression")),
    ("SetRank", ("--model_mode", "Impression")),
    ("SetRank", ("--model_mode", "Impression", "--setrank_type", "MSAB")),
    ("MIR", ("--model_mode", "Impression")),
    ("SASRec", ("--leave_rank", "1")))
# segrec.main for one epoch, each chain in a thread of its own ({dir}: the
# phase's directory)
SEGREC_RUNNER_CLI = (
    (("SASRec", ("--leave_rank", "1")),),
    (("BPRMF", ("--leave_rank", "1", "--dataset",
                "SegMMstep1RankingDefault")),),
    (("BPRMF", ("--model_mode", "Impression", "--model_path",
                "{dir}/bprmf_impression.pt")),
     ("PRM", ("--model_mode", "Impression", "--ranker_model_path",
              "{dir}/bprmf_impression.pt"))),
    (("Chorus", ("--stage", "1", "--model_path", "{dir}/chorus.pt")),
     ("Chorus", ("--stage", "2", "--load", "1", "--model_path",
                 "{dir}/chorus.pt"))),
    (("KDA", ("--include_attr", "1")),))


def _segrec_runner_args(name, extra=()):
    """segrec.main's arguments of a case over SEGREC_RUNNERS_DIR."""
    from segmminterest_tpu_torch.segrec import main as M
    extra = [e.format(dir=SEGREC_RUNNERS_DIR) for e in extra]
    if "Impression" in extra:
        base = ["--dataset", "SegRec_CTR"]
    elif "--leave_rank" in extra:
        base = ["--model_mode", "TopK", "--dataset", "SegMMstep1Ranking"]
    else:
        base = ["--model_mode", "TopK", "--dataset", "SegRec"]
    return M.build_parser().parse_args(["--model_name", name, "--path",
                                        SEGREC_RUNNERS_DIR, *base, *extra])


def _segrec_runner_data(csv):
    """build_segrec_data --kg_meta 1 (SegRec, SegRec_CTR) and
    build_leave_rank_data (SegMMstep1Ranking[Default]) over the synthetic
    CSV, as phase watchtime's builds, into SEGREC_RUNNERS_DIR."""
    from segmminterest_tpu_torch.tasks import (build_leave_rank_data,
                                               build_segrec_data)
    raw = ["--inter_csv", csv, "--min_interactions", "100", "--num_warmup",
           "80", "--out", SEGREC_RUNNERS_DIR]
    t0 = time.perf_counter()
    build_segrec_data.main(raw + ["--name", "SegRec", "--kg_meta", "1"])
    build_leave_rank_data.main(raw)
    return time.perf_counter() - t0


def _segrec_runner_prep():
    """Host work of phase segrec_runners: each case's segrec.main
    arguments, model (on the host, from --random_seed), SEGREC_TIMED + 2
    training batches of SEGREC_B rows and an evaluation batch, and a
    32-row training and evaluation batch for the card-against-CPU check,
    from its builders (train, dev; one pair per kind of feed); the host ms
    of a batch of SLRCPlus's, Chorus's and KDA's feeds and of one CFKG
    epoch's negatives."""
    from segmminterest_tpu_torch.segrec import main as M
    from segmminterest_tpu_torch.segrec.corpus import Corpus
    corpora, builders, feeds, host, cases = {}, {}, {}, {}, []
    for name, extra in SEGREC_RUNNER_CASES:
        args = _segrec_runner_args(name, extra)
        if args.dataset not in corpora:
            corpora[args.dataset] = Corpus(args.path, args.dataset)
        corpus = corpora[args.dataset]
        imp = args.model_mode == "Impression"
        if imp:
            kind = ("Impression", name in ("SASRec", "MIR"))
        else:
            kind = (args.dataset, name, args.stage,
                    name in M.SEQ_MODELS)
        if kind not in builders:
            if imp:
                builders[kind] = M.impression_builders(args, corpus,
                                                       ("train", "dev"))
            else:
                builders[kind] = M.feed_builders(
                    args, corpus, "ranking", phases=("train", "dev"),
                    kg_meta=M.kg_metadata(args, corpus))
            b, made = builders[kind]["train"], []
            while len(made) < SEGREC_TIMED + 2:
                t0 = time.perf_counter()
                b.actions_before_epoch()
                draw_ms = (time.perf_counter() - t0) * 1e3
                for f in b.batches(SEGREC_B, shuffle=True):
                    if not made:
                        host[name, args.stage] = (
                            draw_ms, (time.perf_counter() - t0) * 1e3
                            - draw_ms)
                    # the runner shuffles a ranking batch's candidates,
                    # not an impression's
                    made.append(f if imp else _candidate_shuffle(
                        f, len(made)))
            feeds[kind] = made[:SEGREC_TIMED + 2]
            feeds[kind, "dev"] = next(builders[kind]["dev"].batches(
                SEGREC_B, shuffle=False))
        if imp:
            _, model, _ = M.impression_setup(args, "cpu", builders[kind])
        else:
            model = M.build_model(args, corpus, False,
                                  kg_meta=getattr(builders[kind]["train"],
                                                  "kg", None))
        cases.append([name, extra, args, builders[kind], model,
                      feeds[kind], feeds[kind, "dev"]])
    for case in cases:   # the 32-row batches, after every timed one
        bs, imp = case[3], case[2].model_mode == "Impression"
        bs["train"].actions_before_epoch()
        feed = next(bs["train"].batches(32, shuffle=True))
        case[3] = (feed if imp else _candidate_shuffle(feed, 0),
                   next(bs["dev"].batches(32, shuffle=False)))
    return dict(cases=cases, host=host)


def _segrec_runner_host(path):
    """_segrec_runner_prep saved to `path`, with its seconds."""
    t0 = time.perf_counter()
    prep = _segrec_runner_prep()
    prep["seconds"] = time.perf_counter() - t0
    torch.save(prep, path)


def _in_process(call, what):
    """`call`, a call of this module's, in a process of its own (from the
    checkout's root): host work beside the untimed phases that would hold
    this process's interpreter lock from their Python."""
    proc = subprocess.run([sys.executable, "-c",
                           "import chip_smoke as C; C." + call],
                          cwd=ROOT, env=dict(os.environ),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")


def _segrec_runner_make(args, model, where, batch_size,
                        dtype=torch.float32):
    """segrec.main's runner for `args` on `where` over a copy of `model`."""
    import copy

    from segmminterest_tpu_torch.segrec import main as M
    from segmminterest_tpu_torch.segrec.rerank import ImpressionRunner
    model = copy.deepcopy(model).to(dtype)
    args = copy.copy(args)
    args.batch_size = args.eval_batch_size = batch_size
    if args.model_mode == "Impression":
        return ImpressionRunner(model, M.impression_config(args),
                                      args.train_max_pos_item,
                                      args.train_max_neg_item, device=where)
    return M.make_runner(args, "ranking", model, device=where)


def _segrec_runner_cli(chain):
    """One chain of SEGREC_RUNNER_CLI through segrec.main (one epoch, on
    the card): finite metrics; Chorus's stage 2 loads stage 1 in part,
    PRM its BPRMF ranker."""
    env = dict(os.environ)
    for name, extra in chain:
        args = _segrec_runner_args(name, extra)
        flags = [e.format(dir=SEGREC_RUNNERS_DIR) for e in extra]
        what = "segrec.main " + " ".join([name, *flags]).replace(
            SEGREC_RUNNERS_DIR + "/", "")
        res, err = _subprocess_json(
            ["segmminterest_tpu_torch.segrec.main", "--model_name", name,
             "--path", SEGREC_RUNNERS_DIR, "--dataset", args.dataset,
             "--model_mode", args.model_mode, "--epoch", "1", *flags],
            env, what)
        if not res or not all(res[s] and _finite(res[s])
                              for s in ("dev", "test")):
            raise AssertionError(f"{what}: metrics {res}")
        if "--load" in flags and "(partial)" not in err:
            raise AssertionError(f"{what} loaded no stage-1 state")
        if "--ranker_model_path" in flags and "Load ranker from" not in err:
            raise AssertionError(f"{what} loaded no ranker")
        peak = [ln.split("peak device memory: ", 1)[1] for ln in
                err.splitlines() if "peak device memory: " in ln]
        log(f"  {what}: dev {res['dev']}, test {res['test']}; peak device "
            f"memory {peak[-1] if peak else 'not logged'}")


def _start_segrec_runner_clis(ctx):
    """Phase segrec_runners' data, then its CLI runs (SEGREC_RUNNER_CLI, a
    thread a chain) beside its host preparation (_segrec_runner_host),
    each in a process of its own, in the background beside phases wide
    and train_cli, which time nothing; train_cli's end waits for them.
    Started once."""
    from concurrent.futures import ThreadPoolExecutor
    if "segrec_runner_clis" in ctx:
        return
    ctx["segrec_runner_clis"] = True
    _data(ctx)
    csv = ctx["csv"]
    path = os.path.join(WORK, "segrec_runners_prep.pt")

    def run():
        t0 = time.perf_counter()
        _in_process(f"_segrec_runner_data({csv!r})", "segrec_runners' data")
        built_s = time.perf_counter() - t0
        with ThreadPoolExecutor(len(SEGREC_RUNNER_CLI) + 1) as pool:
            running = [pool.submit(_segrec_runner_cli, chain)
                       for chain in SEGREC_RUNNER_CLI]
            pool.submit(_in_process, f"_segrec_runner_host({path!r})",
                        "segrec_runners' host preparation").result()
            prep = torch.load(path, weights_only=False)
            ctx["segrec_runner_prep"] = prep
            log(f"  segrec_runners' data built ({built_s:.1f} s), its host "
                f"batches and models made ({prep['seconds']:.1f} s), each "
                "in a process of its own")
            for f in running:
                f.result()
    _in_background(ctx, "segrec_runners' data and CLI runs", run)


def _segrec_runner_steps(prep, dev):
    """One 32-row step of each case of SEGREC_RUNNER_CASES on `dev`, on the
    CPU and on the CPU in fp64, from the same weights and batch: (case,
    then (loss, gradient norm, evaluation scores of a 32-row dev batch
    before the step) on dev, on the CPU, in fp64)."""
    out = []
    for name, extra, args, (feed, dev_feed), model, _, _ in prep["cases"]:

        def step(where, dtype=torch.float32):
            r = _segrec_runner_make(args, model, where, 32, dtype)
            r.generator = torch.Generator()
            scores = r.eval_scores(dev_feed).astype(np.float64)
            loss = float(r.train_step(feed, 0))
            norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in r.model.parameters())))
            return loss, norm, scores
        out.append(((name, extra), step(dev), step("cpu"),
                    step("cpu", torch.float64)))
    return out


def _segrec_runner_checks(ctx):
    """Phase segrec_runners' (b), run in phase segrec beside its CLIs (or
    in phase segrec_runners where phase segrec did not run): one 32-row
    fp32 step of each case on the card and on the CPU: loss, gradient norm
    and a dev batch's scores within SEGREC_RTOL_CONTEXT, or SEGREC_COND
    times the CPU's own fp32-vs-fp64 rounding where that is more."""
    for (name, extra), card, cpu, fp64 in _segrec_runner_steps(
            ctx["segrec_runner_prep"], torch.device("cuda")):
        err, rounding = _rel_errs(card, cpu), _rel_errs(cpu, fp64)
        limit = max(SEGREC_RTOL_CONTEXT, SEGREC_COND * max(rounding))
        what = " ".join([name, *extra])
        if max(err) > limit:
            raise AssertionError(f"{what} 32-row step: card {card[:2]}, CPU "
                                 f"{cpu[:2]}, relative errors {err} against "
                                 f"{limit}")
        log(f"  {what} 32-row fp32 step, card against the CPU: loss "
            f"{card[0]:.6f} ({err[0]:.1e} relative), gradient norm "
            f"{card[1]:.6f} ({err[1]:.1e}), dev scores {err[2]:.1e}; the "
            "CPU's against fp64: " + ", ".join(f"{e:.1e}" for e in rounding)
            + f"; limit {limit:.1e}")
    ctx["segrec_runner_checked"] = True


def phase_segrec_runners(ctx):
    """SegRec's other runners on the card: leave-frame ranking (SASRec
    under LeaveRankingRunner), Impression mode (the BPRMF and SASRec
    rankers, PRM, SetRank IMSAB and MSAB, MIR over a BPRMF ranker, on
    BPRsession) and the KG family (CFKG's quadruple step, SLRCPlus, Chorus
    stage 1 and 2, KDA with its DistMult term), each at segrec.main's
    defaults: SEGREC_TIMED steps timed after 2 on batches made before (ms,
    rows/s, peak device memory above what is held) and an evaluation
    batch; the host ms of SLRCPlus's, Chorus's and KDA's feeds and of a
    CFKG epoch's negatives. Its data, host batches and CLI runs (one epoch
    each: --leave_rank 1 on both leave-rank datasets, BPRMF then PRM
    --model_mode Impression, Chorus --stage 1 then --stage 2 --load 1, KDA
    --include_attr 1) went beside phases wide and train_cli, its 32-row
    checks beside phase segrec's CLIs; where they did not, they run
    here."""
    _start_segrec_runner_clis(ctx)
    _join_background(ctx)
    if not ctx.get("segrec_runner_checked"):
        _segrec_runner_checks(ctx)
    prep = ctx.pop("segrec_runner_prep")
    for (name, stage), (draw_ms, batch_ms) in prep["host"].items():
        if name in ("CFKG", "SLRCPlus", "KDA") or (name, stage) == (
                "Chorus", 2):
            log(f"  {name}'s feeds on the host: {batch_ms:.1f} ms for a "
                f"batch of {SEGREC_B} rows, {draw_ms:.1f} ms for an epoch's "
                "draws" + (" (the negatives of its KG rows)"
                           if name == "CFKG" else ""))
    dev = torch.device("cuda")
    for name, extra, args, _, model, feeds, dev_feed in prep["cases"]:
        r = _segrec_runner_make(args, model, dev, SEGREC_B)
        for i, feed in enumerate(feeds[:2]):   # warm-up
            r.train_step(feed, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for i, feed in enumerate(feeds[2:]):
            loss = r.train_step(feed, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(feeds[2:])
        peak = torch.cuda.max_memory_allocated()
        what = " ".join([name, *extra])
        if not math.isfinite(float(loss)):
            raise AssertionError(f"{what}: loss {float(loss)}")
        eval_ms = _time_ms(lambda: r.eval_scores(dev_feed), 3, warmup=1)
        scores = r.eval_scores(dev_feed)[dev_feed["row_mask"]]
        if not np.isfinite(scores).all():
            raise AssertionError(f"{what}: evaluation scores not finite")
        shape = "x".join(map(str, (feeds[2].get("item_id", feeds[2].get(
            "head_id"))).shape))
        log(f"  {what} at B={SEGREC_B} (batch {shape}): {ms:.2f} ms/step "
            f"({SEGREC_B / ms * 1e3:.0f} rows/s, {len(feeds) - 2} steps "
            f"after 2), eval batch {eval_ms:.2f} ms ({SEGREC_B} rows x "
            f"{dev_feed['item_id'].shape[1]} candidates), peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
            f"{base / 2**30:.2f} held)")
        del r
    torch.cuda.empty_cache()
    if "pandas" in sys.modules:
        raise AssertionError("SegRec's runners imported pandas")



# ---------------------------------------------------------------------------
# MMRec's graph recommenders

MMREC_DIR = os.path.join(WORK, "mmrec")
MMREC_B = 2048          # mmrec.main's --batch_size default
MMREC_TIMED = 10        # steps timed per case, after 2
MMREC_KNN = 10          # --knn_k
MMREC_CLIP_WIDTH = 1025  # CLIP's 1024 + the position column
# (case, model, --edge_dropout, feature columns) at mmrec.main's defaults
MMREC_CASES = tuple((n, n, 0.0, 64) for n in (
    "BPR", "LightGCN", "LayerGCN", "FREEDOM", "BM3", "LATTICE", "MMGCN",
    "SLMRec")) + (("FREEDOM --edge_dropout 0.1", "FREEDOM", 0.1, 64),
                  ("FREEDOM 1,025 columns", "FREEDOM", 0.0, MMREC_CLIP_WIDTH))
MMREC_RTOL = 1e-5       # the small graph's steps, card against CPU
MMREC_SMALL = dict(n_users=300, n_items=400, n_edges=3000, rows=256,
                   real=200)
# mmrec.main for one epoch, each chain in a thread of its own ({dir}: the
# phase's directory, {csv}: the script's CSV)
MMREC_CLI = (
    ("segmminterest_tpu_torch.mmrec.main", "--model", "FREEDOM",
     "--inter_csv", "{csv}", "--epochs", "1", "--test_cold", "1",
     "--save_logits", "{dir}/freedom_logits.json"),
    ("segmminterest_tpu_torch.mmrec.main", "--model", "LATTICE",
     "--inter_csv", "{csv}", "--epochs", "1"),
    ("segmminterest_tpu_torch.mmrec.main", "--model", "BPR", "--inter_csv",
     "{csv}", "--epochs", "1", "--grid", "lr=0.01,0.001"),
    ("segmminterest_tpu_torch.tasks.exp", "--entry", "mmrec", "--seeds",
     "0,1", "--out", "{dir}/exp.csv", "--", "--model", "BPR",
     "--inter_csv", "{csv}", "--epochs", "1"))


def _mmrec_prep(path):
    """Host work of phase mmrec, in a process of its own: build_mmrec_data
    over the script's CSV (written again, beside `path`; mmrec.main's
    defaults), the CLI's random 64-d
    features and FREEDOM's block-local kNN graph over them, a 197,064 x
    1,025 feature matrix (a position column in [0, 1)) written beside
    `path` and FREEDOM's graph over its 1,024 columns; the host seconds of
    each and the number of keys of the exported rows beside `path`."""
    from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
    from segmminterest_tpu_torch.mmrec import main as M
    from segmminterest_tpu_torch.mmrec.graph import knn_item_graph
    secs = {}
    t0 = time.perf_counter()
    csv = write_synthetic_csv(path + ".csv", **CSV_ARGS)
    data = M.build_mmrec_data(csv, ",", 100, 80, 2024)
    secs["data"] = time.perf_counter() - t0
    n = data["n_items"]
    feats = np.random.default_rng(0).normal(size=(n, 64)).astype(np.float32)
    t0 = time.perf_counter()
    graph = knn_item_graph(feats, MMREC_KNN)
    secs["knn 64"] = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    wide = np.lib.format.open_memmap(path + ".clip.npy", "w+", np.float32,
                                     (n, MMREC_CLIP_WIDTH))
    for s in range(0, n, 16384):
        e = min(n, s + 16384)
        wide[s:e, :-1] = rng.normal(size=(e - s, MMREC_CLIP_WIDTH - 1))
        wide[s:e, -1] = rng.random(e - s)
    t0 = time.perf_counter()
    wide_graph = knn_item_graph(wide[:, :-1], MMREC_KNN)
    secs["knn 1024"] = time.perf_counter() - t0
    wide.flush()
    torch.save(dict(data=data, feats=feats, graph=graph,
                    wide_graph=wide_graph), path)
    keys = {f"{r['user_id']}-{r['photo_id']}-{r['time']}"
            for r in data["all"]}
    with open(path + ".json", "w") as f:
        json.dump(dict(secs=secs, n_keys=len(keys)), f)


def _mmrec_cli(chain, csv, prep):
    """One run of MMREC_CLI (one epoch on the card): finite metrics;
    FREEDOM's --save_logits file holds one 40-wide finite row for each key
    of its interactions (those of `prep`, a future of the prepared data);
    the sweep's CSV its two seeds and their mean."""
    args = [a.format(dir=MMREC_DIR, csv=csv) for a in chain]
    what = " ".join(a for a in chain if a not in ("--inter_csv", "{csv}"))
    what = what.replace("segmminterest_tpu_torch.", "").replace(
        "{dir}/", "")
    res, err = _subprocess_json(args, dict(os.environ, **ONE_THREAD), what,
                                nice=19)
    if "--grid" in args:
        metrics = [g["best_test_upon_valid"] for g in res["grid"]]
        if len(metrics) != 2:
            raise AssertionError(f"{what}: grid {res}")
    elif "tasks.exp" in args[0]:
        with open(os.path.join(MMREC_DIR, "exp.csv")) as f:
            rows = f.read().splitlines()
        seeds = [r.split(",", 1)[0] for r in rows[1:]]
        metrics = [{k: float(v) for k, v in zip(rows[0].split(","), r.split(
            ",")) if k != "seed"} for r in rows[1:]]
        if seeds != ["0", "1", "mean"]:
            raise AssertionError(f"{what}: rows {seeds}")
    else:
        metrics = [res["best_valid_result"], res["best_test_upon_valid"]]
    if "--test_cold" in args:
        metrics += [res["cold_test"], res["hot_test"]]
    if not all(m and _finite(m) for m in metrics):
        raise AssertionError(f"{what}: metrics {metrics}")
    if "--save_logits" in args:
        with open(args[args.index("--save_logits") + 1]) as f:
            logits = json.load(f)
        n_keys = prep.result()["n_keys"]
        if len(logits) != n_keys or not all(
                len(v) == 40 and _finite(v) for v in logits.values()):
            raise AssertionError(f"{what}: {len(logits)} rows for {n_keys} "
                                 "keys")
        what += f" ({len(logits)} rows of 40 finite logits)"
    peak = [ln.split("peak device memory: ", 1)[1] for ln in
            err.splitlines() if "peak device memory: " in ln]
    hr5 = [v for k, v in metrics[-1].items() if k.endswith("hr@5")]
    log(f"  {what}: hr@5 {hr5[0]:.4f}; peak device memory "
        f"{peak[-1] if peak else 'not logged'}")


# one thread each for the BLAS and OpenMP pools of mmrec's processes: their
# host work is serial, and idle pools' spinning threads would take the
# cores of the phases they go beside
ONE_THREAD = dict(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                  MKL_NUM_THREADS="1")


def _start_mmrec_prep(ctx):
    """_mmrec_prep in a process of its own at the lowest priority, from
    phase build on (it takes what the compiles leave); its future holds the
    prepared data. Started once."""
    if "mmrec_prep" in ctx:
        return
    os.makedirs(MMREC_DIR, exist_ok=True)
    path = os.path.join(MMREC_DIR, "prep.pt")

    def prepare():
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["nice", "-n", "19", sys.executable, "-c",
             f"import chip_smoke as C; C._mmrec_prep({path!r})"],
            cwd=ROOT, env=dict(os.environ, **ONE_THREAD),
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise AssertionError(f"mmrec's data exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        with open(path + ".json") as f:
            made = json.load(f)
        log(f"  mmrec's data built in a process of its own at nice 19 "
            f"({time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{k} {v:.1f} s" for k, v in made["secs"].items())
            + ")")
        return dict(made, path=path)
    ctx["mmrec_prep"] = _in_background(ctx, "mmrec's data", prepare)


def _start_mmrec_background(ctx):
    """Phase mmrec's CLI runs (MMREC_CLI, a thread a run, each a process of
    one thread at the lowest priority: they take what the phases' own work
    leaves), in the background beside phases wide and train_cli, which time
    nothing; train_cli's end waits for them. Started once."""
    from concurrent.futures import ThreadPoolExecutor
    if "mmrec_background" in ctx:
        return
    ctx["mmrec_background"] = True
    _data(ctx)
    _start_mmrec_prep(ctx)
    csv, prep = ctx["csv"], ctx["mmrec_prep"]

    def run():
        with ThreadPoolExecutor(len(MMREC_CLI)) as pool:
            for f in [pool.submit(_mmrec_cli, c, csv, prep)
                      for c in MMREC_CLI]:
                f.result()
    _in_background(ctx, "mmrec's CLI runs", run)


def _mmrec_small():
    """A small graph (MMREC_SMALL: a quarter of the items and every user
    past 250 without a train edge), 65 feature columns (a position column),
    FREEDOM's and LATTICE's item graphs over them (built on the CPU), a
    padded batch and BM3's and SLMRec's dropout masks, from seeds."""
    from segmminterest_tpu_torch.mmrec import graph as G
    c = MMREC_SMALL
    rng = np.random.default_rng(11)
    users = rng.integers(1, 250, c["n_edges"])
    items = rng.integers(1, 300, c["n_edges"])
    feats = rng.normal(size=(c["n_items"], 65)).astype(np.float32)
    feats[:, -1] = rng.random(c["n_items"]) * 1.2 - 0.1
    rows = c["rows"]
    idx = rng.integers(0, c["n_edges"], rows)
    idx[c["real"]:] = 0
    mask = np.ones(rows, np.float32)
    mask[c["real"]:] = 0
    gen = torch.Generator().manual_seed(3)
    return dict(
        users=users, items=items, feats=feats,
        edges=G.bipartite_norm_edges(users, items, c["n_users"],
                                     c["n_items"]),
        freedom=G.knn_item_graph(feats[:, :-1], MMREC_KNN),
        lattice=G.global_weighted_knn_graph_device(
            torch.from_numpy(feats[:, :-1]), MMREC_KNN),
        batch=(users[idx], items[idx],
               rng.integers(1, c["n_items"], rows), mask),
        masks={"BM3": [torch.rand((c[k], 64), generator=gen) < 0.7
                       for k in ("n_users", "n_items", "n_items")],
               "SLMRec": [torch.rand((rows, 64), generator=gen) < 0.9
                          for _ in range(2)]})


def _mmrec_small_steps(dev, small):
    """One step of each model on the small graph on `dev`, on the CPU and
    on the CPU in fp64, from the same weights, batch, masks and (LATTICE)
    learned edges: (name, then (loss, gradient norm, embeddings) on each)."""
    import copy

    from segmminterest_tpu_torch.mmrec.graph import knn_edges_device
    from segmminterest_tpu_torch.mmrec.models import MMREC_REGISTRY
    from segmminterest_tpu_torch.mmrec.runner import MMRecConfig, MMRecRunner
    c, out = MMREC_SMALL, []
    eu, ei, ev = small["edges"]
    for name, cls in MMREC_REGISTRY.items():
        graph = {"FREEDOM": small["freedom"], "LATTICE": small["lattice"]}
        mm_edges, mm_values = graph.get(name, (None, None))
        base = cls(n_users=c["n_users"], n_items=c["n_items"], edge_u=eu,
                   edge_i=ei, edge_values=ev, v_feat=small["feats"],
                   mm_edges=mm_edges, mm_values=mm_values)
        base.reset_parameters(torch.Generator().manual_seed(5))
        learned = None
        if name == "LATTICE":
            with torch.no_grad():
                learned = knn_edges_device(base.projected_features(),
                                           MMREC_KNN)
        runs = []
        for where, dtype in ((dev, torch.float32), ("cpu", torch.float32),
                             ("cpu", torch.float64)):
            r = MMRecRunner(copy.deepcopy(base).to(dtype), MMRecConfig(),
                            small["users"], small["items"], c["n_items"],
                            device=where)
            with torch.no_grad():
                u, i = (r.model.embeddings(None, learned.to(where))
                        if learned is not None else r.model.embeddings())
            batch = [torch.from_numpy(a).to(where) for a in small["batch"]]
            masks = small["masks"].get(name)
            loss = r._loss(*batch, None, None if learned is None
                           else learned.to(where),
                           None if masks is None
                           else [m.to(where) for m in masks])
            loss.backward()
            norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in r.model.parameters())))
            emb = torch.cat([u, i]).detach().double().cpu().numpy()
            runs.append((float(loss.detach()), norm, emb))
        out.append((name, *runs))
    return out


def _mmrec_checks(ctx):
    """Phase mmrec's (b), run in phase segrec beside its CLIs (or in phase
    mmrec where phase segrec did not run): one fp32 step of each model on
    the small graph on
    the card and on the CPU: loss, gradient norm and embeddings within
    MMREC_RTOL, or SEGREC_COND times the CPU's own fp32-vs-fp64 rounding
    where that is more; LATTICE's kNN graphs (the frozen global one and a
    learned rebuild) built on the card: the CPU's edges row by row, the
    frozen values within MMREC_RTOL."""
    from segmminterest_tpu_torch.mmrec import graph as G
    dev = torch.device("cuda")
    small = _mmrec_small()
    feats = torch.from_numpy(small["feats"][:, :-1])
    for what, cpu, card in (
            ("frozen global kNN", small["lattice"],
             G.global_weighted_knn_graph_device(feats.to(dev), MMREC_KNN)),
            ("learned kNN rebuild", (G.knn_edges_device(feats, MMREC_KNN),),
             (G.knn_edges_device(feats.to(dev), MMREC_KNN),))):
        want, got = cpu[0].numpy(), card[0].cpu().numpy()
        same = (np.sort(got[:, 1].reshape(-1, MMREC_KNN), 1)
                == np.sort(want[:, 1].reshape(-1, MMREC_KNN), 1)).all(1)
        if not same.all() or (got[:, 0] != want[:, 0]).any():
            raise AssertionError(f"LATTICE's {what} on the card: "
                                 f"{int((~same).sum())} rows differ from "
                                 "the CPU's")
        err = 0.0
        if len(cpu) == 2:
            err = float(np.abs(card[1].cpu().numpy() - cpu[1].numpy()).max()
                        / np.abs(cpu[1].numpy()).max())
            if err > MMREC_RTOL:
                raise AssertionError(f"LATTICE's {what}: values {err:.1e} "
                                     "from the CPU's")
        log(f"  LATTICE's {what} ({MMREC_SMALL['n_items']} items, k "
            f"{MMREC_KNN}) on the card: the CPU's edges in every row"
            + (f", values within {err:.1e}" if len(cpu) == 2 else ""))
    for name, card, cpu, fp64 in _mmrec_small_steps(dev, small):
        err, rounding = _rel_errs(card, cpu), _rel_errs(cpu, fp64)
        limit = max(MMREC_RTOL, SEGREC_COND * max(rounding))
        if max(err) > limit:
            raise AssertionError(f"{name} small-graph step: card {card[:2]}"
                                 f", CPU {cpu[:2]}, relative errors {err} "
                                 f"against {limit}")
        log(f"  {name} small-graph fp32 step, card against the CPU: loss "
            f"{card[0]:.6f} ({err[0]:.1e} relative), gradient norm "
            f"{card[1]:.6f} ({err[1]:.1e}), embeddings {err[2]:.1e}; the "
            "CPU's against fp64: " + ", ".join(f"{e:.1e}" for e in rounding)
            + f"; limit {limit:.1e}")
    ctx["mmrec_checked"] = True


def _mmrec_case(prep, model, dropout, width, dev):
    """mmrec.main's model and runner for one case of MMREC_CASES on `dev`
    over phase mmrec's prepared data; LATTICE's frozen graph built on the
    card (its ms, else None)."""
    from segmminterest_tpu_torch.mmrec import main as M
    args = M.build_parser().parse_args(["--inter_csv", "", "--model", model,
                                        "--edge_dropout", str(dropout),
                                        "--seed", "0"])
    feats, graph, frozen_ms = prep["feats"], prep["graph"], None
    if width == MMREC_CLIP_WIDTH:
        feats = np.load(os.path.join(MMREC_DIR, "prep.pt.clip.npy"))
        graph = prep["wide_graph"]
    if model == "LATTICE":
        t0 = time.perf_counter()
        graph = M.item_graph(model, feats, MMREC_KNN, dev)
        torch.cuda.synchronize()
        frozen_ms = (time.perf_counter() - t0) * 1e3
    m = M.build_model(args, prep["data"], dev, v_feat=feats, mm_graph=graph)
    return M.make_runner(args, prep["data"], m, dev), frozen_ms


def phase_mmrec(ctx):
    """MMRec's graph recommenders on the card at mmrec.main's defaults
    (emb 64, 64-d random features, --knn_k 10, B=2048, lr 1e-3) over
    build_mmrec_data of the script's CSV (197,064 frames, 260,476 train
    pairs): (a) each model's steps (BPR, LightGCN, LayerGCN, FREEDOM, BM3,
    LATTICE, MMGCN, SLMRec; FREEDOM also with --edge_dropout 0.1 and over
    a 197,064 x 1,025 feature matrix): MMREC_TIMED steps timed after 2 (ms,
    train pairs/s, peak device memory above what is held); LATTICE's
    frozen global kNN graph built on the card and its per-epoch rebuild;
    an evaluation of the 2,711 dev rows and an export of the 29,442 rows;
    (b) one fp32 step of each model on a small graph, card against CPU;
    LATTICE's kNN graphs card against CPU. Its data (built in a process of
    its own at the lowest priority from phase build on), its CLI runs (c:
    FREEDOM --test_cold 1 --save_logits, LATTICE, BPR --grid over lr,
    tasks.exp over two seeds; one thread each, at the lowest priority) and
    its checks (b) went beside phases build, wide and train_cli, and
    segrec's CLIs; where they did not, they run here. No pandas."""
    _start_mmrec_background(ctx)
    _join_background(ctx)
    prep = torch.load(ctx.pop("mmrec_prep").result()["path"],
                      weights_only=False)
    data = prep["data"]
    log(f"  mmrec's data: {data['n_items']} frames, {data['n_users']} users, "
        f"{len(data['train_u'])} train pairs, {len(data['dev'])} dev / "
        f"{len(data['test'])} test / {len(data['all'])} rows")
    if not ctx.get("mmrec_checked"):
        _mmrec_checks(ctx)
    dev = torch.device("cuda")
    for what, model, dropout, width in MMREC_CASES:
        t0 = time.perf_counter()
        r, frozen_ms = _mmrec_case(prep, model, dropout, width, dev)
        build_ms = (time.perf_counter() - t0) * 1e3
        r.init_state()
        t0 = time.perf_counter()
        keep, arrays = r.epoch_batches()
        torch.cuda.synchronize()
        draw_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        learned = r._rebuild_edges()
        torch.cuda.synchronize()
        rebuild_ms = (time.perf_counter() - t0) * 1e3
        batches = [[torch.from_numpy(a[s * MMREC_B:(s + 1) * MMREC_B]).to(dev)
                    for a in arrays] for s in range(MMREC_TIMED + 2)]
        for b in batches[:2]:   # warm-up
            r.train_step(*b, keep, learned)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for b in batches[2:]:
            loss = r.train_step(*b, keep, learned)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / MMREC_TIMED
        peak = torch.cuda.max_memory_allocated()
        if not math.isfinite(float(loss)):
            raise AssertionError(f"{what}: loss {float(loss)}")
        log(f"  {what} at B={MMREC_B}: {ms:.2f} ms/step "
            f"({MMREC_B / ms * 1e3:.0f} train pairs/s, {MMREC_TIMED} steps "
            f"after 2), peak device memory {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} "
            f"held); model and runner made {build_ms:.0f} ms, an epoch's "
            f"draws {draw_ms:.0f} ms")
        if frozen_ms is not None:
            log(f"  LATTICE's frozen global kNN graph ({data['n_items']} "
                f"frames, k {MMREC_KNN}, 64-d) built on the card: "
                f"{frozen_ms:.0f} ms; its learned graph rebuilt (each epoch)"
                f": {rebuild_ms:.0f} ms")
        if what == "FREEDOM":
            rng = np.random.default_rng(0)
            t0 = time.perf_counter()
            res = r.evaluate(None, data["dev"], data["frame_map"], rng)
            eval_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            logits = r.export_logits(None, data["all"], data["frame_map"])
            export_s = time.perf_counter() - t0
            if not _finite(res) or not all(len(v) == 40 and _finite(v)
                                           for v in logits.values()):
                raise AssertionError(f"FREEDOM: evaluation {res}")
            log(f"  FREEDOM's evaluation of {len(data['dev'])} dev rows "
                f"{eval_s * 1e3:.0f} ms (hr@5 {res['hr@5']:.4f}); export of "
                f"{len(data['all'])} rows {export_s * 1e3:.0f} ms "
                f"({len(logits)} keys)")
        del r, batches
        torch.cuda.empty_cache()
    if "pandas" in sys.modules:
        raise AssertionError("MMRec imported pandas")

# ---------------------------------------------------------------------------
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default=",".join(ALL_PHASES))
    args = p.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import segmminterest_tpu_torch  # noqa: F401 (fails outside a checkout)
    from segmminterest_tpu_torch.core import attention as A

    # the phases set SEGMM_ATTN_V2's switch themselves: on in attn_v2 (and
    # in its CLIs' environment), off everywhere else
    A.ATTN_V2 = False

    # fp32 comparisons in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}; tf32 off")
    t_all = time.perf_counter()
    ctx = {}
    for name in phases:
        t0 = time.perf_counter()
        log(f"phase {name}")
        {"build": lambda: phase_build(ctx), "kernels": phase_kernels,
         "serving": lambda: phase_serving(ctx),
         "default": lambda: phase_default(ctx),
         "train": lambda: phase_train(ctx),
         "train_default": lambda: phase_train_default(ctx),
         "train_bf16": lambda: phase_train_bf16(ctx),
         "ablation": lambda: phase_ablation(ctx),
         "fused_variants": lambda: phase_fused_variants(ctx),
         "attn_v2": lambda: phase_attn_v2(ctx),
         "wide": lambda: phase_wide(ctx),
         "train_cli": lambda: phase_train_cli(ctx),
         "watchtime": lambda: phase_watchtime(ctx),
         "msgpack": lambda: phase_msgpack(ctx),
         "segrec": lambda: phase_segrec(ctx),
         "segrec_models": lambda: phase_segrec_models(ctx),
         "segrec_seq": lambda: phase_segrec_seq(ctx),
         "segrec_runners": lambda: phase_segrec_runners(ctx),
         "mmrec": lambda: phase_mmrec(ctx)}[name]()
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    _join_background(ctx)
    log(f"all phases: {time.perf_counter() - t_all:.1f} s")
    if "memmap" in ctx:
        os.remove(ctx["memmap"])
    if set(phases) >= set(ALL_PHASES):
        idle = [k for k in RESULT["kernels"] if not RESULT["launches"].get(k)]
        if idle:
            raise AssertionError(f"kernels never launched on their path: "
                                 f"{idle}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if RESULT["kernels"]:
        for key, entry in RESULT["kernels"].items():
            entry["launches"] = RESULT["launches"].get(key)
        print(json.dumps({"kernels": list(RESULT["kernels"].values())}),
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
