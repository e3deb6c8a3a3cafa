#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py
(`--phases build,kernels` runs a subset while developing.)

Phases, each of which fails the run (non-zero exit) on any error:
  build          compile the CUDA kernels of core/csrc with nvcc for sm_90a;
                 count the HMMA instructions of K3's two libraries
  kernels        each kernel (K1f, K1b, K2f, K2b, K7b, K3f, K3b, K5f, K5b,
                 K4f, K4b, K6f, K6b) against its plain PyTorch version on
                 the card, at the main paths' stream shapes, fp32 and bf16,
                 dropout off and on; times at B=1024 (K1f and K2f also with
                 their dropout branch; K6 in turns with K2; K3 in bf16 by
                 its device time beside SDPA's)
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
                 + 18 K1b per step; one 32-row fp32 step against the CPU
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
                 CPU; skip_train's CLI with SEGMM_ATTN_V2=1 in its
                 environment and export_logits --serving 1 on its
                 checkpoint, each in a process of its own
  train_cli      skip_train's CLI over the small memmap, then export_logits
                 serving the checkpoint it wrote; the same for
                 --ablation_type CrossAtt and for --fuse_layer 1
The last line is {"ok": true, "device": {...}}; before it come the card's
name and power limit (nvidia-smi) and one JSON line describing the kernels.
It needs no network and writes only under build/ (the kernels in
build/segmm_torch_kernels/, its data and checkpoints in build/chip_smoke/).
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
K3_LIBS = ("masked_attention", "masked_attention_bwd")
HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
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
              "train_default", "ablation", "fused_variants", "attn_v2",
              "train_cli")


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
def phase_build():
    from segmminterest_tpu_torch.core import build
    t0 = time.perf_counter()
    paths = build.build_all()
    for name, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
            elif "Compiling entry function" in line and name in K3_LIBS:
                log(f"  ptxas {name}: {line.split('function', 1)[1].strip()}")
    for name, p in paths.items():
        log(f"  built {os.path.relpath(p, ROOT)}")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    # K3's bf16 bodies run on the tensor cores: their libraries must hold
    # HMMA (mma.sync) instructions
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    for name in K3_LIBS:
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])],
                              capture_output=True, text=True, timeout=300)
        n = sum("HMMA" in ln for ln in sass.stdout.splitlines())
        log(f"  {name}: {n} HMMA instructions (cuobjdump -sass)")
        if sass.returncode or not n:
            raise AssertionError(f"{name}: no HMMA instruction in its "
                                 f"library ({sass.stderr[-400:]})")


def _masks(g, B, L, dev, allow_empty=True):
    lo = 0 if allow_empty else 1
    n = torch.randint(lo, L + 1, (B,), generator=g, device=dev)
    return torch.arange(L, device=dev)[None, :] < n[:, None]


def _k1_inputs(g, B, Lq, L1, L2, dt, dev):
    def r(L):
        return torch.randn(B, L, HEADS, D_MODEL // HEADS, generator=g,
                           device=dev).to(dt)
    return ((r(Lq), r(Lq), r(L1), r(L2), r(L1), r(L2)),
            (_masks(g, B, Lq, dev), _masks(g, B, L1, dev, False),
             _masks(g, B, L2, dev)))


def _k2_inputs(g, B, Lq, L1, L2, dt, dev):
    d = D_MODEL

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
    torch.cuda.synchronize()

    # the main path's largest launch: backbone1's video stream at B=1024;
    # K1 in fp32 (default config), K2 in bf16 (serving preset)
    B, (Lq, L1, L2) = 1024, STREAM_SHAPES[0]
    Lk = L1 + L2
    qkv, m = _k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
    err1 = _check("K1 B=1024", k1(qkv, m), k1_plain(qkv, m), torch.float32)
    q1, q2, kk1, kk2, v1, v2 = qkv
    # yardstick: SDPA over the concat construction (attention.py:362-371)
    # with an additive -10000 mask; never called by the port, and unlike K1
    # it does not give padded query rows the uniform softmax
    qc = torch.cat([q1, q2], -1).transpose(1, 2)
    kc = torch.cat([torch.cat([kk1, torch.zeros_like(kk1)], -1),
                    torch.cat([torch.zeros_like(kk2), kk2], -1)],
                   1).transpose(1, 2)
    vc = torch.cat([v1, v2], 1).transpose(1, 2)
    pair = A._pair_mask(m[0], torch.cat([m[1], m[2]], 1))
    bias = torch.zeros(pair.shape, device=dev).masked_fill(~pair, -10000.0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms1 = _time_ms(lambda: k1(qkv, m), 20)
    plain1 = _time_ms(lambda: k1_plain(qkv, m), 5)
    lib1 = _time_ms(lambda: sdpa(qc, kc, vc, attn_mask=bias, scale=scale),
                    20)
    e = _elem(torch.float32)
    bytes1 = (e * B * H * Dh * (3 * Lq + 2 * L1 + 2 * L2)
              + 4 * B * (Lq + L1 + L2))
    flops1 = 4.0 * B * H * Lq * Lk * Dh
    _record("K1", "two_block_attention_fwd (K1f)",
            "two_block_attention.cu", 527, err1, ms1, plain1, bytes1,
            flops1 / PEAK_FLOPS[torch.float32], lib1)
    log(f"  K1f fp32 B=1024 {(Lq, L1, L2)}: {ms1:.3f} ms (plain "
        f"{plain1:.3f}, sdpa {lib1:.3f}) max|err| {err1:.3g}")

    # K1b, fp32, B=1024: gradients of the six inputs
    gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev)
    A.reset_launch_counts()
    got = _grads(lambda *t: k1(t, m), qkv, gq)
    want = A.two_block_attention_bwd_plain(*qkv, *m, gq, scale)
    err1b = _rel_err("K1b B=1024", got, want, BWD_TOL[torch.float32])
    del got, want
    leaves = [t.detach().requires_grad_() for t in qkv]
    out = k1(leaves, m)
    ms1b = _time_ms(lambda: torch.autograd.grad(out, leaves, gq,
                                                retain_graph=True), 10)
    plain1b = _time_ms(lambda: A.two_block_attention_bwd_plain(
        *qkv, *m, gq, scale), 3)
    cl = [t.detach().requires_grad_() for t in (qc, kc, vc)]
    lib_out = sdpa(*cl, attn_mask=bias, scale=scale)
    gc = gq.transpose(1, 2)
    lib1b = _time_ms(lambda: torch.autograd.grad(lib_out, cl, gc,
                                                 retain_graph=True), 10)
    bytes1b = (e * B * H * Dh * (5 * Lq + 4 * L1 + 4 * L2)
               + 4 * B * (Lq + L1 + L2))
    flops1b = 10.0 * B * H * Lq * Lk * Dh
    _record("K1b", "two_block_attention_bwd (K1b)",
            "two_block_attention_bwd.cu", 558, err1b, ms1b, plain1b,
            bytes1b, flops1b / PEAK_FLOPS[torch.float32], lib1b)
    log(f"  K1b fp32 B=1024 {(Lq, L1, L2)}: {ms1b:.3f} ms (plain "
        f"{plain1b:.3f}, sdpa backward {lib1b:.3f}) max rel err "
        f"{err1b:.3g}")
    del qkv, qc, kc, vc, bias, cl, lib_out, leaves, out

    x, ws, m = _k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
    err2 = _check("K2 B=1024", k2(x, ws, m), k2_plain(x, ws, m),
                  torch.bfloat16)
    ms2 = _time_ms(lambda: k2(x, ws, m), 10)
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
    timed = {}
    for v3, name in ((False, "K2b"), (True, "K7b")):
        A.ATTN_V3_BWD = v3
        got = torch.autograd.grad(out, leaves, gx, retain_graph=True)
        timed[name] = (_rel_err(f"{name} B=1024", got, want,
                                BWD_TOL[torch.bfloat16]),
                       _time_ms(lambda: torch.autograd.grad(
                           out, leaves, gx, retain_graph=True), 5))
        A.ATTN_V3_BWD = False
        del got
    plain2b = _time_ms(lambda: A.proj_two_block_attention_bwd_plain(
        *x, *ws, *m, gx, H, scale), 3)
    # K2b: the recomputed projections and QK^T on the bf16 tensor cores
    # (q and k are bf16); dx and dW and the core's dV, dP, dQ, dK with fp32
    # operands; reads x, W, g once, writes dx, dW, db once
    recompute = proj_flops / PEAK_FLOPS[torch.bfloat16] \
        + 2.0 * B * Lq * Lk * d / PEAK_FLOPS[torch.bfloat16]
    core_flops = 8.0 * B * Lq * Lk * d
    ops2b = recompute + ((2 * proj_flops + core_flops)
                         / PEAK_FLOPS[torch.float32])
    bytes2b = (e * (2 * B * d * (Lq + L1 + L2) + B * Lq * d + 6 * (d * d + d))
               + 4 * 6 * (d * d + d) + 4 * B * (Lq + L1 + L2))
    _record("K2b", "proj_two_block_attention_bwd (K2b)",
            "proj_two_block_attention_bwd.cu", 808, timed["K2b"][0],
            timed["K2b"][1], plain2b, bytes2b, ops2b, None)
    # K7b does the recompute and the core; dx and dW are torch.matmul
    ops7b = recompute + core_flops / PEAK_FLOPS[torch.float32]
    bytes7b = (e * (B * d * (Lq + L1 + L2) + B * Lq * d + 6 * (d * d + d))
               + 4 * B * d * n_rows // 2 + 4 * B * (Lq + L1 + L2))
    _record("K7b", "proj_two_block_attention_qkv_bwd (K7b)",
            "proj_two_block_attention_bwd.cu", 1568, timed["K7b"][0],
            timed["K7b"][1], plain2b, bytes7b, ops7b, None)
    log(f"  K2b bf16 B=1024 {(Lq, L1, L2)}: {timed['K2b'][1]:.3f} ms, K7b "
        f"path (qkv pass + torch.matmul) {timed['K7b'][1]:.3f} ms (plain "
        f"{plain2b:.3f}); max rel err K2b {timed['K2b'][0]:.3g}, K7b "
        f"{timed['K7b'][0]:.3g}")
    del leaves, out, want
    # the other three launch shapes of a layer, timed for PERF.md
    for (Lq, L1, L2) in STREAM_SHAPES[1:]:
        x, ws, m = _k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
        qkv, mk = _k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
        gx = torch.randn(B, Lq, d, generator=g, device=dev).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_()
                  for t in tuple(x) + tuple(ws)]
        out = k2(leaves[:3], leaves[3:], m)
        k1l = [t.detach().requires_grad_() for t in qkv]
        out1 = k1(k1l, mk)
        g1 = torch.randn_like(out1)
        log(f"  B=1024 {(Lq, L1, L2)}: K2f bf16 "
            f"{_time_ms(lambda: k2(x, ws, m), 5):.3f} ms, K2b bf16 "
            f"{_time_ms(lambda: torch.autograd.grad(out, leaves, gx, retain_graph=True), 3):.3f}"
            f" ms, K1f fp32 {_time_ms(lambda: k1(qkv, mk), 5):.3f} ms, K1b "
            f"fp32 {_time_ms(lambda: torch.autograd.grad(out1, k1l, g1, retain_graph=True), 3):.3f}"
            " ms")
        del leaves, out, k1l, out1

    # the training variants of K1f and K2f (compiled with the dropout
    # branch), alone, at (40, 40, 100)
    (Lq, L1, L2) = STREAM_SHAPES[0]
    qkv, mk = _k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
    x, ws, m = _k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
    log(f"  dropout variants, B=1024 {(Lq, L1, L2)}, rate {DROP_RATE}: K1f "
        f"fp32 {_time_ms(lambda: k1(qkv, mk, DROP_RATE, 5), 20):.3f} ms "
        f"(eval variant {_time_ms(lambda: k1(qkv, mk), 20):.3f}), K2f bf16 "
        f"{_time_ms(lambda: k2(x, ws, m, DROP_RATE, 5), 10):.3f} ms (eval "
        f"variant {_time_ms(lambda: k2(x, ws, m), 10):.3f})")
    del qkv, mk, x, ws, m
    _k3_kernels(A, g, dev)
    _k5_kernels(A, g, dev)
    _k4_kernels(A, g, dev)
    # K6 computes K2's function: its bound is K2's at the same shapes
    _k6_kernels(A, g, dev, (bytes2, flops2 / PEAK_FLOPS[torch.bfloat16]),
                (bytes2b, ops2b))
    A.reset_launch_counts()


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


def _k3_kernels(A, g, dev):
    """K3f and K3b against their plain versions at the ablations' (Lq, Lk)
    shapes (bf16 also at K3_MAX_SHAPE, and with near-one-hot rows), B=64,
    fp32 and bf16, dropout off and on, padded rows; then their times at
    B=1024: fp32 on CrossAtt's video stream (40, 100), bf16 on both of its
    feature streams, (40, 100) and (100, 40), beside SDPA's."""
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
        cases = [(s, 1.0) for s in K3_SHAPES]
        if dt == torch.bfloat16:
            # the largest shape; logits of magnitude ~50 (near-one-hot rows)
            cases += [(K3_MAX_SHAPE, 1.0), (K3_SHAPES[0], 50.0)]
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
    torch.cuda.synchronize()

    B = 1024
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for dt, shapes in ((torch.float32, K3_SHAPES[:1]),
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
            dev_b = _device_ms(bwd, 10, K3_NAMES[1:])
            dlib_f, dlib_b = _device_ms(lib_fwd, 20), _device_ms(lib_bwd, 10)
            timed[dt, (Lq, Lk)] = dict(
                err_f=err_f, err_b=err_b, ms_f=ms_f, ms_b=ms_b,
                plain_f=plain_f, plain_b=plain_b, lib_f=lib_f, lib_b=lib_b,
                dev_f=dev_f, dev_b=dev_b, dlib_f=dlib_f, dlib_b=dlib_b)
            log(f"  K3 {str(dt)[6:]} B=1024 {(Lq, Lk)}: K3f {ms_f:.3f} ms "
                f"(device {_ms(dev_f)}; plain {plain_f:.3f}, sdpa "
                f"{lib_f:.3f}, device {_ms(dlib_f)}), K3b {ms_b:.3f} ms "
                f"(device {_ms(dev_b)}; plain {plain_b:.3f}, sdpa backward "
                f"{lib_b:.3f}, device {_ms(dlib_b)}); max err K3f "
                f"{err_f:.3g}, K3b {err_b:.3g}")
            del qkv, m, gq, leaves, out, ql, kl, vl, bias, lib_out, gl

    # bytes: K3f reads q, k, v and writes out; K3b reads q, k, v, g and
    # writes dq, dk, dv; both read the two masks (int32)
    def cost(dt, Lq, Lk):
        elems, e = B * H * Dh, _elem(dt)
        masks = 4 * B * (Lq + Lk)
        return ((e * elems * (2 * Lq + 2 * Lk) + masks,
                 4.0 * B * H * Lq * Lk * Dh / PEAK_FLOPS[dt]),
                (e * elems * (3 * Lq + 4 * Lk) + masks,
                 10.0 * B * H * Lq * Lk * Dh / PEAK_FLOPS[dt]))

    # fp32 (the default config's dtype) by CUDA events around the
    # wrapper; bf16 by the kernels' device time, beside SDPA's
    t = timed[torch.float32, K3_SHAPES[0]]
    (fb, fo), (bb, bo) = cost(torch.float32, *K3_SHAPES[0])
    _record("K3", "masked_attention_fwd (K3f, fp32)", "masked_attention.cu",
            126, max(worst["K3f", torch.float32], t["err_f"]), t["ms_f"],
            t["plain_f"], fb, fo, t["lib_f"])
    _record("K3b", "masked_attention_bwd (K3b, fp32)",
            "masked_attention_bwd.cu", 156,
            max(worst["K3b", torch.float32], t["err_b"]), t["ms_b"],
            t["plain_b"], bb, bo, t["lib_b"])
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
    for (Lq, Lk) in K3_SHAPES[:2]:
        (fb, fo), (bb, bo) = cost(torch.bfloat16, Lq, Lk)
        log(f"  K3 bf16 bounds at B=1024 {(Lq, Lk)}: K3f "
            f"{1e3 * max(fb / HBM_BYTES_PER_S, fo):.3f} ms, K3b "
            f"{1e3 * max(bb / HBM_BYTES_PER_S, bo):.3f} ms")


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
    ms_f = _time_ms(lambda: k5(t, m), 10)
    plain_f = _time_ms(lambda: plain(t, m), 3)
    leaves = [x.detach().requires_grad_() for x in t]
    out = k5(leaves, m)
    got = torch.autograd.grad(out, leaves, gs, retain_graph=True)
    err_b = _rel_err("K5b B=1024", got, plain_bwd(t, m, gs), BWD_TOL[dt])
    del got
    ms_b = _time_ms(lambda: torch.autograd.grad(out, leaves, gs,
                                                retain_graph=True), 5)
    plain_b = _time_ms(lambda: plain_bwd(t, m, gs), 2)
    e = _elem(dt)
    # the two streams: video (Lv, Lv, Lu), user (Lu, Lv, Lu)
    shapes = ((Lv, Lv, Lu), (Lu, Lv, Lu))
    proj = sum(_proj_flops(B, d, *s) for s in shapes)
    core_f = sum(4.0 * B * s[0] * (s[1] + s[2]) * d for s in shapes)
    rows, masks = B * d * (Lv + Lu), 4 * B * (Lv + Lu)
    params = 12 * (d * d + d)
    bytes_f = e * (2 * rows + params) + masks
    bytes_b = e * (3 * rows + params) + 4 * params + masks
    _record("K5", "dual_stream_attention_fwd (K5f)",
            "dual_stream_attention.cu", 68,
            max(worst["K5f"], err_f), ms_f, plain_f, bytes_f,
            (proj + core_f) / PEAK_FLOPS[dt], None, "dual_kernel.py")
    _record("K5b", "dual_stream_attention_bwd (K5b)",
            "dual_stream_attention_bwd.cu", 104, max(worst["K5b"], err_b),
            ms_b, plain_b, bytes_b, (proj + core_f / 2) / PEAK_FLOPS[dt]
            + (2 * proj + 2 * core_f) / PEAK_FLOPS[torch.float32], None,
            "dual_kernel.py")
    log(f"  K5 bf16 B=1024 {DUAL_SHAPE}: K5f {ms_f:.3f} ms (plain "
        f"{plain_f:.3f}), K5b {ms_b:.3f} ms (plain {plain_b:.3f}); max err "
        f"K5f {err_f:.3g}, K5b {err_b:.3g}")
    del t, m, gs, leaves, out
    torch.cuda.empty_cache()


def _k4_kernels(A, g, dev):
    """K4f and K4b (a whole layer stream) against their plain versions on
    the four stream shapes, B=64, fp32 and bf16, dropout off and on; then
    their times at B=1024 in bf16 on the largest launch (100, 40, 100)."""
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = HEADS, D_MODEL
    ff = d
    scale = 1.0 / math.sqrt(d // H)

    def inputs(B, Lq, L1, L2, dt, ff=d):
        xs = [torch.randn(B, L, d, generator=g, device=dev).to(dt)
              for L in (Lq, L1, L2)]

        def dense(n_out, n_in):
            return [(torch.randn(n_out, n_in, generator=g, device=dev)
                     / math.sqrt(n_in)).to(dt),
                    (0.1 * torch.randn(n_out, generator=g, device=dev)
                     ).to(dt)]

        def ln():  # each LayerNorm its own (scale, bias), fp32
            return [1 + 0.1 * torch.randn(d, generator=g, device=dev),
                    0.1 * torch.randn(d, generator=g, device=dev)]

        ep = dense(d, d) + ln() + dense(ff, d) + dense(d, ff) + ln()
        return (xs + _proj_weights(g, d, 6, dt, dev) + ep,
                (_masks(g, B, Lq, dev), _masks(g, B, L1, dev, False),
                 _masks(g, B, L2, dev)))

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
    ms_f = _time_ms(lambda: k4(t, m), 10)
    plain_f = _time_ms(lambda: plain(t, m), 3)
    leaves = [x.detach().requires_grad_() for x in t]
    out = k4(leaves, m)
    got = torch.autograd.grad(out, leaves, gx, retain_graph=True)
    err_b = _rel_err("K4b B=1024", got, plain_bwd(t, m, gx), BWD_TOL[dt])
    del got
    ms_b = _time_ms(lambda: torch.autograd.grad(out, leaves, gx,
                                                retain_graph=True), 5)
    plain_b = _time_ms(lambda: plain_bwd(t, m, gx), 2)
    e = _elem(dt)
    proj = _proj_flops(B, d, Lq, L1, L2)
    core_f = 4.0 * B * Lq * (L1 + L2) * d
    epi = 2.0 * B * Lq * (d * d + 2 * d * ff)      # the three Denses
    params = 6 * (d * d + d) + d * d + 2 * d * ff + 2 * d + ff
    rows_in, masks = B * d * (Lq + L1 + L2), 4 * B * (Lq + L1 + L2)
    ln = 4 * 4 * d
    bytes_f = e * (rows_in + B * Lq * d + params) + ln + masks
    bytes_b = e * (2 * rows_in + B * Lq * d + params) + 4 * (params + 4 * d) \
        + ln + masks
    # K4b: the recomputed forward (projections, QK^T and PV, Denses) in the
    # compute dtype, as K4f; then the products of the backward with fp32
    # operands: dV, dP, dQ, dK (2 core_f), dx and dW of the projections and
    # the epilogue's dgrad and dW
    ops_b = ((proj + core_f + epi) / PEAK_FLOPS[dt]
             + (2 * proj + 2 * core_f + 2 * epi) / PEAK_FLOPS[torch.float32])
    _record("K4", "layer_stream_fwd (K4f)", "layer_stream.cu", 140,
            max(worst["K4f"], err_f), ms_f, plain_f, bytes_f,
            (proj + core_f + epi) / PEAK_FLOPS[dt], None, "layer_kernel.py")
    _record("K4b", "layer_stream_bwd (K4b)", "layer_stream_bwd.cu", 178,
            max(worst["K4b"], err_b), ms_b, plain_b, bytes_b, ops_b, None,
            "layer_kernel.py")
    log(f"  K4 bf16 B=1024 {(Lq, L1, L2)}: K4f {ms_f:.3f} ms (plain "
        f"{plain_f:.3f}), K4b {ms_b:.3f} ms (plain {plain_b:.3f}); max err "
        f"K4f {err_f:.3g}, K4b {err_b:.3g}")
    # the other three launch shapes of a layer, timed for PERF.md
    for shape in (STREAM_SHAPES[0],) + STREAM_SHAPES[2:]:
        t, m = inputs(B, *shape, dt)
        gx = torch.randn(B, shape[0], d, generator=g, device=dev).to(dt)
        leaves = [x.detach().requires_grad_() for x in t]
        out = k4(leaves, m)
        log(f"  B=1024 {shape}: K4f bf16 {_time_ms(lambda: k4(t, m), 5):.3f}"
            " ms, K4b bf16 "
            f"{_time_ms(lambda: torch.autograd.grad(out, leaves, gx, retain_graph=True), 3):.3f}"
            " ms")
    del t, m, gx, leaves, out
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
        for v in (1, 2, 2, 1):
            f = _time_ms(lambda: attn(x, ws, m, v), 10 if i == 0 else 5)
            b = _time_ms(lambda: torch.autograd.grad(
                outs[v], leaves, gx, retain_graph=True), 5 if i == 0 else 3)
            ms.setdefault(v, []).append((f, b))
        (k2f, k2b), (k6f, k6b) = (
            tuple(sum(t[j] for t in ms[v]) / 2 for j in (0, 1)) for v in (1, 2))
        log(f"  B=1024 bf16 {shape}: K6f {k6f:.3f} ms, K6b {k6b:.3f} ms; K2f "
            f"{k2f:.3f}, K2b {k2b:.3f} (same inputs, in turns)")
        if i:
            continue
        err_f = _check("K6f B=1024", outs[2], plain(x, ws, m), dt)
        got = torch.autograd.grad(outs[2], leaves, gx, retain_graph=True)
        err_b = _rel_err("K6b B=1024", got, plain_bwd(x, ws, m, gx),
                         BWD_TOL[dt])
        del got
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
                                   n_users=150, per_user=(250, 300),
                                   n_videos=10_000, seed=1)
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

    # device latency per batch size (a full batch already on the card)
    for bs in (1024, 512, 256, 128):
        batch = next(iter(BatchIterator(
            reader, reader.tables["train"], bs, feature_store=store,
            seed=cfg.seed, prefetch_size=0)))
        dev_batch = {"_dev": engine.put_batch(batch)}
        ms = _time_ms(lambda: engine.eval_step(state, dev_batch), 5)
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
K2_NAMES = ("proj_two_block", "dx_kernel", "dw_kernel", "dw_reduce_kernel")
K1_NAMES = ("two_block_fwd_kernel", "two_block_bwd_kernel")
# K3f and K3b, fp32 (masked_*_kernel) and bf16 (masked_*_mma_kernel)
K3_NAMES = ("masked_fwd", "masked_bwd")


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
    the same step on the CPU."""
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

    # 32 rows, fp32, K2 route, dropout off (nn.Dropout draws from another
    # generator on each device): the card against the CPU's plain versions
    small = next(iter(BatchIterator(reader, reader.tables["train"], 32,
                                    feature_store=store, seed=7,
                                    prefetch_size=0)))
    one = cfg.replace(train_batch_size=32, dropout=0.0, fuse_qkv=True)
    got = {}
    for dev, table in (("cuda", ctx["table"]),
                       ("cpu", tuple(t.cpu() for t in ctx["table"]))):
        eng = InterestEngine(one, reader.n_users, reader.n_items,
                             feature_table=table, device=dev)
        _, ld = eng.train_step(eng.init_state(), small)
        got[dev] = (float(ld["loss"]), float(eng.last_grad_norm))
        del eng, table
    dl = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    dg = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
    log(f"  32-row fp32 step, card vs CPU: loss {got['cuda'][0]:.6f} vs "
        f"{got['cpu'][0]:.6f} (rel {dl:.2g}), grad norm {got['cuda'][1]:.6f}"
        f" vs {got['cpu'][1]:.6f} (rel {dg:.2g})")
    # fp32 through five layers in another summation order: 1e-4 relative
    if not (dl <= 1e-4 and dg <= 1e-4):
        raise AssertionError(f"card and CPU training steps differ: {got}")


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


def _subprocess_json(args, env, what):
    """Run `python -m args` from the checkout's root with `env`; its
    stdout's last JSON object and its stderr. Logs the wall time and when
    each of its log lines came, for where a CLI run's time goes."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
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
    fp32 step on the card against the CPU; then skip_train's CLI with
    SEGMM_ATTN_V2=1 in its environment and export_logits --serving 1 on the
    checkpoint it wrote, each in a process of its own."""
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

    # the CLIs with the real switch, SEGMM_ATTN_V2=1 in their environment
    memmap, lineid = _cli_files(ctx)
    env = dict(os.environ, SEGMM_ATTN_V2="1")
    common = ["--sample_csv", ctx["csv"], "--min_interactions", "100",
              "--num_warmup", "80", "--memmap", memmap, "--lineid_map",
              lineid, "--seed", "7"]
    t0 = time.perf_counter()
    res, err = _subprocess_json(
        ["segmminterest_tpu_torch.tasks.skip_train"] + common + [
            "--debug", "1", "--compute_dtype", "bfloat16", "--fuse_qkv", "1",
            "--table_quant", "int8", "--remat", "0", "--ckpt_dir",
            os.path.join(WORK, "train_cli_v2")], env, "skip_train (v2)")
    launches, steps = res["kernel_launches"], res["steps"]
    if "K2 version 2" not in err or steps < 1 or \
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
    _, err = _subprocess_json(
        ["segmminterest_tpu_torch.tasks.export_logits"] + common + [
            "--serving", "1", "--splits", "test", "--work_dir",
            res["work_dir"], "--out_dir", out_dir], env,
        "export_logits (v2)")
    launches = _logged_launches(err, "export_logits (v2)")
    with open(os.path.join(out_dir, "interest_logits.json")) as f:
        served = json.load(f)
    n_test = len(ctx["reader"].tables["test"])
    if len(served) != n_test or not all(
            len(v) == 40 and np.isfinite(v).all() for v in served.values()) \
            or not launches.get(K6_KEYS[0]) or \
            any(k in launches for k in K2_KEYS):
        raise AssertionError(f"export_logits SEGMM_ATTN_V2=1: {len(served)} "
                             f"rows of {n_test}, launches {launches}")
    log(f"  export_logits --serving 1, SEGMM_ATTN_V2=1: {len(served)} rows of "
        f"40 finite logits; launches {launches}")


def phase_train_cli(ctx):
    """skip_train's CLI (production flags, --debug 1) over the small
    memmap, then export_logits serving the checkpoint it wrote."""
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.tasks import export_logits as X
    from segmminterest_tpu_torch.tasks import skip_train

    _data(ctx)
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
        {"build": phase_build, "kernels": phase_kernels,
         "serving": lambda: phase_serving(ctx),
         "default": lambda: phase_default(ctx),
         "train": lambda: phase_train(ctx),
         "train_default": lambda: phase_train_default(ctx),
         "ablation": lambda: phase_ablation(ctx),
         "fused_variants": lambda: phase_fused_variants(ctx),
         "attn_v2": lambda: phase_attn_v2(ctx),
         "train_cli": lambda: phase_train_cli(ctx)}[name]()
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
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
