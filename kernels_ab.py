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
  * K2f, K2b and K7b in bf16 at B=1024 at the four stream shapes, dropout
    off and on, by device time: the whole call and each of its kernels
    (K2b: the qkv pass, dx, dW and their sum; K7b: the qkv pass, beside the
    call with its torch.matmul products), each with its error against the
    plain version; whether two K2b calls give bit-equal dW and db; and PR
    the projection stage of K2f's per-(head, batch row) body alone
    (kernels_ab_proj_stage.cu, built
    against the checkout's core/csrc where it has projection.cuh);
  * K4f and K4b (`k4_bf16`, the whole-layer kernels of --fuse_layer 1) in
    bf16 at B=1024 at the four stream shapes, dropout off and on, by device
    time: the whole call and each of its kernels, each with its error
    against the plain version, and whether two K4b calls give bit-equal dW
    and db;
  * K6b and K5b (`k6_bf16`, `k5_bf16`: SEGMM_ATTN_V2's backward at the
    four stream shapes, fuse_dual's on backbone 1's stream pair) in bf16
    at B=1024, dropout off and on, by device time: the whole call and each
    of its kernels, with K6f / K5f beside them, each with its error against
    the plain version, whether two calls give bit-equal dW and db, and the
    bound of chip_smoke.py's pricing;
  * the bodies no other part times (`untimed`): bf16 K1f and K1b, fp32
    K2f and K2b, fp32 K4f and K4b at B=1024 at the four stream shapes,
    dropout off, by device time, beside their bounds (bf16 K1 also beside
    its plain version and SDPA's bf16 forward and backward);
  * the main path end to end (`e2e`): production training, fuse_dual,
    SEGMM_ATTN_V2 and fuse_layer at B=1024 (ms and device ms per step,
    peak memory), the serving preset (device latency at B = 1024 / 512 /
    256 / 128, interactions/s over the test split) and fuse_layer served
    (device latency at B=1024);
  * every kernel at 4 heads of 128 (`wide`: d_model 512, skip_train
    --nhead 4) at B=1024, fp32 and bf16, dropout off, by device time, each
    with its bound at its own shape and dtype (_wide_bounds: bytes and
    operations depend on d, not on its heads) and its error against the
    plain version: K1, K2 and K6
    at the four stream shapes, K3 at (40, 100) and (100, 40), K5 on its
    stream pair, K4 at (40, 40, 100) and (100, 40, 100); a checkout whose
    kernels take no head dim 128 reports the error it raises;
  * fp32 K2, K6, K4 and K5 at 16 heads of 32 on the bodies the checkout
    picks (`fp32_routes`; since the fp32 route of k2_body, the pair
    projections, K1's 3xTF32 core, the CUDA-core chain and epilogue, in
    the parent the per-(head, batch row) CUDA-core bodies), each beside its
    bound and its error against the plain version;
  * the fp32 training configurations on the 3xTF32 bodies (`fp32_train`:
    the default, K1, and CrossAtt, K3) at B=1024: ms and device ms per
    step, the kernels' share;
  * fp32 and bf16 K3f and K3b on near-one-hot rows (`k3_onehot`: q x 50
    at (40, 100), B=64, ONEHOT_DRAWS seeded draws, dropout off and on),
    every draw's error against the plain version;
  * every kernel at a long stream (`long`: (200, 150, 300), K6 (200, 152,
    300), K3 (200, 300), K5 (150, 300)), past its core's one-chunk shapes,
    at B=1024, 16 heads of 32, fp32 and bf16, dropout off, by device time
    (every kernel of the call), each beside its bound (_wide_bounds);
  * the default training configuration in bf16 (`bf16_default`: K1 in
    bf16, layer remat) at B=1024, as `fp32_train` measures its two;
  * the card's name and power limit (nvidia-smi).
`--parts` picks some of these (default: all).
To compare two checkouts, run it on each in turns in one call on one card:
A, B, B, A. The measuring code is this file's and chip_smoke.py's whatever
DIR is, so only the port under test differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import torch

import chip_smoke as C

K3_SHAPES = ((40, 100), (100, 40))
PARTS = ("k2_bf16", "k4_bf16", "k6_bf16", "k5_bf16", "e2e", "k3_bf16",
         "fp32_fwd", "fp32_bwd", "fp32_bwd_sha256", "served", "k3_onehot",
         "untimed", "wide", "fp32_routes", "fp32_train", "long",
         "bf16_default")
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


def _short(name):
    """A profiler kernel row's name without its template arguments."""
    name = name.split("(")[0].split("<")[0]
    return name.replace("void ", "").replace("segmm::", "")[:60]


def _breakdown(fn, iters):
    """Device ms per call of fn() by kernel (short names, summed)."""
    out = {}
    for k, v in C._device_kernels(fn, iters).items():
        out[_short(k)] = out.get(_short(k), 0.0) + v
    return out


def _old_proj_stage(root):
    """The projection stage of K2f's per-(head, batch row) body alone, built
    from the checkout's proj_attention.cuh (None where the checkout has
    none)."""
    csrc = os.path.join(root, "segmminterest_tpu_torch", "core", "csrc")
    if not os.path.exists(os.path.join(csrc, "proj_attention.cuh")):
        return None
    from segmminterest_tpu_torch.core import build
    out_dir = os.path.join(root, "build", "kernels_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libk2_proj_stage.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "kernels_ab_proj_stage.cu")
    if not os.path.exists(lib):
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o",
                        lib, src], check=True, capture_output=True,
                       timeout=600)
    fn = ctypes.CDLL(lib).k2_proj_stage
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


def _k2_bf16(A, g, dev, root):
    """K2f, K2b and K7b in bf16 at B=1024, by device time per kernel."""
    H, d = C.HEADS, C.D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    stage = _old_proj_stage(root)
    out = {}
    for (Lq, L1, L2) in C.STREAM_SHAPES:
        x, ws, m = C._k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
        gx = torch.randn(B, Lq, d, generator=g, device=dev).to(torch.bfloat16)
        row = {}
        if stage is not None:
            sink = torch.empty(B * H, device=dev)
            ptrs = (ctypes.c_void_p * 15)(*(t.data_ptr() for t in
                                            tuple(x) + tuple(ws)))

            def proj():
                code = stage(ptrs, sink.data_ptr(), B, Lq, L1, L2, d, H,
                             ctypes.c_void_p(
                                 torch.cuda.current_stream().cuda_stream))
                if code:
                    raise RuntimeError(f"k2_proj_stage: CUDA error {code}")
            row["k2f_old_proj_stage_ms"] = C._device_ms(proj, 10)
            row["k2f_old_proj_stage_events_ms"] = C._time_ms(proj, 10)
        for rate in (0.0, C.DROP_RATE):
            def fwd(rate=rate, t=None):
                a = t if t is not None else tuple(x) + tuple(ws)
                return A.fused_proj_two_block_attention(
                    *a, *m, num_heads=H, scale=scale, dropout_rate=rate,
                    seed=SEED, deterministic=rate == 0)
            kf = _breakdown(fwd, 10)
            kf_events = C._time_ms(fwd, 10)
            err_f = _rel([fwd()], [A.proj_two_block_attention_plain(
                *x, *ws, *m, H, scale, rate, SEED)])
            leaves = [t.detach().requires_grad_()
                      for t in tuple(x) + tuple(ws)]
            o = fwd(rate, leaves)
            want = A.proj_two_block_attention_bwd_plain(
                *x, *ws, *m, gx, H, scale, rate, SEED)

            def bwd(o=o, leaves=leaves):
                return torch.autograd.grad(o, leaves, gx, retain_graph=True)
            kb = _breakdown(bwd, 5)
            kb_events = C._time_ms(bwd, 5)
            first, second = bwd(), bwd()
            same = all(torch.equal(a, b) for a, b in zip(first[3:],
                                                         second[3:]))
            err_b = _rel(first, want)
            del first, second
            A.ATTN_V3_BWD = True
            try:
                k7 = _breakdown(bwd, 5)
                err_7 = _rel(bwd(), want)
            finally:
                A.ATTN_V3_BWD = False
            del o, leaves, want

            def ours(rows):
                return sum(v for k, v in rows.items()
                           if any(n in k for n in C.K2_NAMES))
            tag = f"rate {rate}"
            row[tag] = dict(
                k2f_ms=ours(kf), k2f_events_ms=kf_events, k2f_kernels=kf,
                k2f_err=err_f, k2b_ms=ours(kb), k2b_events_ms=kb_events,
                k2b_kernels=kb, k2b_err=err_b,
                k2b_dw_db_bit_equal=same, k7b_ms=ours(k7),
                k7b_call_ms=sum(k7.values()), k7b_kernels=k7, k7b_err=err_7)
            print(f"  K2 {(Lq, L1, L2)} {tag}: K2f {C._ms(ours(kf))} ms "
                  f"(events {kf_events:.3f}; err {err_f:.2g}), K2b "
                  f"{C._ms(ours(kb))} ms (events {kb_events:.3f}; err "
                  f"{err_b:.2g}, dW/db bit-equal {same}), K7b "
                  f"{C._ms(ours(k7))} ms (call {sum(k7.values()):.3f}); "
                  f"K2f {kf}; K2b {kb}", flush=True)
        if "k2f_old_proj_stage_ms" in row:
            print(f"  K2 {(Lq, L1, L2)}: the per-(head, batch row) "
                  "projection stage alone "
                  f"{C._ms(row['k2f_old_proj_stage_ms'])} ms (CUDA events "
                  f"{row['k2f_old_proj_stage_events_ms']:.3f})", flush=True)
        out[f"{Lq}x{L1}x{L2}"] = row
        del x, ws, m, gx
    return out


def _k4_bf16(g, dev):
    """K4f and K4b in bf16 at B=1024, by device time per kernel."""
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = C.HEADS, C.D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    out = {}
    for (Lq, L1, L2) in C.STREAM_SHAPES:
        t, m = C._k4_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
        gx = torch.randn(B, Lq, d, generator=g, device=dev).to(torch.bfloat16)
        row = {}
        for rate in (0.0, C.DROP_RATE):
            def fwd(rate=rate, a=None):
                a = t if a is None else a
                return K4.fused_layer_stream(
                    *a[:3], C._pairs(a[3:15]), a[15:25], *m, num_heads=H,
                    scale=scale, dropout_rate=rate, seed=SEED,
                    deterministic=rate == 0)
            kf = _breakdown(fwd, 10)
            kf_events = C._time_ms(fwd, 10)
            err_f = _rel([fwd()], [K4.layer_stream_plain(
                *t[:3], t[3:15], t[15:25], *m, H, scale, rate, SEED)])
            leaves = [x.detach().requires_grad_() for x in t]
            o = fwd(rate, leaves)

            def bwd(o=o, leaves=leaves):
                return torch.autograd.grad(o, leaves, gx, retain_graph=True)
            kb = _breakdown(bwd, 5)
            kb_events = C._time_ms(bwd, 5)
            first, second = bwd(), bwd()
            same = all(torch.equal(a, b) for a, b in zip(first[3:],
                                                         second[3:]))
            del second
            err_b = _rel(first, K4.layer_stream_bwd_plain(
                *t[:3], t[3:15], t[15:25], *m, gx, H, scale, rate, SEED))
            del first, o, leaves

            def ours(rows):
                return sum(v for k, v in rows.items()
                           if any(n in k for n in C.K4_NAMES))
            tag = f"rate {rate}"
            row[tag] = dict(
                k4f_ms=ours(kf), k4f_events_ms=kf_events, k4f_kernels=kf,
                k4f_err=err_f, k4b_ms=ours(kb), k4b_events_ms=kb_events,
                k4b_kernels=kb, k4b_err=err_b, k4b_dw_db_bit_equal=same)
            print(f"  K4 {(Lq, L1, L2)} {tag}: K4f {C._ms(ours(kf))} ms "
                  f"(events {kf_events:.3f}; err {err_f:.2g}), K4b "
                  f"{C._ms(ours(kb))} ms (events {kb_events:.3f}; err "
                  f"{err_b:.2g}, dW/db bit-equal {same}); K4f {kf}; K4b "
                  f"{kb}", flush=True)
        out[f"{Lq}x{L1}x{L2}"] = row
        del t, m, gx
        torch.cuda.empty_cache()
    return out


def _grad_calls(fwd, leaves, gs):
    """The output of fwd(leaves) and a function that runs its backward
    once more."""
    out = fwd(leaves)

    def bwd():
        return torch.autograd.grad(out, leaves, gs, retain_graph=True)
    return out, bwd


def _k6_bf16(A, g, dev):
    """K6f and K6b (version=2) in bf16 at B=1024, by device time per
    kernel."""
    H, d = C.HEADS, C.D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    out = {}
    for (Lq, L1, L2) in C.STREAM_SHAPES:
        x, ws, m = C._k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
        gx = torch.randn(B, Lq, d, generator=g, device=dev).to(torch.bfloat16)
        row = dict(bound_k6b_ms=1e3 * max(
            C.k2b_cost(B, Lq, L1, L2)[0] / C.HBM_BYTES_PER_S,
            C.k2b_cost(B, Lq, L1, L2)[1]))
        for rate in (0.0, C.DROP_RATE):
            def fwd(t, rate=rate):
                return A.fused_proj_two_block_attention(
                    *t, *m, num_heads=H, scale=scale, dropout_rate=rate,
                    seed=SEED, deterministic=rate == 0, version=2)
            t = tuple(x) + tuple(ws)
            kf = _breakdown(lambda: fwd(t), 10)
            leaves = [a.detach().requires_grad_() for a in t]
            o, bwd = _grad_calls(fwd, leaves, gx)
            kb = _breakdown(bwd, 5)
            kb_events = C._time_ms(bwd, 5)
            first, second = bwd(), bwd()
            same = all(torch.equal(a, b) for a, b in zip(first[3:],
                                                         second[3:]))
            err_b = _rel(first, A.proj_two_block_attention_v2_bwd_plain(
                *x, *ws, *m, gx, H, scale, rate, SEED))
            del first, second, o, leaves

            def ours(rows):
                return sum(v for k, v in rows.items()
                           if any(n in k for n in C.K6_NAMES))
            tag = f"rate {rate}"
            row[tag] = dict(k6f_ms=ours(kf), k6f_kernels=kf,
                            k6b_ms=ours(kb), k6b_events_ms=kb_events,
                            k6b_kernels=kb, k6b_err=err_b,
                            k6b_dw_db_bit_equal=same)
            print(f"  K6 {(Lq, L1, L2)} {tag}: K6f {C._ms(ours(kf))} ms, "
                  f"K6b {C._ms(ours(kb))} ms (events {kb_events:.3f}; err "
                  f"{err_b:.2g}, dW/db bit-equal {same}; bound "
                  f"{row['bound_k6b_ms']:.3f}); K6b {kb}", flush=True)
        out[f"{Lq}x{L1}x{L2}"] = row
        del x, ws, m, gx
        torch.cuda.empty_cache()
    return out


def _k5_bf16(g, dev):
    """K5f and K5b in bf16 at B=1024 on backbone 1's stream pair, by device
    time per kernel."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    H, d = C.HEADS, C.D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    Lv, Lu = C.DUAL_SHAPE
    xs = [torch.randn(B, L, d, generator=g, device=dev).to(torch.bfloat16)
          for L in (Lv, Lu)]
    ws = C._proj_weights(g, d, 12, torch.bfloat16, dev)
    mv, mu = C._masks(g, B, Lv, dev, False), C._masks(g, B, Lu, dev)
    gs = [torch.randn(B, L, d, generator=g, device=dev).to(torch.bfloat16)
          for L in (Lv, Lu)]
    out = dict(bound_k5b_ms=1e3 * max(
        C.k5b_cost(B, Lv, Lu)[0] / C.HBM_BYTES_PER_S,
        C.k5b_cost(B, Lv, Lu)[1]))
    for rate in (0.0, C.DROP_RATE):
        def fwd(t, rate=rate):
            return K5.fused_dual_stream_attention(
                t[0], t[1], C._pairs(t[2:14]), C._pairs(t[14:]), mv, mu,
                num_heads=H, scale=scale, dropout_rate=rate, seed=SEED,
                deterministic=rate == 0)
        t = xs + ws
        kf = _breakdown(lambda: fwd(t), 10)
        leaves = [a.detach().requires_grad_() for a in t]
        o, bwd = _grad_calls(fwd, leaves, gs)
        kb = _breakdown(bwd, 5)
        kb_events = C._time_ms(bwd, 5)
        first, second = bwd(), bwd()
        same = all(torch.equal(a, b) for a, b in zip(first[2:], second[2:]))
        err_b = _rel(first, K5.dual_stream_attention_bwd_plain(
            *xs, ws[:12], ws[12:], mv, mu, *gs, H, scale, rate, SEED))
        del first, second, o, leaves

        def ours(rows):
            return sum(v for k, v in rows.items()
                       if any(n in k for n in C.K5_NAMES))
        tag = f"rate {rate}"
        out[tag] = dict(k5f_ms=ours(kf), k5f_kernels=kf, k5b_ms=ours(kb),
                        k5b_events_ms=kb_events, k5b_kernels=kb,
                        k5b_err=err_b, k5b_dw_db_bit_equal=same)
        print(f"  K5 {C.DUAL_SHAPE} {tag}: K5f {C._ms(ours(kf))} ms, K5b "
              f"{C._ms(ours(kb))} ms (events {kb_events:.3f}; err "
              f"{err_b:.2g}, dW/db bit-equal {same}; bound "
              f"{out['bound_k5b_ms']:.3f}); K5b {kb}", flush=True)
    return out


def _untimed(A, g, dev):
    """bf16 K1f and K1b, fp32 K2f and K2b, fp32 K4f and K4b at B=1024 at
    the four stream shapes, dropout off, by device time, beside their
    bounds: bytes read and written once over the memory rate, operations
    over the rate of the bodies' type (bf16 989 TFLOP/s; fp32 products at
    the 3xTF32 rate, 495 / 3, the fastest fp32-accurate products the port
    runs)."""
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = C.HEADS, C.D_MODEL
    Dh = d // H
    scale = 1.0 / math.sqrt(Dh)
    f32, bf = torch.float32, torch.bfloat16
    out = {}

    def bound(nbytes, ops, rate):
        return 1e3 * max(nbytes / C.HBM_BYTES_PER_S, ops / rate)

    for (Lq, L1, L2) in C.STREAM_SHAPES:
        row, Lk = {}, L1 + L2
        masks = 4 * B * (Lq + L1 + L2)
        # bf16 K1: q1 q2 k1 k2 v1 v2 (and g) read, out (dq..dv) written
        qkv, m = C._k1_inputs(g, B, Lq, L1, L2, bf, dev)
        gq = torch.randn(B, Lq, H, Dh, generator=g, device=dev).to(bf)
        e, elems = 2, B * H * Dh
        row["k1f_bf16_ms"] = C._device_ms(lambda: A.fused_two_block_attention(
            *qkv, *m, scale=scale), 10, C.K1_NAMES)
        leaves = [t.detach().requires_grad_() for t in qkv]
        o = A.fused_two_block_attention(*leaves, *m, scale=scale)
        row["k1b_bf16_ms"] = C._device_ms(lambda: torch.autograd.grad(
            o, leaves, gq, retain_graph=True), 5, C.K1_NAMES)
        row["k1f_bf16_plain_ms"] = C._time_ms(
            lambda: A.two_block_attention_plain(*qkv, *m, scale), 3)
        row["k1b_bf16_plain_ms"] = C._time_ms(
            lambda: A.two_block_attention_bwd_plain(*qkv, *m, gq, scale), 2)
        lib = C._k1_device_times(A, g, dev, B, Lq, L1, L2, scale, dt=bf)
        row["k1f_bf16_sdpa_ms"] = lib["sdpa"]
        row["k1b_bf16_sdpa_ms"] = lib["sdpa_bwd"]
        row["k1f_bf16_bound_ms"] = bound(
            e * elems * (3 * Lq + 2 * Lk) + masks, 4.0 * elems * Lq * Lk,
            C.PEAK_FLOPS[bf])
        row["k1b_bf16_bound_ms"] = bound(
            e * elems * (5 * Lq + 4 * Lk) + masks, 10.0 * elems * Lq * Lk,
            C.PEAK_FLOPS[bf])
        del qkv, leaves, o, gq
        # fp32 K2: x, W (and g) read; out (dx, dW, db) written; the
        # projections, q k^T, p v forward; the recompute, the core's four
        # products and the chain's two backward
        x, ws, m = C._k2_inputs(g, B, Lq, L1, L2, f32, dev)
        gx = torch.randn(B, Lq, d, generator=g, device=dev)
        proj, qk = C._proj_flops(B, d, Lq, L1, L2), 2.0 * B * Lq * Lk * d
        params = 4 * 6 * (d * d + d)
        row["k2f_fp32_ms"] = C._device_ms(
            lambda: A.fused_proj_two_block_attention(
                *x, *ws, *m, num_heads=H, scale=scale), 5, C.K2_NAMES)
        leaves = [t.detach().requires_grad_() for t in tuple(x) + tuple(ws)]
        o = A.fused_proj_two_block_attention(*leaves, *m, num_heads=H,
                                             scale=scale)
        row["k2b_fp32_ms"] = C._device_ms(lambda: torch.autograd.grad(
            o, leaves, gx, retain_graph=True), 3, C.K2_NAMES)
        row["k2f_fp32_bound_ms"] = bound(
            4 * B * d * (2 * Lq + L1 + L2) + params + masks, proj + 2 * qk,
            C.TF32X3_FLOPS)
        row["k2b_fp32_bound_ms"] = bound(
            4 * B * d * (3 * Lq + 2 * L1 + 2 * L2) + 2 * params + masks,
            proj + 5 * qk + 2 * proj, C.TF32X3_FLOPS)
        del x, ws, leaves, o, gx
        # fp32 K4: K2's work plus the epilogue's three Denses (ff = d)
        # forward; backward the attention recomputed (projections, q k^T,
        # p v), the core's four products, the chain's two, the Denses'
        # recompute, dgrad and dW
        t, m = C._k4_inputs(g, B, Lq, L1, L2, f32, dev)
        gx = torch.randn(B, Lq, d, generator=g, device=dev)

        def k4(a):
            return K4.fused_layer_stream(*a[:3], C._pairs(a[3:15]), a[15:25],
                                         *m, num_heads=H, scale=scale)
        epi = 3 * 2.0 * B * Lq * d * d
        ep_params = 4 * (3 * (d * d + d) + 4 * d)
        row["k4f_fp32_ms"] = C._device_ms(lambda: k4(t), 5, C.K4_NAMES)
        leaves = [a.detach().requires_grad_() for a in t]
        o = k4(leaves)
        row["k4b_fp32_ms"] = C._device_ms(lambda: torch.autograd.grad(
            o, leaves, gx, retain_graph=True), 3, C.K4_NAMES)
        row["k4f_fp32_bound_ms"] = bound(
            4 * B * d * (2 * Lq + L1 + L2) + params + ep_params + masks,
            proj + 2 * qk + epi, C.TF32X3_FLOPS)
        row["k4b_fp32_bound_ms"] = bound(
            4 * B * d * (3 * Lq + 2 * L1 + 2 * L2) + 2 * (params + ep_params)
            + masks, proj + 6 * qk + 2 * proj + 3 * epi, C.TF32X3_FLOPS)
        del t, leaves, o, gx
        torch.cuda.empty_cache()
        out[f"{Lq}x{L1}x{L2}"] = row
        print(f"  untimed {(Lq, L1, L2)}: " + ", ".join(
            f"{k} {C._ms(v)}" for k, v in row.items()), flush=True)
    return out


E2E_STEPS = 6  # timed after 2 warm-up steps


def _e2e(A):
    """The main path end to end at B=1024 over the 3.9M-row int8 table:
    production training (bf16, K2), fuse_dual, SEGMM_ATTN_V2 (K6) and
    fuse_layer (K4): ms per step on the host's clock, device ms per step
    and K2's (K4's) share of it (torch.profiler, 2 steps), peak device
    memory; then the serving preset: device latency per batch at B = 1024 /
    512 / 256 / 128 (CUDA events, batch on the card), device ms per B=1024
    batch and K2f's share, and interactions/s over the test split with the
    host pipeline; fuse_layer served: device latency per B=1024 batch."""
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import export_logits as X

    ctx = C._data({})
    reader, store = ctx["reader"], ctx["store"]
    out, batches = {}, None
    for name, kw, v2 in (("production", {}, False),
                         ("fuse_dual", dict(fuse_dual=True), False),
                         ("attn_v2", {}, True),
                         ("fuse_layer", dict(fuse_layer=True), False)):
        A.ATTN_V2 = v2
        try:
            cfg = C._production_train_cfg(ctx["csv"], **kw)
            engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                    feature_table=ctx["table"],
                                    device="cuda")
            if batches is None:
                batches = [b for _, b in zip(range(E2E_STEPS + 2),
                                             BatchIterator(
                    reader, reader.tables["train"], 1024, shuffle=True,
                    feature_store=store, seed=cfg.seed,
                    transform=engine.batch_transform))]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, times, losses, counts = C._train_steps(engine, batches)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            share = C._kernel_share(
                engine, batches[:2],
                C.K4_NAMES if name == "fuse_layer" else None)
        finally:
            A.ATTN_V2 = False
        steady = times[2:]
        rows = sum(int(b["row_mask"].sum()) for b in batches[2:])
        out[name] = dict(
            ms_per_step=1e3 * sum(steady) / len(steady),
            interactions_per_s=rows / sum(steady),
            device_ms_per_step=None if share is None else share[1],
            k2_share=None if share is None else share[0], peak_gib=peak,
            losses=losses, launches_per_step={
                k: v // len(batches) for k, v in counts.items() if v})
        print(f"  {name} train: {out[name]['ms_per_step']:.1f} ms per step, "
              f"device {C._ms(out[name]['device_ms_per_step'])} ms, peak "
              f"{peak:.2f} GiB, launches {out[name]['launches_per_step']}",
              flush=True)
        del engine
        torch.cuda.empty_cache()

    cfg = X.apply_serving_preset(C._flagship_cfg(ctx["csv"]))
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    state = engine.init_state()
    latency, full = {}, None
    for bs in (1024, 512, 256, 128):
        batch = next(iter(BatchIterator(
            reader, reader.tables["train"], bs, feature_store=store,
            seed=cfg.seed, prefetch_size=0)))
        dev_batch = {"_dev": engine.put_batch(batch)}
        full = full or dev_batch
        latency[bs] = C._time_ms(lambda: engine.eval_step(state, dev_batch),
                                 5)
    share = C._device_share(lambda: engine.eval_step(state, full), 3,
                            C.K2_NAMES)
    it = BatchIterator(reader, reader.tables["test"], cfg.test_batch_size,
                       shuffle=False, feature_store=store, seed=cfg.seed,
                       transform=engine.batch_transform)
    X.export_split_logits(engine, state, it)  # warm: the iterator's tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = X.export_split_logits(engine, state, it)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["serving"] = dict(
        latency_ms=latency,
        device_ms_b1024=None if share is None else share[1],
        k2f_share=None if share is None else share[0],
        interactions_per_s=len(logits) / wall)
    print(f"  served: latency {latency} ms, device "
          f"{C._ms(out['serving']['device_ms_b1024'])} ms at B=1024, "
          f"{len(logits) / wall:.1f} interactions/s", flush=True)
    del engine, state
    cfg = X.apply_serving_preset(C._flagship_cfg(ctx["csv"])).replace(
        fuse_layer=True)
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=ctx["table"], device="cuda")
    state = engine.init_state()
    share = C._device_share(lambda: engine.eval_step(state, full), 3,
                            C.K4_NAMES)
    out["fuse_layer_served"] = dict(
        latency_ms_b1024=C._time_ms(lambda: engine.eval_step(state, full),
                                    5),
        device_ms_b1024=None if share is None else share[1],
        k4f_share=None if share is None else share[0])
    print(f"  fuse_layer served: {out['fuse_layer_served']}", flush=True)
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
                      A.two_block_attention_plain, C.K1F_NAMES,
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
                      A.two_block_attention_bwd_plain, C.K1B_NAMES))
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
             C.K1F_NAMES)):
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


def _wide_bounds(kernel, dt, shape, d):
    """(fwd, bwd) bound ms of one kernel at one shape, B=1024, width d:
    bytes read and written once over the memory rate, operations over the
    rate of the bodies' type (bf16 989 TFLOP/s; fp32 at the 3xTF32 rate, as
    _untimed prices fp32). K1, K3, bf16 K2f, K4 and K5f as chip_smoke.py's
    entries price them, bf16 K2b, K6b and K5b by its k2b_cost / k5b_cost,
    fp32 K2, K6 and K4 as _untimed does; fp32 K5 as fp32 K2 on both
    streams. Bytes and operations depend on d, not on how it is cut into
    heads."""
    e, f32 = C._elem(dt), dt == torch.float32
    rate = C.TF32X3_FLOPS if f32 else C.PEAK_FLOPS[dt]

    def ms(nbytes, ops):
        return 1e3 * max(nbytes / C.HBM_BYTES_PER_S, ops / rate)

    def ms_cost(cost):  # (bytes, seconds at the bf16 rate)
        return 1e3 * max(cost[0] / C.HBM_BYTES_PER_S, cost[1])

    if kernel == "K3":
        Lq, Lk = shape
        masks, core = 4 * B * (Lq + Lk), 2.0 * B * Lq * Lk * d
        return (ms(e * B * d * (2 * Lq + 2 * Lk) + masks, 2 * core),
                ms(e * B * d * (3 * Lq + 4 * Lk) + masks, 5 * core))
    if kernel == "K5":
        Lv, Lu = shape
        streams = ((Lv, Lv, Lu), (Lu, Lv, Lu))
        rows, masks = B * d * (Lv + Lu), 4 * B * (Lv + Lu)
        params = 12 * (d * d + d)
        proj = sum(C._proj_flops(B, d, *s) for s in streams)
        qk = sum(2.0 * B * s[0] * (s[1] + s[2]) * d for s in streams)
        fwd = ms(e * (2 * rows + params) + masks, proj + 2 * qk)
        if not f32:
            return fwd, ms_cost(C.k5b_cost(B, Lv, Lu, d))
        return fwd, ms(4 * (3 * rows + params) + 4 * params + masks,
                       3 * proj + 5 * qk)
    Lq, L1, L2 = shape
    Lk, masks = L1 + L2, 4 * B * (Lq + L1 + L2)
    qk = 2.0 * B * Lq * Lk * d
    if kernel == "K1":
        return (ms(e * B * d * (3 * Lq + 2 * Lk) + masks, 2 * qk),
                ms(e * B * d * (5 * Lq + 4 * Lk) + masks, 5 * qk))
    proj = C._proj_flops(B, d, Lq, L1, L2)
    if kernel in ("K2", "K6"):
        if not f32:
            return (ms(e * (B * d * (2 * Lq + L1 + L2) + 6 * (d * d + d))
                       + masks, proj + 2 * qk),
                    ms_cost(C.k2b_cost(B, Lq, L1, L2, d)))
        params = 4 * 6 * (d * d + d)
        return (ms(4 * B * d * (2 * Lq + L1 + L2) + params + masks,
                   proj + 2 * qk),
                ms(4 * B * d * (3 * Lq + 2 * L1 + 2 * L2) + 2 * params
                   + masks, 3 * proj + 5 * qk))
    assert kernel == "K4", kernel
    epi = 3 * 2.0 * B * Lq * d * d  # the three Denses, ff = d
    if f32:
        params = 4 * 6 * (d * d + d)
        ep_params = 4 * (3 * (d * d + d) + 4 * d)
        return (ms(4 * B * d * (2 * Lq + L1 + L2) + params + ep_params
                   + masks, proj + 2 * qk + epi),
                ms(4 * B * d * (3 * Lq + 2 * L1 + 2 * L2)
                   + 2 * (params + ep_params) + masks,
                   3 * proj + 6 * qk + 3 * epi))
    params = 6 * (d * d + d) + 3 * d * d + 3 * d
    rows_in, ln = B * d * (Lq + L1 + L2), 4 * 4 * d
    return (ms(e * (rows_in + B * Lq * d + params) + ln + masks,
               proj + 2 * qk + epi),
            ms(e * (2 * rows_in + B * Lq * d + params) + 4 * (params + 4 * d)
               + ln + masks, 7 * proj + 12 * qk + 7 * epi))


def _long(A, g, dev):
    """Every kernel at a long stream, on its core's key-chunk path, B=1024,
    16 heads of 32, fp32 and bf16, dropout off: device ms of the forward
    and of the backward (every kernel of each call), beside the bounds of
    _wide_bounds at d 512."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = C.HEADS, C.D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    shape = C.LONG_SHAPES[0]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        row = {}

        def timed(name, kernel, shp, fwd, inputs, gout):
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in inputs]
            o = fwd(*leaves)
            diff = [t for t in leaves if t.requires_grad]
            f_ms = C._device_ms(lambda: fwd(*inputs), 3)
            b_ms = C._device_ms(lambda: torch.autograd.grad(
                o, diff, gout, retain_graph=True), 2)
            bf, bb = _wide_bounds(kernel, dt, shp, d)
            row[name] = dict(shape=shp, fwd_ms=f_ms, bwd_ms=b_ms,
                             fwd_bound_ms=bf, bwd_bound_ms=bb)
            print(f"long {str(dt)[6:]} {name} {shp}: fwd {f_ms} ms (bound "
                  f"{bf:.3f}), bwd {b_ms} ms (bound {bb:.3f})", flush=True)
            torch.cuda.empty_cache()

        qkv, m = C._k1_inputs(g, B, *shape, dt, dev)
        gq = torch.randn(B, shape[0], H, d // H, generator=g,
                         device=dev).to(dt)
        timed("K1", "K1", shape, lambda *t: A.fused_two_block_attention(
            *t, *m, scale=scale), qkv, gq)
        del qkv
        for name, shp in (("K2", shape), ("K6", C.LONG_K6_SHAPE)):
            x, ws, mx = C._k2_inputs(g, B, *shp, dt, dev)
            timed(name, name, shp, lambda *t: A.fused_proj_two_block_attention(
                *t[:3], *t[3:], *mx, num_heads=H, scale=scale,
                version=2 if name == "K6" else 1), tuple(x) + tuple(ws),
                gq.reshape(B, shp[0], d))
        t4, m4 = C._k4_inputs(g, B, *shape, dt, dev)
        timed("K4", "K4", shape, lambda *t: K4.fused_layer_stream(
            *t[:3], C._pairs(t[3:15]), t[15:], *m4, num_heads=H,
            scale=scale), t4, gq.reshape(B, shape[0], d))
        del t4
        Lq, Lk = shape[0], shape[2]
        q3 = [torch.randn(B, L, H, d // H, generator=g, device=dev).to(dt)
              for L in (Lq, Lk, Lk)]
        m3 = (C._masks(g, B, Lq, dev), C._masks(g, B, Lk, dev, False))
        timed("K3", "K3", (Lq, Lk), lambda *t: A.fused_masked_attention(
            *t, *m3, scale=scale), q3, gq)
        del q3
        Lv, Lu = shape[1:]
        t5 = [torch.randn(B, L, d, generator=g, device=dev).to(dt)
              for L in (Lv, Lu)] + C._proj_weights(g, d, 12, dt, dev)
        m5 = (C._masks(g, B, Lv, dev, False), C._masks(g, B, Lu, dev))
        g5 = tuple(torch.randn(B, L, d, generator=g, device=dev).to(dt)
                   for L in (Lv, Lu))
        timed("K5", "K5", (Lv, Lu), lambda *t: K5.fused_dual_stream_attention(
            t[0], t[1], C._pairs(t[2:14]), C._pairs(t[14:26]), *m5,
            num_heads=H, scale=scale), t5, g5)
        del t5, g5, gq
        out[str(dt)[6:]] = row
    return out


def _wide(A, g, dev):
    """Every kernel at 4 heads of 128 (d 512) at B=1024 by device time."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = 4, C.D_MODEL
    dh, scale = d // H, 1.0 / math.sqrt(d // H)
    out = {}

    def timed(key, fwd, leaves, gs, names, want_f, want_b, bounds=None):
        try:
            o = fwd(*leaves)
            ms_f = C._device_ms(lambda: fwd(*[x.detach() for x in leaves]),
                                5, names)
            ms_b = C._device_ms(lambda: torch.autograd.grad(
                o, leaves, gs, retain_graph=True), 3, names)
            got = torch.autograd.grad(o, leaves, gs, retain_graph=True)
            os_ = o if isinstance(o, tuple) else (o,)
            wf = want_f() if callable(want_f) else want_f
            wf = wf if isinstance(wf, tuple) else (wf,)
            row = dict(fwd_ms=ms_f, bwd_ms=ms_b, err_f=_rel(os_, wf),
                       err_b=_rel(got, want_b()))
            if bounds:
                row.update(bound_fwd_ms=bounds[0], bound_bwd_ms=bounds[1])
        except (ValueError, RuntimeError) as e:  # a tree that refuses 128
            row = dict(error=str(e)[:200])
        out[key] = row
        print(f"  wide {key}: {row}", flush=True)

    for dt in (torch.float32, torch.bfloat16):
        tdt = str(dt)[6:]
        for shape in C.STREAM_SHAPES:
            qkv, m = C._k1_inputs(g, B, *shape, dt, dev, H)
            gq = torch.randn(B, shape[0], H, dh, generator=g, device=dev
                             ).to(dt)
            leaves = [x.detach().requires_grad_() for x in qkv]
            timed(f"K1 {tdt} {shape}", lambda *t: A.fused_two_block_attention(
                *t, *m, scale=scale), leaves, gq, C.K1_NAMES,
                lambda: A.two_block_attention_plain(*qkv, *m, scale),
                lambda: A.two_block_attention_bwd_plain(*qkv, *m, gq, scale),
                _wide_bounds("K1", dt, shape, d))
            del qkv, leaves, gq
            x, ws, m = C._k2_inputs(g, B, *shape, dt, dev)
            gx = torch.randn(B, shape[0], d, generator=g, device=dev).to(dt)
            leaves = [t.detach().requires_grad_()
                      for t in tuple(x) + tuple(ws)]
            for v, names, plain, plain_b in (
                    (1, C.K2_NAMES, A.proj_two_block_attention_plain,
                     A.proj_two_block_attention_bwd_plain),
                    (2, C.K6_NAMES, A.proj_two_block_attention_v2_plain,
                     A.proj_two_block_attention_v2_bwd_plain)):
                timed(f"K{2 if v == 1 else 6} {tdt} {shape}",
                      lambda *t, v=v: A.fused_proj_two_block_attention(
                          *t, *m, num_heads=H, scale=scale, version=v),
                      leaves, gx, names,
                      lambda plain=plain: plain(*x, *ws, *m, H, scale),
                      lambda plain_b=plain_b: plain_b(*x, *ws, *m, gx, H,
                                                      scale),
                      _wide_bounds("K2", dt, shape, d))
            del x, ws, leaves, gx
            torch.cuda.empty_cache()
        for Lq, Lk in K3_SHAPES:
            q, k, v, gq = (torch.randn(B, L, H, dh, generator=g, device=dev
                                       ).to(dt) for L in (Lq, Lk, Lk, Lq))
            m = (C._masks(g, B, Lq, dev), C._masks(g, B, Lk, dev, False))
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            timed(f"K3 {tdt} {(Lq, Lk)}", lambda *t: A.fused_masked_attention(
                *t, *m, scale=scale), leaves, gq, C.K3_NAMES,
                lambda: A.masked_attention_plain(q, k, v, *m, scale),
                lambda: A.masked_attention_bwd_plain(q, k, v, *m, gq, scale),
                _wide_bounds("K3", dt, (Lq, Lk), d))
            del q, k, v, gq, leaves
        Lv, Lu = C.DUAL_SHAPE
        t = [torch.randn(B, L, d, generator=g, device=dev).to(dt)
             for L in (Lv, Lu)] + C._proj_weights(g, d, 12, dt, dev)
        m = (C._masks(g, B, Lv, dev, False), C._masks(g, B, Lu, dev))
        gs = tuple(torch.randn(B, L, d, generator=g, device=dev).to(dt)
                   for L in (Lv, Lu))
        leaves = [x.detach().requires_grad_() for x in t]
        timed(f"K5 {tdt} {C.DUAL_SHAPE}",
              lambda *x: K5.fused_dual_stream_attention(
                  x[0], x[1], C._pairs(x[2:14]), C._pairs(x[14:26]), *m,
                  num_heads=H, scale=scale), leaves, gs, C.K5_NAMES,
              lambda: K5.dual_stream_attention_plain(
                  t[0], t[1], t[2:14], t[14:26], *m, H, scale),
              lambda: K5.dual_stream_attention_bwd_plain(
                  t[0], t[1], t[2:14], t[14:26], *m, *gs, H, scale),
              _wide_bounds("K5", dt, C.DUAL_SHAPE, d))
        del t, gs, leaves
        for shape in C.STREAM_SHAPES[:2]:
            t, m = C._k4_inputs(g, B, *shape, dt, dev)
            gx = torch.randn(B, shape[0], d, generator=g, device=dev).to(dt)
            leaves = [x.detach().requires_grad_() for x in t]
            timed(f"K4 {tdt} {shape}", lambda *x: K4.fused_layer_stream(
                *x[:3], C._pairs(x[3:15]), x[15:], *m, num_heads=H,
                scale=scale), leaves, gx, C.K4_NAMES,
                lambda: K4.layer_stream_plain(*t[:3], t[3:15], t[15:], *m, H,
                                              scale),
                lambda: K4.layer_stream_bwd_plain(*t[:3], t[3:15], t[15:],
                                                  *m, gx, H, scale),
                _wide_bounds("K4", dt, shape, d))
            del t, gx, leaves
            torch.cuda.empty_cache()
    return out


def _fp32_routes(A, g, dev):
    """fp32 K2, K6, K4 and K5 at 16 heads of 32 (d 512), B=1024, dropout
    off, through their wrappers, on the bodies the checkout picks: device
    ms per call (every kernel of the call), the error against the plain
    version, the plain version's device ms forward and backward on the same
    inputs, and each kernel's bound (_wide_bounds). Run on two checkouts in
    turns to compare their fp32 bodies."""
    from segmminterest_tpu_torch.core import dual_kernel as K5
    from segmminterest_tpu_torch.core import layer_kernel as K4
    H, d = C.HEADS, C.D_MODEL
    scale = 1.0 / math.sqrt(d // H)
    f32 = torch.float32
    out = {}

    def run(key, fwd, leaves, gs, want_f, want_b, bounds):
        row = dict(bound_fwd_ms=bounds[0], bound_bwd_ms=bounds[1])
        try:
            o = fwd(*leaves)
            row["fwd_ms"] = C._device_ms(
                lambda: fwd(*[x.detach() for x in leaves]), 5)
            row["bwd_ms"] = C._device_ms(lambda: torch.autograd.grad(
                o, leaves, gs, retain_graph=True), 3)
            got = torch.autograd.grad(o, leaves, gs)
            os_ = o if isinstance(o, tuple) else (o,)
            row.update(err_f=_rel(os_, want_f()), err_b=_rel(got, want_b()))
            del o, got
            row["plain_fwd_ms"] = C._device_ms(want_f, 3)
            row["plain_bwd_ms"] = C._device_ms(want_b, 2)
        except (ValueError, RuntimeError) as e:
            row["error"] = str(e)[:200]
        out[key] = row
        print(f"  fp32_routes {key}: {row}", flush=True)

    for shape in C.STREAM_SHAPES:
        x, ws, m = C._k2_inputs(g, B, *shape, f32, dev)
        gx = torch.randn(B, shape[0], d, generator=g, device=dev)
        leaves = [t.detach().requires_grad_() for t in tuple(x) + tuple(ws)]
        for v, plain, plain_b in (
                (1, A.proj_two_block_attention_plain,
                 A.proj_two_block_attention_bwd_plain),
                (2, A.proj_two_block_attention_v2_plain,
                 A.proj_two_block_attention_v2_bwd_plain)):
            run(f"K{2 if v == 1 else 6} {shape}",
                lambda *t, v=v: A.fused_proj_two_block_attention(
                    *t, *m, num_heads=H, scale=scale, version=v),
                leaves, gx, lambda plain=plain: (plain(*x, *ws, *m, H,
                                                       scale),),
                lambda plain_b=plain_b: plain_b(*x, *ws, *m, gx, H, scale),
                _wide_bounds("K2", f32, shape, d))
        del x, ws, leaves, gx
        t, m = C._k4_inputs(g, B, *shape, f32, dev)
        gx = torch.randn(B, shape[0], d, generator=g, device=dev)
        leaves = [a.detach().requires_grad_() for a in t]
        run(f"K4 {shape}", lambda *a: K4.fused_layer_stream(
            *a[:3], C._pairs(a[3:15]), a[15:], *m, num_heads=H,
            scale=scale), leaves, gx,
            lambda: (K4.layer_stream_plain(*t[:3], t[3:15], t[15:], *m, H,
                                           scale),),
            lambda: K4.layer_stream_bwd_plain(*t[:3], t[3:15], t[15:], *m,
                                              gx, H, scale),
            _wide_bounds("K4", f32, shape, d))
        del t, gx, leaves
        torch.cuda.empty_cache()
    Lv, Lu = C.DUAL_SHAPE
    t = [torch.randn(B, L, d, generator=g, device=dev) for L in (Lv, Lu)] \
        + C._proj_weights(g, d, 12, f32, dev)
    m = (C._masks(g, B, Lv, dev, False), C._masks(g, B, Lu, dev))
    gs = tuple(torch.randn(B, L, d, generator=g, device=dev)
               for L in (Lv, Lu))
    leaves = [x.detach().requires_grad_() for x in t]
    run(f"K5 {C.DUAL_SHAPE}", lambda *x: K5.fused_dual_stream_attention(
        x[0], x[1], C._pairs(x[2:14]), C._pairs(x[14:26]), *m, num_heads=H,
        scale=scale), leaves, gs,
        lambda: K5.dual_stream_attention_plain(t[0], t[1], t[2:14],
                                               t[14:26], *m, H, scale),
        lambda: K5.dual_stream_attention_bwd_plain(
            t[0], t[1], t[2:14], t[14:26], *m, *gs, H, scale),
        _wide_bounds("K5", f32, C.DUAL_SHAPE, d))
    return out


FP32_TRAIN_STEPS = 6  # timed after 2 warm-up steps


def _fp32_train():
    """The two fp32 training configurations on the 3xTF32 bodies at
    B=1024 over the 3.9M-row int8 table: the default (K1, layer remat) and
    CrossAtt (K3, layer remat), dropout 0.1: ms per step on the host's
    clock, device ms per step and K1's (K3's) share of it (torch.profiler,
    2 steps)."""
    return _train_configs(lambda base: (
        ("default", base, C.K1_NAMES),
        ("crossatt", base.replace(ablation_type="CrossAtt"), C.K3_NAMES)))


def _bf16_default():
    """The default configuration in bf16 (`--compute_dtype bfloat16`:
    K1 in bf16, layer remat) at B=1024, as _fp32_train measures it."""
    return _train_configs(lambda base: (
        ("bf16_default", base.replace(compute_dtype="bfloat16"),
         C.K1_NAMES),))


def _train_configs(configs):
    """Each (name, config, kernel names) of configs(base) trained at
    B=1024 over the 3.9M-row int8 table: ms per step on the host's clock
    (after 2 steps), device ms per step and the named kernels' share of it
    (torch.profiler, 2 steps), the losses and the launches per step."""
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.engine.train import InterestEngine

    ctx = C._data({})
    reader, store = ctx["reader"], ctx["store"]
    base = C._flagship_cfg(ctx["csv"]).replace(train_batch_size=1024,
                                               table_quant="int8")
    out, batches = {}, None
    for name, cfg, names in configs(base):
        engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                                feature_table=ctx["table"], device="cuda")
        if batches is None:
            batches = [b for _, b in zip(range(FP32_TRAIN_STEPS + 2),
                                         BatchIterator(
                reader, reader.tables["train"], 1024, shuffle=True,
                feature_store=store, seed=cfg.seed,
                transform=engine.batch_transform))]
        _, times, losses, counts = C._train_steps(engine, batches)
        share = C._kernel_share(engine, batches[:2], names)
        steady = times[2:]
        out[name] = dict(
            ms_per_step=1e3 * sum(steady) / len(steady),
            device_ms_per_step=None if share is None else share[1],
            kernel_share=None if share is None else share[0],
            losses=losses, launches_per_step={
                k: v // len(batches) for k, v in counts.items() if v})
        print(f"  {name} train: {out[name]}", flush=True)
        del engine
        torch.cuda.empty_cache()
    return out


def _k3_onehot(A, dev):
    """fp32 and bf16 K3f and K3b on chip_smoke.k3_onehot's near-one-hot
    rows over its ONEHOT_DRAWS draws: every draw's errors and the worst."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        rows = C.k3_onehot(A, dev, dt)
        r = out[str(dt)[6:]] = dict(
            rows=rows, worst_k3f=max(r["K3f"] for r in rows),
            worst_k3b=max(r["K3b"] for r in rows),
            all_k3f_ok=all(r["K3f ok"] for r in rows),
            all_k3f_exact_ok=all(r["K3f exact ok"] for r in rows),
            worst_k3f_exact=max(r["K3f exact"] for r in rows),
            worst_plain_exact=max(r["plain exact"] for r in rows))
        print(f"  K3 near-one-hot {str(dt)[6:]}: worst K3f "
              f"{r['worst_k3f']:.3g} (all within TOL {r['all_k3f_ok']}), "
              f"worst K3b {r['worst_k3b']:.3g}; against fp64 K3f "
              f"{r['worst_k3f_exact']:.3g} (all within TOL "
              f"{r['all_k3f_exact_ok']}), plain "
              f"{r['worst_plain_exact']:.3g}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=C.ROOT,
                   help="checkout whose segmminterest_tpu_torch is measured")
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated subset of " + ",".join(PARTS))
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
    parts = {
        "k2_bf16": lambda: _k2_bf16(A, g, dev, root),
        "k4_bf16": lambda: _k4_bf16(g, dev),
        "k6_bf16": lambda: _k6_bf16(A, g, dev),
        "k5_bf16": lambda: _k5_bf16(g, dev),
        "untimed": lambda: _untimed(A, g, dev),
        "e2e": lambda: _e2e(A),
        "k3_bf16": lambda: _k3_bf16(A, g, dev),
        "fp32_fwd": lambda: _fp32_fwd(A, g, dev),
        "fp32_bwd": lambda: _fp32_bwd(A, g, dev),
        "fp32_bwd_sha256": lambda: C.fp32_bwd_digest(A, dev),
        "served": lambda: _served(dev),
        "k3_onehot": lambda: _k3_onehot(A, dev),
        "wide": lambda: _wide(A, g, dev),
        "fp32_routes": lambda: _fp32_routes(A, g, dev),
        "fp32_train": _fp32_train,
        "long": lambda: _long(A, g, dev),
        "bf16_default": _bf16_default}
    res = dict(root=root)
    for name in args.parts.split(","):
        if name not in parts:
            raise SystemExit(f"unknown part {name!r}; parts: {PARTS}")
        res[name] = parts[name]()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
