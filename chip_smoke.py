#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py
(`--phases build,kernels` runs a subset while developing.)

Phases, each of which fails the run (non-zero exit) on any error:
  build    compile the CUDA kernels of core/csrc with nvcc for sm_90a
  kernels  each kernel against its plain PyTorch version on the card, at the
           main path's stream shapes, fp32 and bf16; times at B=1024
  serving  the flagship both/both model (d=512, 16 heads, 6 layers) served
           with the --serving preset over a 3,920,483-row int8 feature table
           built on the card, through the exporter's functions, plus one run
           of the exporter's CLI over a small memmap; latency per batch size
  default  the default config (K1 route, fp32) on the same checkpoint,
           against an fp32 K2 run and against the CPU's plain versions
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
HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# fp32: the kernels and the plain versions sum the same products in other
# orders (projections over d=512 terms, softmax over <=200 keys): ~1e-6
# relative on O(1) outputs, 1e-4 leaves two orders of headroom.
# bf16: one bf16 ulp is 2^-8 relative (0.0156 at |x| in [2, 4)); a
# projection sum that rounds the other way moves a logit by ~one ulp, so
# the outputs may differ by a few ulps: atol 2e-2 + rtol 2e-2.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}

RESULT = {"kernels": {}}


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
    for name, p in paths.items():
        log(f"  built {os.path.relpath(p, ROOT)}")
    log(f"build: {time.perf_counter() - t0:.1f} s")


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


def phase_kernels():
    from segmminterest_tpu_torch.core import attention as A
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(D_MODEL // HEADS)
    H, Dh, d = HEADS, D_MODEL // HEADS, D_MODEL

    def k1(qkv, m):
        return A.fused_two_block_attention(*qkv, *m, scale=scale)

    def k1_plain(qkv, m):
        return A.two_block_attention_plain(*qkv, *m, scale)

    def k2(x, ws, m):
        return A.fused_proj_two_block_attention(*x, *ws, *m, num_heads=H,
                                                scale=scale)

    def k2_plain(x, ws, m):
        return A.proj_two_block_attention_plain(*x, *ws, *m, H, scale)

    for dt in (torch.float32, torch.bfloat16):
        for (Lq, L1, L2) in STREAM_SHAPES:
            qkv, m = _k1_inputs(g, 64, Lq, L1, L2, dt, dev)
            e1 = _check(f"K1 {dt} {(Lq, L1, L2)}", k1(qkv, m),
                        k1_plain(qkv, m), dt)
            x, ws, m = _k2_inputs(g, 64, Lq, L1, L2, dt, dev)
            e2 = _check(f"K2 {dt} {(Lq, L1, L2)}", k2(x, ws, m),
                        k2_plain(x, ws, m), dt)
            log(f"  B=64 {str(dt):14s} (Lq,L1,L2)={(Lq, L1, L2)}: "
                f"max|err| K1 {e1:.3g}  K2 {e2:.3g}")
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
    bound1 = max(bytes1 / HBM_BYTES_PER_S,
                 flops1 / PEAK_FLOPS[torch.float32]) * 1e3
    RESULT["kernels"]["K1"] = dict(
        name="two_block_attention_fwd (K1)", route="cuda",
        source="segmminterest_tpu_torch/core/csrc/two_block_attention.cu",
        replaces="segmminterest_tpu/core/attention.py:527",
        launches=None, max_abs_err=err1, ms=ms1, plain_ms=plain1,
        bound_ms=bound1,
        bound_by="bytes" if bytes1 / HBM_BYTES_PER_S
        >= flops1 / PEAK_FLOPS[torch.float32] else "operations",
        library_ms=lib1)
    log(f"  K1 fp32 B=1024 {(Lq, L1, L2)}: {ms1:.3f} ms (plain {plain1:.3f}, "
        f"sdpa {lib1:.3f}, bound {bound1:.3f}) max|err| {err1:.3g}")
    del qkv, qc, kc, vc, bias

    x, ws, m = _k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
    err2 = _check("K2 B=1024", k2(x, ws, m), k2_plain(x, ws, m),
                  torch.bfloat16)
    ms2 = _time_ms(lambda: k2(x, ws, m), 10)
    plain2 = _time_ms(lambda: k2_plain(x, ws, m), 5)
    e = _elem(torch.bfloat16)
    bytes2 = (e * (B * d * (2 * Lq + L1 + L2) + 6 * (d * d + d))
              + 4 * B * (Lq + L1 + L2))
    flops2 = 2.0 * B * d * d * (2 * Lq + 2 * L1 + 2 * L2) \
        + 4.0 * B * Lq * Lk * d
    bound2 = max(bytes2 / HBM_BYTES_PER_S,
                 flops2 / PEAK_FLOPS[torch.bfloat16]) * 1e3
    RESULT["kernels"]["K2"] = dict(
        name="proj_two_block_attention_fwd (K2)", route="cuda",
        source="segmminterest_tpu_torch/core/csrc/proj_two_block_attention.cu",
        replaces="segmminterest_tpu/core/attention.py:776",
        launches=None, max_abs_err=err2, ms=ms2, plain_ms=plain2,
        bound_ms=bound2,
        bound_by="bytes" if bytes2 / HBM_BYTES_PER_S
        >= flops2 / PEAK_FLOPS[torch.bfloat16] else "operations",
        library_ms=None)
    log(f"  K2 bf16 B=1024 {(Lq, L1, L2)}: {ms2:.3f} ms (plain {plain2:.3f}, "
        f"bound {bound2:.3f}) max|err| {err2:.3g}")
    # the other three launch shapes of a layer, timed for PERF.md
    for (Lq, L1, L2) in STREAM_SHAPES[1:]:
        x, ws, m = _k2_inputs(g, B, Lq, L1, L2, torch.bfloat16, dev)
        qkv, mk = _k1_inputs(g, B, Lq, L1, L2, torch.float32, dev)
        log(f"  B=1024 {(Lq, L1, L2)}: K2 bf16 "
            f"{_time_ms(lambda: k2(x, ws, m), 5):.3f} ms, K1 fp32 "
            f"{_time_ms(lambda: k1(qkv, mk), 5):.3f} ms")
    A.reset_launch_counts()


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


def phase_serving(ctx):
    from segmminterest_tpu_torch.core import attention as A
    from segmminterest_tpu_torch.data.dataset import BatchIterator
    from segmminterest_tpu_torch.data.feature_store import FeatureStore
    from segmminterest_tpu_torch.data.reader import SeqReader
    from segmminterest_tpu_torch.data.synthetic import (synthetic_lineid_map,
                                                        write_synthetic_csv)
    from segmminterest_tpu_torch.engine.checkpoint import CheckPointer
    from segmminterest_tpu_torch.engine.train import InterestEngine
    from segmminterest_tpu_torch.tasks import export_logits as X

    dev = torch.device("cuda")
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
    table = _device_int8_table(PRODUCTION_ROWS, dev)
    torch.cuda.synchronize()
    n_test = len(reader.tables["test"])
    log(f"  data: {n_test} test interactions, {len(lineid_map)} segments, "
        f"table {PRODUCTION_ROWS} x {FEAT_DIM} int8 on the card "
        f"({time.perf_counter() - t0:.1f} s)")

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
    RESULT["kernels"]["K2"]["launches"] = launches["proj_two_block_attention"]
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

    # the exporter's CLI itself, over a small float32 memmap
    # (FeatureStore.open reads one memmap row per lineid-map entry:
    # ~200k rows here, the size bench.py:75 uses)
    cli_map = synthetic_lineid_map(reader)
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
    log(f"  CLI export_logits --serving 1 over a {rows}-row memmap: "
        f"{len(cli)} rows, launches "
        f"{dict(A.LAUNCHES)}")
    os.remove(memmap)
    ctx.update(reader=reader, store=store, table=table, cfg=cfg,
               ckpt=ckpt, csv=csv_path)


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
    RESULT["kernels"]["K1"]["launches"] = launches["two_block_attention"]

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
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default="build,kernels,serving,default")
    args = p.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import segmminterest_tpu_torch  # noqa: F401 (fails outside a checkout)

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
         "default": lambda: phase_default(ctx)}[name]()
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    log(f"all phases: {time.perf_counter() - t_all:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if RESULT["kernels"]:
        print(json.dumps({"kernels": list(RESULT["kernels"].values())}),
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
