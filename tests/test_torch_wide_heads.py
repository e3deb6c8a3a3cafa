"""The port at the head dims past the flagship's 32 that the card's kernels
now take, on the CPU against the JAX package (the wrappers run their plain
versions on CPU tensors):

* the model at d_model 512 with 4 heads (head dim 128, ``skip_train
  --nhead 4``) and at d_model 768 with 16 heads (head dim 48), fp32,
  dropout off, on each attention route (K1, K2, K6 under SEGMM_ATTN_V2's
  switch, K3 under CrossAtt, K5 under fuse_dual, K4 under fuse_layer):
  logits within the PARITY bar of 1.4e-6 of the flax model with converted
  weights, on the logits' scale (below); five lock-step AdamW steps within
  3e-4 are in tests/test_torch_wide_lockstep.py;
* each kernel's shape rule (``k1_body``, ``_check_k2`` with the dtype's
  head dims, ``k3_takes``, ``_check_k4``, the bf16 core's shared memory)
  at the shapes it now takes and at those it refuses;
* K6's forward key map (``kConcatKeys`` in two_block_mma.cuh's
  ``k2_keep_bits``, mirrored by ``_core_keep``) against the JAX kernel's
  ``_dropout_keep`` over the concatenated key axis in interpret mode;
* bf16 K6f's arithmetic on the (d, d) weights (K2f's projections, the
  joint softmax with K6's keep bits) at fp32 within 1e-6 of the
  interleaved form, ``proj_two_block_attention_v2_plain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core.attention import _dropout_keep as jax_keep
from segmminterest_tpu.models.interest import SegInterestModel as JaxModel
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.core import dual_kernel as K5
from segmminterest_tpu_torch.core import layer_kernel as LK
from segmminterest_tpu_torch.models.convert import load_flax_params
from segmminterest_tpu_torch.models.interest import SegInterestModel
from test_torch_v2_dual_mma import _core_keep

# (d_model, heads): head dims 128 and 48
WIDTHS = {"d512-h4": (512, 4), "d768-h16": (768, 16)}
# the port's flags of each route; the JAX model runs its reference path
ROUTES = {"k1": dict(fused_attention=True),
          "k2": dict(fused_attention=True, fuse_qkv=True),
          "k6": dict(fused_attention=True, fuse_qkv=True),
          "k3-CrossAtt": dict(fused_attention=True),
          "k5-fuse_dual": dict(fused_attention=True, fuse_dual=True),
          "k4-fuse_layer": dict(fuse_layer=True)}
# PARITY's bar for a forward with transplanted weights, 1.4e-6 max abs,
# was measured at d_model 32 (tests/test_reference_model_forward.py), where
# the logits are O(1). At d_model 512 and 768 they reach ~7, where an fp32
# ulp is 4.8e-7, and the port's composed route, which no kernel touches,
# is itself 2.4e-6 (d 512) and 3.3e-6 (d 768) from flax there: the bar is
# held relative to the largest |logit| (measured 2.9e-7 to 5.3e-7 on every
# route)
FWD_RTOL_OF_MAX = 1.4e-6
# each route's plain forward (module, name), which the wrappers run on CPU
# tensors: the tests count its calls, so that a route is seen to run
ROUTE_PLAIN = {"k1": (A, "two_block_attention_plain"),
               "k2": (A, "proj_two_block_attention_plain"),
               "k6": (A, "proj_two_block_attention_v2_plain"),
               "k3-CrossAtt": (A, "masked_attention_plain"),
               "k5-fuse_dual": (K5, "dual_stream_attention_plain"),
               "k4-fuse_layer": (LK, "layer_stream_plain")}


def count_route_calls(route, monkeypatch):
    """A list that grows by one at each call of the route's plain forward
    (output_layers=[-1]: a model of n layers runs n - 1 of them)."""
    module, name = ROUTE_PLAIN[route]
    calls, plain = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls
Bm, F, LU = 3, 48, 100


def _ablation(route):
    return "CrossAtt" if "CrossAtt" in route else "ours"


def _inputs(rng):
    usr_img = rng.normal(size=(Bm, LU, F)).astype(np.float32)
    vid_img = rng.normal(size=(Bm, 40, F)).astype(np.float32)
    um, vm = np.zeros((Bm, LU), bool), np.zeros((Bm, 40), bool)
    for i in range(Bm):
        um[i, :rng.integers(1, LU + 1)] = True
        vm[i, :rng.integers(1, 41)] = True
    uid = rng.integers(1, 21, size=Bm).astype(np.int32)
    vid = rng.integers(1, 31, size=Bm).astype(np.int32)
    return usr_img, uid, um, vid_img, vid, vm


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_wide_model_forward_matches_flax(rng, width, route, monkeypatch):
    """One layer run (two built: the model reads the last one's input),
    both modalities (the streams of 40 and 100 segments),
    fp32, deterministic: the port's logits on each route against the flax
    model's with the same converted weights."""
    d, heads = WIDTHS[width]
    monkeypatch.setattr(A, "ATTN_V2", route == "k6")
    calls = count_route_calls(route, monkeypatch)
    kw = dict(d_model=d, num_heads=heads, num_layers=2, ff_dim=d,
              n_users=20, n_items=30, fusion_heads=2, user_input="both",
              photo_input="both", ablation=_ablation(route))
    args = _inputs(rng)
    jm = JaxModel(**kw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = SegInterestModel(**kw, feat_dim=F, **ROUTES[route]).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (Bm, 40) and calls
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FWD_RTOL_OF_MAX * np.abs(want).max())


# --- the shape rules -------------------------------------------------------

STREAMS = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)]
WIDE_DIMS = (48, 96, 128)


@pytest.mark.parametrize("D", A.K2_HEAD_DIMS)
def test_k1_rule_takes_every_head_dim_at_the_streams(D):
    """K1 at the four stream shapes and every head dim of the flagship's
    widths, both directions: fp32 on the tensor-core body (in query
    windows where one block's tiles exceed shared memory), bf16 on the
    bf16 two-block core ("mma"), in one chunk at every one of them."""
    for shape in STREAMS:
        for bwd in (False, True):
            assert A.k1_body(torch.float32, *shape, D, bwd) == "tf32"
            w = A.tf32_window(shape[0], shape[1:], D, bwd)
            assert w == shape[0] or (w % 16 == 0 and 0 < w < shape[0])
            assert A.k1_body(torch.bfloat16, *shape, D, bwd) == "mma"
            assert A.k2_core_whole(*shape, D, bwd)
    # the flagship's head dim and 64 keep their bodies whole
    if D <= 64:
        for shape in STREAMS:
            assert A.tf32_window(shape[0], shape[1:], D, True) == shape[0]
    # the widest stream at head dim 128 takes windows in the backward
    if D == 128:
        assert A.tf32_windows(100, (40, 100), D, True) > 1


@pytest.mark.parametrize("D,shape,bwd", [
    (130, (40, 40, 100), False), (132, (40, 40, 100), True),
    (32, (40, 129, 128), True), (64, (129, 40, 100), True)])
def test_k1_rule_refuses_what_no_body_takes(D, shape, bwd):
    """A head dim not a multiple of 4, or past 128, raises in both dtypes;
    a stream past 128 runs on the cores' key-chunk paths in both (fp32
    where the one-chunk body refused it, bf16 where its tiles exceed one
    chunk)."""
    for dt in (torch.float32, torch.bfloat16):
        if D % 4 == 0 and D <= 128 and (dt == torch.float32
                                        or D in A.K2_HEAD_DIMS):
            assert A.k1_body(dt, *shape, D, bwd) == (
                "tf32" if dt == torch.float32 else "mma")
            if dt == torch.float32:
                assert not A.tf32_whole(shape[0], shape[1:], D, bwd)
            continue
        with pytest.raises(ValueError):
            A.k1_body(dt, *shape, D, bwd)


def _k2_tensors(dtype, B, Lq, L1, L2, d):
    xs = tuple(torch.zeros(B, L, d, dtype=dtype) for L in (Lq, L1, L2))
    ws = tuple(t for _ in range(6) for t in (torch.zeros(d, d, dtype=dtype),
                                             torch.zeros(d, dtype=dtype)))
    masks = tuple(torch.ones(B, L, dtype=torch.bool) for L in (Lq, L1, L2))
    return xs + ws, masks


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_k2_rule_takes_the_wide_head_dims_in_bf16(D):
    """K2 (and K4, K5, K6, which check through it) takes head dims 48, 96
    and 128 at the streams: bf16 with its core's blocks within shared
    memory (the backward's operands staged in turns past 64); fp32 on the
    projections and K1's tensor-core body ("tf32")."""
    d = 4 * D if D != 48 else 768
    for shape in STREAMS:
        ts, masks = _k2_tensors(torch.bfloat16, 2, *shape, d)
        assert A._check_k2(ts, masks, d // D)[-1] == D
        for bwd in (False, True):
            assert A.k2_mma_smem_bytes(*shape, D, bwd) <= A.MAX_SMEM_BYTES
        assert A.k2_mma_smem_bytes(*shape, D, True, g_fp32=True) \
            <= A.MAX_SMEM_BYTES
        ts, masks = _k2_tensors(torch.float32, 2, *shape, d)
        assert A._check_k2(ts, masks, d // D)[-1] == D
        assert A.k2_body(torch.float32) == "tf32"


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_k2_bf16_rule_refuses_key_axes_past_144_at_wide_head_dims(D):
    """Past 16, 32 and 64 the bf16 core's register tile holds 144 keys:
    (40 | 100) and (100 | 40) keys run in one chunk, (100 | 100) and
    (128 | 128) on the key-chunk path, which the rule takes too; at 64 one
    chunk holds 256."""
    d = 4 * D if D != 48 else 768
    for L1, L2, whole in ((40, 100, True), (100, 40, True), (1, 40, True),
                          (100, 100, False), (128, 128, False)):
        ts, masks = _k2_tensors(torch.bfloat16, 2, 40, L1, L2, d)
        A._check_k2(ts, masks, d // D)
        assert A.k2_core_whole(40, L1, L2, D, False) == whole
    ts, masks = _k2_tensors(torch.bfloat16, 2, 40, 128, 128, 512)
    A._check_k2(ts, masks, 8)
    assert A.k2_core_whole(40, 128, 128, 64, False)


def test_k2_backward_core_stages_in_turns_past_64():
    """Past head dim 64 the bf16 backward core's tiles are two regions of
    max(queries, keys) rows and one (two with an fp32 g) of queries; at 64
    and below, all at once as before."""
    Lq, L1, L2 = 100, 40, 100
    mq16, nk16 = 112, 144
    rest = A.k2_mma_smem_bytes(Lq, L1, L2, 64, True) \
        - 2 * (3 * mq16 + 2 * nk16) * 72
    for D in (96, 128):
        for g32, gt in ((False, 1), (True, 2)):
            got = A.k2_mma_smem_bytes(Lq, L1, L2, D, True, g_fp32=g32)
            tiles = 2 * (2 * max(mq16, nk16) + gt * mq16) * (D + 8)
            assert got == tiles + rest
    # the widest stream's backward at 128 was 241,536 bytes staged whole
    assert A.k2_mma_smem_bytes(Lq, L1, L2, 128, True) == 180_608
    assert A.k2_mma_smem_bytes(Lq, L1, L2, 128, True, g_fp32=True) \
        == 211_072


@pytest.mark.parametrize("D", A.K3_HEAD_DIMS)
def test_k3_rule_takes_the_ablation_shapes(D):
    """K3 at CrossAtt's and SelfAtt's shapes, every head dim, both dtypes,
    both directions, on its own bodies in one chunk; a length past 128 runs
    on the 3xTF32 core's key-chunk path in fp32 and on the two-block core's
    in bf16; other head dims raise."""
    for shape in ((40, 100), (100, 40), (100, 100), (40, 40), (40, 1),
                  (1, 40)):
        for dt in (torch.float32, torch.bfloat16):
            for bwd in (False, True):
                assert A.k3_takes(dt, *shape, D, bwd) == (
                    "tf32" if dt == torch.float32 else "mma")
                assert A.tf32_whole(shape[0], shape[1:], D, bwd)
    assert A.k3_takes(torch.float32, 129, 40, D, False) == "tf32"
    assert not A.tf32_whole(129, (40,), D, False)
    assert A.k3_takes(torch.bfloat16, 129, 40, D, False) == "core"
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError):
            A.k3_takes(dt, 40, 40, D + 8, False)


def test_k3_bf16_rule_refuses_past_shared_memory():
    """bf16 K3b at head dim 128 and (128, 128) needs more than one block's
    shared memory of its own body, and runs on the two-block core's
    key-chunk path instead; (100, 100) fits its own body."""
    assert A.k3_mma_smem_bytes(100, 100, 128, True) <= A.MAX_SMEM_BYTES
    assert A.k3_mma_smem_bytes(128, 128, 128, True) > A.MAX_SMEM_BYTES
    assert A.k3_takes(torch.bfloat16, 100, 100, 128, True) == "mma"
    assert A.k3_takes(torch.bfloat16, 128, 128, 128, True) == "core"
    assert A.k2_chunked_smem_bytes(128, True) <= A.MAX_SMEM_BYTES
    assert A.k3_takes(torch.float32, 128, 128, 128, True) == "tf32"


def _k4_tensors(dtype, d, ff):
    ep = [torch.zeros(d, d, dtype=dtype), torch.zeros(d, dtype=dtype),
          torch.ones(d), torch.zeros(d), torch.zeros(ff, d, dtype=dtype),
          torch.zeros(ff, dtype=dtype), torch.zeros(d, ff, dtype=dtype),
          torch.zeros(d, dtype=dtype), torch.ones(d), torch.zeros(d)]
    return ep


@pytest.mark.parametrize("d,ff,heads,takes", [
    (768, 768, 16, True), (768, 768, 8, True), (512, 512, 4, True),
    (512, 768, 16, True), (1024, 1024, 16, False), (768, 1024, 16, False)])
def test_k4_bf16_rule_takes_widths_to_768(d, ff, heads, takes):
    """bf16 K4's tensor-core epilogue takes d, ff <= 768 (32-row blocks
    past 512); wider layers (`takes` False) run the row-tile epilogue in
    bf16, 8 rows a block at 1024; its shared memory fits at every width."""
    ts, masks = _k2_tensors(torch.bfloat16, 2, 40, 40, 100, d)
    ep = _k4_tensors(torch.bfloat16, d, ff)
    assert LK._check_k4(*ts[:3], ts[3:], ep, masks, heads)[-1] == ff
    for bwd in (False, True):
        assert LK.k4_mma_smem_bytes(100, 40, 100, d // heads, bwd, d, ff) \
            <= A.MAX_SMEM_BYTES
        rows = LK.k4_epilogue_rows(torch.bfloat16, d, ff, bwd)
        if takes:
            assert rows == LK.k4_mma_rows(d, ff) == (
                64 if max(d, ff) <= 512 else 32)
        else:
            assert rows in (8, 16) and LK.k4_rowtile_smem_bytes(
                torch.bfloat16, d, ff, rows, bwd) <= A.MAX_SMEM_BYTES


# --- K6's keys and bf16 K6f's arithmetic -----------------------------------

@pytest.mark.parametrize("shape", [(40, 40, 100), (100, 40, 100), (7, 13, 9)])
def test_k6_forward_keys_are_jax_dropout_keep_over_the_concatenated_axis(
        shape):
    """The forward core's kConcatKeys bits on its padded axis (the same
    k2_keep_bits as the backward's), unpacked, are the JAX kernel's
    interpret-mode keep bits over (batch tile row, query, concatenated key)
    with salt h and seed seed + tile."""
    B, (Lq, L1, L2), H, seed, rate = 8, shape, 2, 4321, 0.1
    k1, k2 = _core_keep(B, Lq, L1, L2, seed, rate, concat=True)
    for h in range(H):
        want = np.asarray(jax_keep((B, Lq, L1 + L2), rate, interpret=True,
                                   seed_val=jnp.uint32(seed), salt=h))
        got = torch.cat([k1[:, h], k2[:, h]], -1).numpy()
        np.testing.assert_array_equal(got, want)


def _k6f_on_k2_pieces(xq, x1, x2, ws, masks, H, scale, rate, seed):
    """bf16 K6f's function in fp32: K2f's projections on the (d, d)
    weights as they are, one softmax over both blocks with K6's keep bits
    (the concatenated keys, salt h), p v summed over the blocks."""
    q1, q2, k1, k2, v1, v2 = A._projections(xq, x1, x2, ws, H)
    B, Lq = xq.shape[:2]
    L1, L2 = x1.shape[1], x2.shape[1]
    keep1 = keep2 = None
    if rate > 0:
        cat = A.dropout_keep(B, H, Lq, L1 + L2, seed, 0, rate, xq.device,
                             salt_stride=1)
        keep1, keep2 = cat[..., :L1], cat[..., L1:]
    p1, p2 = A._joint_probs(A._logits(q1, k1), A._logits(q2, k2),
                            A._pair_mask(masks[0], masks[1]),
                            A._pair_mask(masks[0], masks[2]), scale, keep1,
                            keep2, A.keep_divisor(rate))
    out = (torch.einsum("bhqk,bkhd->bqhd", p1, v1)
           + torch.einsum("bhqk,bkhd->bqhd", p2, v2))
    return out.reshape(xq.shape)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("shape", [(40, 40, 100), (7, 16, 9)])
def test_k6f_on_k2_pieces_is_the_interleaved_form(rng, shape, D, rate):
    """At fp32, K2f's pieces with K6's keys are K6f's plain version (the
    interleaved weights, one (Lq, L1 + L2) logit matrix a head) within
    1e-6: the zero halves of the interleaved weights add nothing."""
    B, (Lq, L1, L2), H = 8, shape, 2
    d = H * D
    xs = [torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32))
          for L in (Lq, L1, L2)]
    ws = []
    for _ in range(6):
        ws += [torch.from_numpy((rng.normal(size=(d, d)) / np.sqrt(d))
                                .astype(np.float32)),
               torch.from_numpy((0.1 * rng.normal(size=d)).astype(
                   np.float32))]
    masks = []
    for L, empty in ((Lq, True), (L1, False), (L2, False)):
        m = np.arange(L)[None] < rng.integers(1, L + 1, B)[:, None]
        m[0] &= not empty
        masks.append(torch.from_numpy(m))
    scale = 1 / np.sqrt(D)
    got = _k6f_on_k2_pieces(*xs, ws, masks, H, scale, rate, 77)
    want = A.proj_two_block_attention_v2_plain(*xs, *ws, *masks, H, scale,
                                               rate, 77)
    assert (got - want).abs().max().item() <= 1e-6
