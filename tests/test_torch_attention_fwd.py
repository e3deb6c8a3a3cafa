"""fp32 K1f and K3f on the TF32 tensor cores (core/csrc/tf32_attention.cuh),
on the CPU, where no kernel runs:

* the arithmetic: K1's and K3's plain forwards with every product (q k^T
  and p v) formed in 3xTF32, as the kernels form them (each fp32 operand
  split into TF32 big and small halves, big.small + small.big + big.big),
  stay within 1e-5 of themselves in fp32 at the stream shapes of a
  both/both layer and of CrossAtt, dropout off and on, H=2 heads of 32,
  B=16 (at most 9.1e-7 here); one TF32 rounding of the operands leaves
  3.8e-4 to 8.6e-4, past the kernels' 1e-4 bar. At the scaled shapes of
  tests/test_torch_attention.py the 3xTF32 forwards agree with the JAX
  Pallas kernels run through the interpreter within their fp32 tolerance
  of 2e-5;
* K1f's shape rule (``k1_body``): every shape the first CUDA-core fp32
  body took is taken by the tensor-core body (at every shape, on its
  key-chunk path past its one-chunk shapes), which runs the model's stream
  shapes at head dims 16, 32, 64 and 128 in one chunk, and the wrapper
  hands its choice to the C entry point (replaced here by a recorder, so
  no nvcc is needed).

The kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core.attention import \
    fused_masked_attention as jax_k3
from segmminterest_tpu.core.attention import \
    fused_two_block_attention as jax_k1
from segmminterest_tpu_torch.core import attention as A
from test_torch_attention_bwd import _tf32_einsum

K1_SHAPES = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)]
K3_SHAPES = [(40, 100), (100, 40)]
H, DH = 2, 32
SEED, RATE = 12345, 0.3
JAX_TOL = dict(atol=2e-5, rtol=2e-5)


def _masks(rng, B, L, empty_row):
    m = np.zeros((B, L), bool)
    for i in range(B):
        m[i, :rng.integers(1, L + 1)] = True
    if empty_row and L > 1:
        m[0] = False  # a fully padded row
    return m


def _k1_inputs(rng, B, Lq, L1, L2):
    arrays = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
              for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = (_masks(rng, B, Lq, True), _masks(rng, B, L1, False),
             _masks(rng, B, L2, Lq > 1))
    return arrays, masks


def _k3_inputs(rng, B, Lq, Lk):
    arrays = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
              for L in (Lq, Lk, Lk)]
    return arrays, (_masks(rng, B, Lq, True), _masks(rng, B, Lk, False))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _forwards(plain, args, monkeypatch):
    """plain(*args) in fp32, in 3xTF32 and with one TF32 rounding."""
    want = plain(*args)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(3))
    got = plain(*args)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(1))
    one = plain(*args)
    monkeypatch.undo()
    return want, got, one


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1f_3xtf32_products_match_fp32(rng, shape, drop, monkeypatch):
    """fp32 K1f forms q k^T and p v on the TF32 tensor cores in 3xTF32:
    within 1e-5 of the fp32 forward at the four stream shapes, where one
    TF32 rounding misses 1e-4."""
    arrays, masks = _k1_inputs(rng, 16, *shape)
    args = (*map(_t, arrays + list(masks)), 1 / math.sqrt(DH),
            RATE if drop else 0.0, SEED)
    want, got, one = _forwards(A.two_block_attention_plain, args,
                               monkeypatch)
    assert _rel(got, want) <= 1e-5, f"3xTF32: {_rel(got, want):.3g}"
    assert _rel(one, want) > 1e-4, f"one TF32 pass: {_rel(one, want):.3g}"


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3f_3xtf32_products_match_fp32(rng, shape, drop, monkeypatch):
    """fp32 K3f, the same arithmetic over one key block, at CrossAtt's two
    feature stream shapes."""
    arrays, masks = _k3_inputs(rng, 16, *shape)
    args = (*map(_t, arrays + list(masks)), 1 / math.sqrt(DH),
            RATE if drop else 0.0, SEED)
    want, got, one = _forwards(A.masked_attention_plain, args, monkeypatch)
    assert _rel(got, want) <= 1e-5, f"3xTF32: {_rel(got, want):.3g}"
    assert _rel(one, want) > 1e-4, f"one TF32 pass: {_rel(one, want):.3g}"


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("kernel,shape", [("K1", (8, 8, 12)),
                                          ("K1", (1, 8, 1)), ("K3", (8, 12)),
                                          ("K3", (12, 8))])
def test_3xtf32_forward_matches_jax_kernel(rng, kernel, shape, drop,
                                           monkeypatch):
    """The 3xTF32 forwards against the JAX kernels in interpret mode, with
    the same dropout bits."""
    if kernel == "K1":
        arrays, masks = _k1_inputs(rng, 16, *shape)
        want = jax_k1(*map(jnp.asarray, arrays + list(masks)),
                      dropout_rate=RATE if drop else 0.0,
                      deterministic=not drop,
                      seed=jnp.asarray([SEED], jnp.int32), interpret=True)
        fused = A.fused_two_block_attention
    else:
        arrays, masks = _k3_inputs(rng, 16, *shape)
        want = jax_k3(*map(jnp.asarray, arrays + list(masks)),
                      dropout_rate=RATE if drop else 0.0,
                      deterministic=not drop,
                      seed=jnp.asarray([SEED], jnp.int32), interpret=True)
        fused = A.fused_masked_attention
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(3))
    got = fused(*map(_t, arrays + list(masks)), seed=SEED,
                dropout_rate=RATE if drop else 0.0, deterministic=not drop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def _cuda_core_k1f_smem(Lq, L1, L2, D):
    """Shared memory of K1f's CUDA-core body, which took every fp32 shape
    before the tensor-core body and which the wrapper holds to one block's
    (two_block_attention.cu k1_smem_bytes): six fp32 tiles of row stride
    D + 4, the masks, a probability row per warp (8 warps)."""
    def pad4(n):
        return (n + 3) // 4 * 4
    return (4 * (2 * Lq + 2 * L1 + 2 * L2) * (D + 4) + 4 * pad4(Lq + L1 + L2)
            + 4 * 8 * (pad4(L1) + pad4(L2)))


def test_k1f_shape_rule_takes_every_shape_the_cuda_core_body_took():
    """Every fp32 shape the CUDA-core body took alone, at head dims up to
    128, is taken by the tensor-core body: in one chunk where
    ``tf32_whole`` says so (a query window of its tiles fits one block, its
    key axis at most 256 keys, 144 past head dim 64), else on its key-chunk
    path; past head dim 128 the rule raises."""
    lengths = (1, 8, 40, 100, 128, 129, 200, 300)
    taken = whole = 0
    for D in range(4, 260, 4):
        for Lq in lengths:
            for L1 in lengths:
                for L2 in lengths:
                    if _cuda_core_k1f_smem(Lq, L1, L2, D) > A.MAX_SMEM_BYTES:
                        continue
                    if D > 128:
                        with pytest.raises(ValueError):
                            A.k1_body(torch.float32, Lq, L1, L2, D)
                        continue
                    taken += 1
                    assert A.k1_body(torch.float32, Lq, L1, L2, D) == "tf32"
                    if A.tf32_whole(Lq, (L1, L2), D, False):
                        whole += 1
                        w = A.tf32_window(Lq, (L1, L2), D, False)
                        assert 0 < w and (w == Lq or w % 16 == 0)
                        assert (A.tf32_smem_bytes(w, (L1, L2), D, False)
                                <= A.MAX_SMEM_BYTES)
                        assert A._pad8(L1) + A._pad8(L2) <= (
                            256 if D <= 64 else 144)
    assert taken > whole > 0


@pytest.mark.parametrize("D", [16, 32, 64])
def test_k1f_tensor_cores_take_the_model_streams(D):
    """The model's four K1 stream shapes at head dims 16, 32 (the
    flagship's) and 64 run on the tensor cores in fp32, and in bf16 on the
    bf16 two-block core ("mma", in one chunk there); fp32 at head dim 128
    (--nhead 4 at d_model 512) runs on the tensor cores too, in query
    windows where one block's tiles exceed shared memory, and fp32 past
    256 keys on the same core's key-chunk path."""
    for shape in K1_SHAPES:
        assert A.k1_body(torch.float32, *shape, D) == "tf32"
        assert A.k1_body(torch.bfloat16, *shape, D) == "mma"
        assert A.k2_core_whole(*shape, D, False)
        assert A.k1_body(torch.float32, *shape, 128) == "tf32"
    assert A.k1_body(torch.float32, 40, 128, 128, D) == "tf32"
    assert A.tf32_whole(40, (128, 128), D, False)
    assert A.k1_body(torch.float32, 40, 129, 128, D) == "tf32"
    assert not A.tf32_whole(40, (129, 128), D, False)


@pytest.mark.parametrize("dtype,D,tf32", [(torch.float32, 32, 1),
                                          (torch.float32, 64, 1),
                                          (torch.float32, 128, 1),
                                          (torch.bfloat16, 32, None)])
def test_k1f_wrapper_hands_its_body_to_the_kernel(monkeypatch, dtype, D,
                                                  tf32):
    """The wrapper sends the rule's choice to its C entry point: fp32 to
    K1f's (``segmm_two_block_attention_fwd``, the 3xTF32 core, which picks
    one chunk or key chunks by the shape itself), bf16 to the two-block
    core's (``segmm_two_block_core_fwd``, K1's block keys: its last
    argument before the stream is 0); both get (B, Lq, L1, L2, H, D)
    after their ten pointers. Nothing else is asked."""
    calls = []

    def fn(lib, symbol, restype, argtypes):
        def call(*args):
            calls.append((symbol, args))
            return 0
        return call
    monkeypatch.setattr(A, "_fn", fn)
    monkeypatch.setattr(A, "_stream_ptr", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(A, "LAUNCHES", {k: 0 for k in A.LAUNCHES})
    B, (Lq, L1, L2) = 2, K1_SHAPES[0]
    ts = [torch.zeros(B, L, 2, D, dtype=dtype)
          for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = [torch.ones(B, L, dtype=torch.bool) for L in (Lq, L1, L2)]
    A._k1_forward_cuda(*ts, *masks, 0.125, 0.0, 0)
    (fwd, fwd_args), = calls
    assert fwd_args[10:16] == (B, Lq, L1, L2, 2, D)
    if tf32 is None:
        assert fwd == "segmm_two_block_core_fwd" and fwd_args[-2] == 0
    else:
        assert fwd == "segmm_two_block_attention_fwd"
    assert A.LAUNCHES["two_block_attention"] == 1
