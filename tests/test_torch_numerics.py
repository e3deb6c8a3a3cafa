"""The port's numerics (segmminterest_tpu_torch/core/numerics.py) against the
JAX package's on the same seeded inputs. Tolerance 1e-6: the same fp32
elementwise formulas, differing only in the last bit of exp/log/sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core import numerics as J
from segmminterest_tpu_torch.core import numerics as T

ATOL = 1e-6


def _x(rng, *shape):
    return (3 * rng.normal(size=shape)).astype(np.float32)


def test_mask_fill_value():
    assert T.MASK_FILL_VALUE == J.MASK_FILL_VALUE == -10000.0


@pytest.mark.parametrize("fn", ["log_survival_from_logits",
                                "survival_from_logits"])
def test_survival(rng, fn):
    x = _x(rng, 6, 40)
    want = getattr(J, fn)(jnp.asarray(x))
    got = getattr(T, fn)(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-6)


def test_quantize_table_int8(rng):
    t = _x(rng, 50, 64)
    t[3] = 0.0  # all-zero row: scale 0
    qj, sj = J.quantize_table_int8(t)
    qt, st = T.quantize_table_int8(t)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    # the device-side chunk quantizer agrees with the host one
    qd, sd = T.quantize_rows_int8(torch.from_numpy(t))
    np.testing.assert_array_equal(qd.numpy(), qj)
    np.testing.assert_allclose(sd.numpy(), sj, rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_rows(rng, dtype):
    q, s = J.quantize_table_int8(_x(rng, 20, 32))
    want = J.dequantize_rows(jnp.asarray(q), jnp.asarray(s),
                             getattr(jnp, dtype))
    got = T.dequantize_rows(torch.from_numpy(q), torch.from_numpy(s),
                            getattr(torch, dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL, rtol=0)


def test_l1_normalize(rng):
    x = _x(rng, 4, 7, 33)
    np.testing.assert_allclose(
        T.l1_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(J.l1_normalize(jnp.asarray(x))), atol=ATOL, rtol=1e-6)


def test_masked_attention_logits(rng):
    q, k = _x(rng, 3, 5, 2, 8), _x(rng, 3, 7, 2, 8)
    mq, mk = rng.random((3, 5)) > 0.3, rng.random((3, 7)) > 0.3
    want = J.masked_attention_logits(*map(jnp.asarray, (q, k, mq, mk)))
    got = T.masked_attention_logits(*map(torch.from_numpy, (q, k, mq, mk)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-6)
