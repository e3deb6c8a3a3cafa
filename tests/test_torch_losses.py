"""The port's loss zoo (segmminterest_tpu_torch/models/losses.py) against the
JAX package's ``compute_loss_dict`` on the same seeded logits and labels:
every loss type, the combinations the CLI allows (including 'focal' before
the label-dependent losses, whose in-place relabel later losses see),
padded rows, an all-padded batch (0, not NaN) and ``mask_loss``; and the
gradient of the total with respect to the logits against ``jax.grad``.
Tolerance 1e-5 relative (fp32, the same math; the softmaxes and logs
reduce in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.models.losses import compute_loss_dict as jax_losses
from segmminterest_tpu_torch.models.losses import (compute_loss_dict,
                                                   label_components)

ALL = ["focal", "huber", "hazard", "surviveCE", "interestBPR", "interestCE",
       "interestKL"]
COMBOS = [[t] for t in ALL] + [
    ["interestBPR", "focal"], ["focal", "interestCE", "interestKL"],
    ["interestCE", "focal", "interestBPR"], ALL, ALL[::-1]]
WEIGHTS = {"focal": 0.7, "mse": 1.3, "hazard": 0.5, "surviveCE": 1.1,
           "interestBPR": 1.0, "interestCE": 0.9, "interestKL": 1.7}
TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(rng, B=12, L=40, padded_rows=3):
    """Labels as the reader makes them: 1 watched .. 0 at the leave
    position .. -1 unwatched .. -2 padding past the duration; a few full
    views (no leave slot) and padded rows at the end."""
    logits = rng.normal(size=(B, L)).astype(np.float32) * 2
    gt = np.full((B, L), -2, np.int32)
    for i in range(B):
        dur = rng.integers(1, L + 1)
        vl = rng.integers(0, dur + 1)
        gt[i, :dur] = -1
        gt[i, :vl] = 1
        if vl < dur:
            gt[i, vl] = 0
    row_mask = np.ones(B, bool)
    if padded_rows:
        row_mask[-padded_rows:] = False
    exposure = rng.uniform(0.5, 1.0, size=L).astype(np.float32)
    return logits, gt, row_mask, exposure


def _both(args, types, mask_loss):
    logits, gt, row_mask, exposure = args
    want = jax_losses(jnp.asarray(logits), jnp.asarray(gt),
                      jnp.asarray(row_mask), jnp.asarray(exposure),
                      tuple(types), WEIGHTS, mask_loss)
    got = compute_loss_dict(torch.from_numpy(logits), torch.from_numpy(gt),
                            torch.from_numpy(row_mask),
                            torch.from_numpy(exposure), types, WEIGHTS,
                            mask_loss)
    return got, want


@pytest.mark.parametrize("mask_loss", [False, True])
@pytest.mark.parametrize("types", COMBOS, ids=[",".join(c) for c in COMBOS])
def test_loss_dict_matches_jax(rng, types, mask_loss):
    got, want = _both(_batch(rng), types, mask_loss)
    assert set(got) == set(want) == set(types) | {"mse", "mse2", "loss"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                                   **TOL)


def test_all_padded_batch_gives_zero_not_nan(rng):
    got, want = _both(_batch(rng, padded_rows=12), ALL, False)
    for k in want:
        assert np.isfinite(float(got[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                                   **TOL)
    assert float(got["loss"]) == 0.0


@pytest.mark.parametrize("types", [["interestBPR"], ["focal", "interestCE"],
                                   ALL])
def test_loss_gradient_matches_jax_grad(rng, types):
    logits, gt, row_mask, exposure = _batch(rng)
    want = jax.grad(lambda lg: jax_losses(
        lg, jnp.asarray(gt), jnp.asarray(row_mask), jnp.asarray(exposure),
        tuple(types), WEIGHTS, False)["loss"])(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    compute_loss_dict(lg, torch.from_numpy(gt), torch.from_numpy(row_mask),
                      torch.from_numpy(exposure), types, WEIGHTS,
                      False)["loss"].backward()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)


def test_label_components(rng):
    _, gt, row_mask, _ = _batch(rng)
    mask, gt_bin, vl, dur = label_components(torch.from_numpy(gt),
                                             torch.from_numpy(row_mask))
    np.testing.assert_array_equal(mask.numpy(),
                                  (gt != -2) & row_mask[:, None])
    np.testing.assert_array_equal(vl.numpy(),
                                  ((gt == 1) & row_mask[:, None]).sum(1))
    np.testing.assert_array_equal(dur.numpy(), mask.numpy().sum(1))
    assert gt_bin.dtype == torch.float32


def test_unknown_loss_raises(rng):
    args = [torch.from_numpy(a) for a in _batch(rng)]
    with pytest.raises(ValueError):
        compute_loss_dict(*args, ["nope"], WEIGHTS)
