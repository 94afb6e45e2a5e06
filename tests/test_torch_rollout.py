"""pigeon_tpu_torch.qp.condensed.rollout_affine against the JAX package:
the TPU rollout kernel run in interpret mode and the sequential unroll, on
the same float32 inputs; from ROLLOUT_SCAN_MIN_T on, the associative scan
(`rollout_affine_scan`) against the JAX package's at float64.  On the CPU
the port's wrapper runs its plain version (`rollout_affine_unroll`) below
the threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigeon_tpu.qp import condensed as JC
from pigeon_tpu_torch.qp import condensed as TC


def _inputs(B, T, d, w, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(B, T, d, d)) * 0.4).astype(np.float32)
    E = rng.normal(size=(B, T, d, w)).astype(np.float32)
    return A, E


@pytest.mark.parametrize("B,T,d,w", [
    (7, 5, 4, 31),      # ragged batch, odd width
    (130, 30, 4, 31),   # the decoupled fleet's shape, two lane blocks
    (9, 15, 6, 31),     # the coupled condensed shape
    (4, 3, 2, 8),       # a whole width block of the TPU kernel
    (5, 30, 4, 31),
])
def test_rollout_matches_tpu_kernel_and_unroll(B, T, d, w):
    A, E = _inputs(B, T, d, w)
    out = TC.rollout_affine(torch.as_tensor(A), torch.as_tensor(E))
    assert out.dtype == torch.float32 and out.shape == (B, T, d, w)
    lane = JC._rollout_lane_batched(jnp.asarray(A), jnp.asarray(E),
                                    interpret=True)
    unroll = jax.vmap(JC.rollout_affine_unroll)(jnp.asarray(A),
                                                jnp.asarray(E))
    # float32, the same recursion; only the order of the d-term sums may
    # differ (the bar of tests/test_rollout_lane.py)
    np.testing.assert_allclose(out.numpy(), np.asarray(lane), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(unroll), rtol=2e-6,
                               atol=2e-6)


def test_rollout_long_horizon_and_float64():
    """From ROLLOUT_SCAN_MIN_T on both packages take their associative
    scans (the port's Hillis-Steele doubling, the JAX package's
    `lax.associative_scan`), on any device.  Float64: rounding of the
    scans' regrouped products only."""
    assert TC.ROLLOUT_SCAN_MIN_T == JC.ROLLOUT_SCAN_MIN_T
    A, E = _inputs(2, 70, 4, 5, seed=1)
    A, E = A.astype(np.float64) * 0.5, E.astype(np.float64)
    out = TC.rollout_affine(torch.as_tensor(A), torch.as_tensor(E))
    ref = jax.vmap(JC.rollout_affine)(jnp.asarray(A), jnp.asarray(E))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-11,
                               atol=1e-12)


def test_rollout_long_horizon_raises_off_the_cpu():
    """The plain loop is for CPU tensors only.  A tensor on any other
    device takes the associative scan from ROLLOUT_SCAN_MIN_T on (torch
    ops on its own device) and below it the kernel, whose checks refuse
    anything but a CUDA tensor: never the plain loop.  A meta tensor
    stands for the card here."""
    T = TC.ROLLOUT_SCAN_MIN_T
    A = torch.empty(2, T, 4, 4, dtype=torch.float32, device="meta")
    E = torch.empty(2, T, 4, 5, dtype=torch.float32, device="meta")
    out = TC.rollout_affine(A, E)
    assert out.device.type == "meta" and out.shape == E.shape
    # below the threshold such a tensor is sent on to the kernel's checks
    with pytest.raises(ValueError, match="CUDA tensor"):
        TC.rollout_affine(A[:, :T - 1], E[:, :T - 1])


@pytest.mark.parametrize("T", [64, 96, 130])
def test_rollout_scan_matches_jax_scan(T):
    """The port's scan against the JAX package's `rollout_affine_scan`
    and the sequential unroll at float64, at horizons from the threshold
    on: a power of two, one between and one past 128 (ceil(log2 T)
    rounds, 6 to 8); `rollout_affine` takes the scan there."""
    A, E = _inputs(3, T, 4, 7, seed=T)
    A, E = A.astype(np.float64) * 0.6, E.astype(np.float64)
    At, Et = torch.as_tensor(A), torch.as_tensor(E)
    out = TC.rollout_affine(At, Et)
    np.testing.assert_array_equal(out.numpy(),
                                  TC.rollout_affine_scan(At, Et).numpy())
    ref = jax.vmap(JC.rollout_affine_scan)(jnp.asarray(A), jnp.asarray(E))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(
        out.numpy(), TC.rollout_affine_unroll(At, Et).numpy(), rtol=1e-11,
        atol=1e-12)


def test_rollout_rejects_bad_arguments():
    A, E = (torch.as_tensor(a) for a in _inputs(2, 3, 4, 5))
    with pytest.raises(ValueError, match="shape"):
        TC.rollout_affine(A[:, :2], E)
    with pytest.raises(ValueError):
        TC.rollout_affine(A.double(), E)
    with pytest.raises(ValueError, match=r"\(B, T, d, d\)"):
        TC.rollout_affine(A[0], E[0])
