"""The reference-faithful linearization of the coupled controller (RK4
steps differentiated, src/coupled_lat_long.jl:253,262) and the per-hold
order exponentials ("expm_split") in the port against the JAX package:

- `rk4_step_ramp`, `linearize_zoh` and `linearize_foh` at 1 and 4
  substeps, batched over rows against the JAX package's `vmap`, at
  float64 (rtol 1e-12), on states from slow (stiff tire modes: one step
  over 0.2 s amplifies them, |eig A| > 1, in both packages) to fast;
- `linearize_affine_horizon` / `extract_affine_horizon` (rtol 1e-12);
- float32 inputs give float32 outputs.

tests/test_torch_rk4_qp.py holds the QPs built on them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t64
from pigeon_tpu import discretize as JZ
from pigeon_tpu import dynamics as JD
from pigeon_tpu_torch import discretize as TZ
from pigeon_tpu_torch import dynamics as TD
from pigeon_tpu_torch.config import x1_params

VEH = x1_params()
F64 = torch.float64


def _jf(q, ur):
    return JD.vehicle_ode(VEH, "tracking", q, ur[:2], ur[2:])


def _tf(q, ur):
    return TD.vehicle_ode(VEH, "tracking", q, ur[..., :2], ur[..., 2:])


def _rows(K=6, seed=0):
    """K tracking states and stage inputs, speeds 1.5 to 12 m/s, with
    step lengths of the short (0.01 s) and the long (0.2 s) stages."""
    rng = np.random.default_rng(seed)
    Ux = np.linspace(1.5, 12.0, K)
    q = np.stack([rng.normal(0, 0.3, K), Ux, rng.normal(0, 0.2, K),
                  rng.normal(0, 0.1, K), rng.normal(0, 0.05, K),
                  rng.normal(0, 0.3, K)], axis=1)
    ur0 = np.stack([rng.normal(0, 0.05, K), rng.normal(0, 500, K), Ux,
                    rng.normal(0, 0.02, K), np.zeros(K), np.zeros(K)], 1)
    urf = ur0 + rng.normal(0, 0.01, (K, 6)) * [1, 1e4, 1, 1, 0, 0]
    dt = np.where(np.arange(K) % 2 == 0, 0.2, 0.01)
    return q, ur0, urf, dt


def _close(t, j, rtol=1e-12):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * np.abs(j).max())


def test_rk4_step_ramp_matches():
    q, ur0, urf, dt = _rows()
    ref = jax.vmap(lambda a, b, c, h: JZ.rk4_step_ramp(_jf, a, b, c, h))(
        q, ur0, urf, dt)
    out = TZ.rk4_step_ramp(_tf, t64(q), t64(ur0), t64(urf),
                           t64(dt)[:, None])
    _close(out, ref)


@pytest.mark.parametrize("substeps", [1, 4])
def test_linearize_zoh_matches(substeps):
    q, ur0, _, dt = _rows()
    ref = jax.vmap(lambda a, b, h: JZ.linearize_zoh(
        _jf, a, b, h, 2, substeps=substeps))(q, ur0, dt)
    out = TZ.linearize_zoh(_tf, t64(q), t64(ur0), t64(dt), 2, substeps)
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("substeps", [1, 4])
def test_linearize_foh_matches(substeps):
    q, ur0, urf, dt = _rows()
    ref = jax.vmap(lambda a, b, c, h: JZ.linearize_foh(
        _jf, a, b, c, h, 2, substeps=substeps))(q, ur0, urf, dt)
    out = TZ.linearize_foh(_tf, t64(q), t64(ur0), t64(urf), t64(dt), 2,
                           substeps)
    assert [o.shape for o in out] == [(6, 6, 6), (6, 6, 2), (6, 6, 2),
                                      (6, 6)]
    for o, r in zip(out, ref):
        _close(o, r)


def test_one_step_amplifies_the_stiff_modes():
    """At 1.5 m/s over 0.2 s one RK4 step leaves the stability region
    (the reference's own instability, `parity.stable_substeps`): the
    discrete model's spectral radius is 2.5 at 1 substep; at 16 it is
    the marginal modes' 1 (the path states' integrators), in both
    packages alike (the matrices above are equal)."""
    q, ur0, _, dt = _rows()
    radius = lambda sub: np.abs(np.linalg.eigvals(TZ.linearize_zoh(
        _tf, t64(q[:1]), t64(ur0[:1]), t64(dt[:1]), 2, sub)[0][0].numpy())
    ).max()
    assert dt[0] == 0.2 and radius(1) > 2.0 and radius(16) < 1.001


def test_affine_horizon_matches():
    q, ur0, urf, dt = _rows()
    Mj, dim_j = JZ.linearize_affine_horizon(_jf, q, ur0, urf, dt, 2)
    Mt, dim_t = TZ.linearize_affine_horizon(_tf, t64(q), t64(ur0),
                                            t64(urf), t64(dt), 2)
    assert dim_t == dim_j == 19
    _close(Mt, Mj)
    # the exponential of the augmented matrices with the ramp block set,
    # as linearize_horizon_fused builds them
    Mt = Mt * t64(dt)[:, None, None]
    Mt[:, 6:12, 12:18] = t64(dt)[:, None, None] * torch.eye(6, dtype=F64)
    E = TZ.expm_fixed(Mt)
    ref = JZ.extract_affine_horizon(jnp.asarray(E.numpy()), dt, ur0, urf,
                                    6, 6, 2)
    out = TZ.extract_affine_horizon(E, t64(dt), t64(ur0), t64(urf), 6, 6, 2)
    for o, r in zip(out, ref):
        _close(o, r)


def test_float32_stays_float32():
    q, ur0, urf, dt = [torch.as_tensor(a, dtype=torch.float32)
                       for a in _rows()]
    outs = (TZ.linearize_zoh(_tf, q, ur0, dt, 2, 4)
            + TZ.linearize_foh(_tf, q, ur0, urf, dt, 2, 4)
            + (TZ.linearize_affine_horizon(_tf, q, ur0, urf, dt, 2)[0],))
    assert all(o.dtype == torch.float32 for o in outs)
