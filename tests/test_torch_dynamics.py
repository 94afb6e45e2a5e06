"""pigeon_tpu_torch.dynamics against pigeon_tpu.dynamics at float64: ODE
values and forward-mode Jacobians, the trim estimator, the stability
envelope, and the stop-gradient of the power clamp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t64
from pigeon_tpu import dynamics as JD
from pigeon_tpu.config import x1_params
from pigeon_tpu_torch import discretize as TZ
from pigeon_tpu_torch import dynamics as TD

VEH = x1_params()
RTOL, ATOL = 1e-10, 1e-12


def _states(model, K=16, seed=0):
    """K random (q, u2, p4) rows around realistic operating points,
    including saturated tires, braking and power-limited speeds."""
    rng = np.random.default_rng(seed)
    Ux = rng.uniform(2.0, 20.0, K)
    Uy = rng.uniform(-1.5, 1.5, K)
    r = rng.uniform(-0.8, 0.8, K)
    if model == "tracking":
        q = np.stack([rng.uniform(-2, 2, K), Ux, Uy, r,
                      rng.uniform(-0.3, 0.3, K), rng.uniform(-1, 1, K)], 1)
        p = np.stack([rng.uniform(3, 12, K), rng.uniform(-0.08, 0.08, K),
                      np.zeros(K), np.zeros(K)], 1)
    elif model == "bicycle":
        q = np.stack([rng.uniform(-50, 50, K), rng.uniform(-50, 50, K),
                      rng.uniform(-3, 3, K), Ux, Uy, r], 1)
        p = np.zeros((K, 4))
    else:
        q = np.stack([Uy, r, rng.uniform(-0.3, 0.3, K),
                      rng.uniform(-1, 1, K)], 1)
        p = np.stack([Ux, rng.uniform(-0.08, 0.08, K), np.zeros(K),
                      np.zeros(K)], 1)
    u2 = np.stack([rng.uniform(-0.35, 0.35, K),
                   rng.uniform(-12000.0, 8000.0, K)], 1)
    return q, u2, p


@pytest.mark.parametrize("model", ["tracking", "bicycle", "lateral"])
def test_vehicle_ode_values_and_jacobians(model):
    q, u2, p = _states(model)
    ur = np.concatenate([u2, p], axis=1)

    def jf(q_, ur_):
        return JD.vehicle_ode(VEH, model, q_, ur_[:2], ur_[2:])

    def tf(q_, ur_):
        return TD.vehicle_ode(VEH, model, q_, ur_[..., :2], ur_[..., 2:])

    ref = np.asarray(jax.vmap(jf)(jnp.asarray(q), jnp.asarray(ur)))
    out = tf(t64(q), t64(ur)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    Jq_ref = np.asarray(jax.vmap(jax.jacfwd(jf, 0))(jnp.asarray(q),
                                                    jnp.asarray(ur)))
    Ju_ref = np.asarray(jax.vmap(jax.jacfwd(jf, 1))(jnp.asarray(q),
                                                    jnp.asarray(ur)))
    # per-instance jacfwd under vmap, and the batched form the
    # linearization uses
    Jq, Ju = torch.func.vmap(torch.func.jacfwd(tf, argnums=(0, 1)))(
        t64(q), t64(ur))
    np.testing.assert_allclose(Jq.numpy(), Jq_ref, rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(Ju.numpy(), Ju_ref, rtol=RTOL, atol=1e-9)
    Jq_b, Ju_b = TZ.batched_jacobians(tf, t64(q), t64(ur))
    np.testing.assert_allclose(Jq_b.numpy(), Jq_ref, rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(Ju_b.numpy(), Ju_ref, rtol=RTOL, atol=1e-9)


def test_batched_jacobians_keep_float32():
    q, u2, p = _states("tracking", K=4)
    ur = np.concatenate([u2, p], axis=1)

    def tf(q_, ur_):
        return TD.vehicle_ode(VEH, "tracking", q_, ur_[..., :2], ur_[..., 2:])

    Jq, Ju = TZ.batched_jacobians(tf, t64(q).float(), t64(ur).float())
    assert Jq.dtype == torch.float32 and Ju.dtype == torch.float32


def test_power_clamp_has_no_speed_derivative():
    """At Ux = 20 m/s the power limit Px_max/Ux (3750 N) binds: the clamp
    must contribute no dFx/dUx, as the JAX stop_gradient."""
    u2 = np.array([0.05, 5000.0])
    Ux = 20.0
    J = torch.func.jacfwd(
        lambda ux: TD.apply_control_limits(VEH, t64(u2), ux))(t64(Ux))
    Jj = jax.jacfwd(
        lambda ux: JD.apply_control_limits(VEH, jnp.asarray(u2), ux))(Ux)
    assert float(TD.apply_control_limits(VEH, t64(u2), t64(Ux))[1]) == \
        pytest.approx(VEH.Px_max / Ux)
    np.testing.assert_array_equal(J.numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(Jj), 0.0)
    # and through the tracking ODE: dFx/dUx enters qdot[1] only via drag
    q = t64([0.0, Ux, 0.1, 0.05, 0.02, 0.1])
    ur = t64([0.05, 5000.0, 8.0, 0.02, 0.0, 0.0])
    Jq = torch.func.jacfwd(lambda q_: TD.vehicle_ode(
        VEH, "tracking", q_, ur[:2], ur[2:]))(q)
    Jq_ref = jax.jacfwd(lambda q_: JD.vehicle_ode(
        VEH, "tracking", q_, jnp.asarray(ur.numpy()[:2]),
        jnp.asarray(ur.numpy()[2:])))(jnp.asarray(q.numpy()))
    np.testing.assert_allclose(Jq.numpy(), np.asarray(Jq_ref), rtol=RTOL,
                               atol=1e-9)


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("corrected", [True, False])
def test_steady_state_estimates(iters, corrected):
    rng = np.random.default_rng(1)
    K = 32
    V = rng.uniform(1.0, 16.0, K)
    A = rng.uniform(-6.0, 4.0, K)
    # The reference tire inverse (corrected=False) jumps between its
    # saturated and unsaturated branches where a tire saturates, so there a
    # last-bit difference in sin/cos picks the other branch; its inputs stay
    # inside the friction circle (V^2 kappa < 0.6 mu G).  The corrected
    # inverse is continuous there and is tested up to full saturation.
    k_max = 0.2 if corrected else 0.6 * VEH.mu * VEH.G / 16.0 ** 2
    kappa = rng.uniform(-k_max, k_max, K)
    kw = {}
    if iters == 1:
        kw = dict(r=rng.uniform(-0.5, 0.5, K), beta0=rng.uniform(-0.1, 0.1, K),
                  delta0=rng.uniform(-0.1, 0.1, K),
                  Fyf0=rng.uniform(-3000, 3000, K))
    ref = JD.steady_state_estimates(
        VEH, jnp.asarray(V), jnp.asarray(A), jnp.asarray(kappa),
        num_iters=iters, corrected_tire_inverse=corrected,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    out = TD.steady_state_estimates(
        VEH, t64(V), t64(A), t64(kappa), num_iters=iters,
        corrected_tire_inverse=corrected, **{k: t64(v) for k, v in kw.items()})
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=1e-9, err_msg=name)


def test_fiala_and_inverse():
    """The coupled-slip Fiala model and its inverse against JAX, inside and
    beyond the friction circle, and the round trip below full slide."""
    rng = np.random.default_rng(3)
    K = 64
    alpha = rng.uniform(-0.2, 0.2, K)
    Fz = np.full(K, 5500.0)
    Fx = rng.uniform(-1.1, 1.1, K) * VEH.mu * Fz
    args = (VEH.Caf, VEH.mu)
    Fy = TD.fiala_tire_model(t64(alpha), *args, t64(Fx), t64(Fz))
    Fy_ref = JD.fiala_tire_model(jnp.asarray(alpha), *args, jnp.asarray(Fx),
                                 jnp.asarray(Fz))
    np.testing.assert_allclose(Fy.numpy(), np.asarray(Fy_ref), rtol=RTOL,
                               atol=ATOL)
    back = TD.inv_fiala_tire_model(Fy, *args, t64(Fx), t64(Fz))
    back_ref = JD.inv_fiala_tire_model(Fy_ref, *args, jnp.asarray(Fx),
                                       jnp.asarray(Fz))
    np.testing.assert_allclose(back.numpy(), np.asarray(back_ref), rtol=RTOL,
                               atol=ATOL)
    Fy_max = np.sqrt(np.maximum((VEH.mu * Fz) ** 2 - Fx ** 2, 1e-9))
    gripping = (np.abs(Fx) < VEH.mu * Fz) & (
        np.abs(np.tan(alpha)) < 3 * Fy_max / VEH.Caf)
    assert gripping.sum() > K // 4
    np.testing.assert_allclose(back.numpy()[gripping], alpha[gripping],
                               atol=1e-9)


def test_stable_limits_and_split():
    rng = np.random.default_rng(2)
    K = 32
    Ux = rng.uniform(1.0, 20.0, K)
    Fx = rng.uniform(-15000.0, 8000.0, K)
    jf = JD.longitudinal_split(VEH, jnp.asarray(Fx))
    tf = TD.longitudinal_split(VEH, t64(Fx))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    ref = JD.stable_limits(VEH, jnp.asarray(Ux), *jf)
    out = TD.stable_limits(VEH, t64(Ux), *tf)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=1e-12, err_msg=name)
