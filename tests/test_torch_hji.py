"""pigeon_tpu_torch.hji against pigeon_tpu.hji: the 128-corner 7-D
interpolation inside and outside a numpy-built grid, the relative state
and dynamics, optimal disturbance and control, and the reachability
half-plane with an active and an inactive value function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import cache_arrays, t64
from pigeon_tpu import hji as JH
from pigeon_tpu.config import x1_params
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import hji as TH

VEH = x1_params()
# the value grid is float32 in both packages; the two sum its 128 corner
# weights in different orders
RTOL32, ATOL32 = 2e-6, 1e-6


def _grid(offset, seed=0):
    rng = np.random.default_rng(seed)
    knots = [np.linspace(-20, 20, 4), np.linspace(-20, 20, 4),
             np.linspace(-np.pi, np.pi, 3), np.linspace(1, 20, 3),
             np.linspace(-3, 3, 3), np.linspace(0, 20, 3),
             np.linspace(-1.5, 1.5, 3)]
    dims = tuple(len(k) for k in knots)
    V = rng.uniform(-1.0, 1.0, dims) + offset
    G = rng.uniform(-2.0, 2.0, dims + (7,))
    return knots, V, G


def _points(K=40, seed=1):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-22, 22, K), rng.uniform(-22, 22, K),
                  rng.uniform(-3.2, 3.2, K), rng.uniform(2, 19, K),
                  rng.uniform(-2.5, 2.5, K), rng.uniform(1, 19, K),
                  rng.uniform(-1.4, 1.4, K)], axis=1)
    return x


@pytest.fixture(scope="module")
def caches():
    out = {}
    for name, offset in (("active", -0.5), ("inactive", 5.0)):
        knots, V, G = _grid(offset)
        out[name] = (JH.make_cache(knots, V, G),
                     TH.make_cache(knots, V, G, device="cpu"))
    return out


def test_interpolate_inside_and_outside(caches):
    jc, tc = caches["active"]
    x = _points()
    Vr, gr = jax.vmap(lambda p: JH.interpolate(jc, p))(jnp.asarray(x))
    V, g = TH.interpolate(tc, t64(x))
    assert np.isinf(np.asarray(Vr)).any() and np.isfinite(
        np.asarray(Vr)).any(), "test points must fall on both sides"
    np.testing.assert_allclose(V.numpy(), np.asarray(Vr), rtol=RTOL32,
                               atol=ATOL32)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=RTOL32,
                               atol=ATOL32)
    # the JAX cache carried over through convert interpolates the same
    cc = convert.cache_from_numpy(cache_arrays(jc), device="cpu")
    V2, g2 = TH.interpolate(cc, t64(x))
    np.testing.assert_array_equal(V2.numpy(), V.numpy())
    np.testing.assert_array_equal(g2.numpy(), g.numpy())


def test_relative_state_dynamics_and_disturbance():
    rng = np.random.default_rng(2)
    K = 24
    ego = np.stack([rng.uniform(-10, 10, K), rng.uniform(-10, 10, K),
                    rng.uniform(-3, 3, K), rng.uniform(2, 15, K),
                    rng.uniform(-1, 1, K), rng.uniform(-0.5, 0.5, K)], 1)
    them = np.stack([rng.uniform(-10, 10, K), rng.uniform(-10, 10, K),
                     rng.uniform(-3, 3, K), rng.uniform(0, 15, K)], 1)
    x7r = JH.relative_state(jnp.asarray(ego), jnp.asarray(them))
    x7 = TH.relative_state(t64(ego), t64(them))
    np.testing.assert_allclose(x7.numpy(), np.asarray(x7r), rtol=1e-10,
                               atol=1e-12)
    grad = rng.uniform(-2, 2, (K, 7))
    grad[:3] = 0.0                                   # lam_norm < 1e-3
    uHr = JH.optimal_disturbance(VEH, x7r, jnp.asarray(grad))
    uH = TH.optimal_disturbance(VEH, x7, t64(grad))
    np.testing.assert_allclose(uH.numpy(), np.asarray(uHr), rtol=1e-10,
                               atol=1e-12)
    uR = np.stack([rng.uniform(-0.3, 0.3, K), rng.uniform(-8e3, 5e3, K)], 1)
    fr = JH.relative_dynamics(VEH, x7r, jnp.asarray(uR), uHr)
    f = TH.relative_dynamics(VEH, x7, t64(uR), uH)
    np.testing.assert_allclose(f.numpy(), np.asarray(fr), rtol=1e-10,
                               atol=1e-9)
    ucr = JH.optimal_control(VEH, x7r, jnp.asarray(grad))
    uc = TH.optimal_control(VEH, x7, t64(grad))
    np.testing.assert_allclose(uc.numpy(), np.asarray(ucr), rtol=1e-10,
                               atol=1e-9)


@pytest.mark.parametrize("which", ["active", "inactive"])
def test_reachability_constraint(caches, which):
    jc, tc = caches[which]
    x = _points(seed=3)
    rng = np.random.default_rng(4)
    u_lin = np.stack([rng.uniform(-0.3, 0.3, len(x)),
                      rng.uniform(-6e3, 5e3, len(x))], 1)
    ref = jax.vmap(lambda p, u: JH.reachability_constraint(
        VEH, jc, p, 0.05, u))(jnp.asarray(x), jnp.asarray(u_lin))
    out = TH.reachability_constraint(VEH, tc, t64(x), 0.05, t64(u_lin))
    active = np.asarray(ref[2]) <= 0.05
    if which == "active":
        assert active.sum() >= 5
    else:
        assert not active.any()
    for o, r, name in zip(out, ref, ("M", "b", "V", "gradV")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-5, err_msg=name)
