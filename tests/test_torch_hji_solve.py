"""The port's HJI value-iteration solver (`pigeon_tpu_torch.hji_solve`)
against the JAX package's, at float64 on small grids.

One sweep is held tightly: the port computes each sweep with the JAX
package's operations in its order, so on the same inputs it gives the
JAX function's own values.  Over many sweeps the 7-D values are held at
the JAX package's own physical bars: `hji.optimal_control`'s Fx line
search takes the first maximum, so a last-bit difference between two
correct programs flips near-ties and moves isolated cells by up to
~|f| dt (the JAX package's jitted sweep and its own op-by-op evaluation
already differ so, tests/test_hji_solve.py:100-133).  The pseudo-time
and update traces, which a wrong stencil or step would move at once,
are held tightly, and the smooth pursuit game (no argmax) to float64
roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigeon_tpu import hji as JH
from pigeon_tpu import hji_solve as JS
from pigeon_tpu.config import x1_params as jax_x1
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import hji_solve as TS
from pigeon_tpu_torch.config import x1_params

SMALL = (7, 7, 5, 5, 3, 3, 3)
EIGHT = (8, 7, 5, 5, 3, 3, 3)
# JAX's bars between two programs of the same sweep
# (tests/test_hji_solve.py): free-running CFL steps, and a fixed dt
FREE_BARS = (0.7, 2e-3)
FIXED_BARS = (0.05, 1e-3)


def _solve_both(**kw):
    """solve_hji of both packages at float64 on the CPU."""
    j = JS.solve_hji(jax_x1(), dtype=jnp.float64, **kw)
    t = TS.solve_hji(x1_params(), dtype=torch.float64, device="cpu", **kw)
    return t, j


def _hold(t, j, bars, times_rtol=1e-12):
    """Traces tight, values at `bars` (max, mean of |dV|)."""
    (ct, dt_, tt), (cj, dj, tj) = t, j
    assert len(tt) == len(tj)
    np.testing.assert_allclose(tt, np.asarray(tj), rtol=times_rtol, atol=0)
    np.testing.assert_allclose(dt_, np.asarray(dj), rtol=1e-4, atol=1e-4)
    assert ct.dims == tuple(cj.dims)
    for k_t, k_j in zip(ct.knots, cj.knots):
        np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    err = np.abs(ct.V.numpy() - np.asarray(cj.V))
    assert err.max() < bars[0], err.max()
    assert err.mean() < bars[1], err.mean()
    return err


def test_constants_match():
    assert TS.DEFAULT_BOUNDS == JS.DEFAULT_BOUNDS
    assert TS.DEFAULT_SHAPE == JS.DEFAULT_SHAPE
    assert TS.PROD_AXIS_ORDER == JS.PROD_AXIS_ORDER
    assert TS.PROTO_SHAPE == JS.PROTO_SHAPE


def test_collision_distance():
    x = np.random.default_rng(0).uniform(-40.0, 40.0, (6, 5, 7))
    np.testing.assert_allclose(
        TS.collision_distance(torch.as_tensor(x), 3.0).numpy(),
        np.asarray(JS.collision_distance(jnp.asarray(x), 3.0)),
        rtol=1e-15, atol=1e-14)


def _jax_flow(knots, fx_samples):
    """solve_hji's flow on the identity order, in the JAX package."""
    X = jnp.asarray(np.stack(np.meshgrid(*knots, indexing="ij"), -1))
    veh = jax_x1()

    def flow(start0, gradV):
        uR = JH.optimal_control(veh, X, gradV, "max", n_samples=fx_samples)
        uH = JH.optimal_disturbance(veh, X, gradV, "min")
        return JH.relative_dynamics(veh, X, uR, uH)
    return flow


@pytest.mark.parametrize("lf,horizon", [("local", None), ("global", 2.0)])
def test_sweep_body_tight(lf, horizon):
    """One sweep from a value grid below l (made from a seed) equals the
    JAX package's `_sweep_body` evaluated op by op, to 1e-12."""
    l, hs, flow, knots = TS.vehicle_problem(
        x1_params(), shape=SMALL, fx_samples=5, dtype=torch.float64,
        device="cpu")
    rng = np.random.default_rng(3)
    V0 = l.numpy() - rng.uniform(0.0, 0.5, l.shape)
    as64 = lambda x: torch.tensor(x, dtype=torch.float64)
    t_out = TS._sweep_body(torch.as_tensor(V0), l, as64(hs), flow,
                           as64(0.5), as64(-3.0), lf, horizon, as64(0.0))
    j_out = JS._sweep_body(jnp.asarray(V0), jnp.asarray(l.numpy()),
                           jnp.asarray(hs), _jax_flow(knots, 5), 0.5,
                           jnp.asarray(-3.0), lf, horizon, jnp.asarray(0.0))
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_slab_solve_op_by_op():
    """The slab form over several sweeps (alpha pass, lagged x0.9 CFL
    step, halo'd axis-0 differences) equals the JAX package's solve_hji
    evaluated op by op (`jax.disable_jit`): the same step trace, updates
    and values to 1e-12."""
    kw = dict(shape=(4, 5, 5, 3, 3, 3, 3), n_sweeps=2, fx_samples=3,
              slab_chunk=2, with_grad=False)
    with jax.disable_jit():
        cj, dj, tj = JS.solve_hji(jax_x1(), dtype=jnp.float64, **kw)
    ct, dt_, tt = TS.solve_hji(x1_params(), dtype=torch.float64,
                               device="cpu", **kw)
    np.testing.assert_allclose(tt, np.asarray(tj), rtol=1e-12, atol=0)
    np.testing.assert_allclose(dt_, np.asarray(dj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.V.numpy(), np.asarray(cj.V), rtol=0,
                               atol=1e-6)


def _pursuit(n, u_max, d_max, half=8.0, margin=1.0):
    l, hs = TS.pursuit_target((n, n), half, margin)
    speed = d_max - u_max

    def jflow(start0, gradV):
        nrm = jnp.maximum(jnp.linalg.norm(gradV, axis=-1, keepdims=True),
                          1e-12)
        return -speed * gradV / nrm

    exact = lambda T: (np.maximum(l + margin - max(speed, 0.0) * T, 0.0)
                       - margin)
    return l, hs, jflow, TS.pursuit_flow(speed), exact


@pytest.mark.parametrize("lf", ["local", "global"])
def test_solve_hji_vi_pursuit(lf):
    """The isotropic pursuit game (tests/test_hji_validation.py): the
    port equals the JAX solver to float64 roundoff, sweep by sweep, and
    lies within the JAX test's bars of the analytic value."""
    l, hs, jflow, tflow, exact = _pursuit(81, u_max=1.0, d_max=2.0)
    Vt, dt_, tt = TS.solve_hji_vi(torch.as_tensor(l), hs, tflow, 60, lf=lf)
    Vj, dj, tj = JS.solve_hji_vi(jnp.asarray(l), hs, jflow, 60, lf=lf)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-13)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), rtol=0,
                               atol=1e-12)
    h = hs[0]
    inner = np.zeros(l.shape, bool)
    inner[6:-6, 6:-6] = True
    err = np.abs(Vt.numpy() - exact(float(tt[-1])))[inner]
    assert err.max() < 4.0 * h and err.mean() < 1.0 * h


def test_solve_hji_whole_grid():
    """The whole-grid solve at free CFL steps: the same pseudo-time trace
    to 1e-12, the updates within JAX's sharded bars' trace tolerance and
    the values within the bars of two programs of one sweep; V below l
    and above the floor."""
    t, j = _solve_both(shape=SMALL, n_sweeps=30, fx_samples=5)
    _hold(t, j, FREE_BARS)
    cache = t[0]
    V = cache.V.numpy().reshape(cache.dims)
    X = np.stack(np.meshgrid(*[k.numpy() for k in cache.knots],
                             indexing="ij"), axis=-1)
    assert np.all(V <= np.hypot(X[..., 0], X[..., 1]) - 3.0 + 1e-4)
    assert V.min() >= -3.0 - 1e-5


def test_solve_hji_sweep_chunk_horizon():
    """sweep_chunk launches stop after the chunk that reaches the
    horizon: the same number of sweeps as JAX, the frozen sweeps' update
    exactly 0."""
    t, j = _solve_both(shape=SMALL, n_sweeps=200, fx_samples=5,
                       sweep_chunk=25, horizon_s=0.6)
    assert len(t[1]) == len(j[1]) < 200
    assert t[2][-1] >= 0.6 and t[1][-1] == 0.0
    _hold(t, j, FREE_BARS)


def test_solve_hji_slab_chunk():
    """slab_chunk=4 against JAX's jitted slab_chunk=4, V-only
    (with_grad=False), and against the port's whole-grid sweep, each at a
    fixed step below the CFL bounds (free lagged steps drift apart by
    O(dt |dV/dt|) once an argmax flip moves alpha, as the JAX package's
    slab test says; op by op the lagged trace is exact, above): the same
    time grid and the values within the slab bars."""
    kw = dict(shape=EIGHT, n_sweeps=20, fx_samples=5, dt_fixed=0.004,
              with_grad=False)
    t, j = _solve_both(slab_chunk=4, **kw)
    assert t[0].gradV is None and j[0].gradV is None
    _hold(t, j, FIXED_BARS)
    c_w, _, t_w = TS.solve_hji(x1_params(), dtype=torch.float64,
                               device="cpu", **kw)
    np.testing.assert_array_equal(t[2], t_w)
    err = np.abs(t[0].V.numpy() - c_w.V.numpy())
    assert err.max() < FIXED_BARS[0] and err.mean() < FIXED_BARS[1]


def test_solve_hji_axis_order():
    """axis_order=PROD_AXIS_ORDER with slab_chunk=1 (the production
    solve's form) against JAX's: a semantic cache, the same trace and
    the values at the slab bars."""
    kw = dict(shape=SMALL, n_sweeps=20, fx_samples=5, dt_fixed=0.004,
              axis_order=TS.PROD_AXIS_ORDER, slab_chunk=1)
    t, j = _solve_both(**kw)
    assert t[0].dims == SMALL
    _hold(t, j, FIXED_BARS)
    g_err = np.abs(t[0].gradV.numpy() - np.asarray(j[0].gradV))
    assert np.percentile(g_err, 99) < 0.1


def test_solved_cache_roundtrip(tmp_path):
    """A solved cache written by `save_cache` and read back by both
    packages' `load_cache` interpolates as the solved one."""
    cache, _, _ = TS.solve_hji(x1_params(), shape=SMALL, n_sweeps=10,
                               fx_samples=5, device="cpu")
    path = str(tmp_path / "hji_cache.npz")
    TS.save_cache(path, cache)
    back = TS.load_cache(path, device="cpu")
    np.testing.assert_array_equal(back.V.numpy(), cache.V.numpy())
    np.testing.assert_array_equal(back.gradV.numpy(), cache.gradV.numpy())
    jback = JS.load_cache(path)
    x = np.random.default_rng(5).uniform(
        [-40, -30, -3, 2, -2, 1, -1], [40, 30, 3, 17, 2, 17, 1], (64, 7))
    V1, g1 = TH.interpolate(cache, torch.as_tensor(x, dtype=torch.float32))
    V2, g2 = TH.interpolate(back, torch.as_tensor(x, dtype=torch.float32))
    np.testing.assert_array_equal(V2.numpy(), V1.numpy())
    np.testing.assert_array_equal(g2.numpy(), g1.numpy())
    Vj, gj = jax.vmap(lambda p: JH.interpolate(jback, p))(
        jnp.asarray(x, jnp.float32))
    scale = np.abs(cache.V.numpy()).max()
    np.testing.assert_allclose(V1.numpy(), np.asarray(Vj), rtol=0,
                               atol=1e-6 * scale)


def test_solve_hji_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.solve_hji(x1_params(), shape=SMALL, n_sweeps=1)


def test_mesh_and_slab_chunk_exclusive():
    with pytest.raises(ValueError):
        TS.solve_hji(x1_params(), shape=SMALL, n_sweeps=1, slab_chunk=1,
                     mesh=object(), device="cpu")
