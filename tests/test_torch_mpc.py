"""The slice as a whole: the port's `mpc_step_batched` on the CPU (plain
kernel versions, float64 outside the float32 solver) against the JAX
package's `mpc_step_batched` on the lane backend with bench.py's solver
options, one cold step then one warm step.

Commands agree within the solver-tolerance bar of tests/test_soft.py
(2e-4 rad on delta, 2.0 N on the forces); `converged` is equal; iteration
counts differ by at most one check period; the carries agree.

The HJI override ("hammer", `use_hji_policy`): the same two steps with an
active HJI row (the synthetic cache, the other car a few metres ahead,
head-on), on the fleet route and on the unbatched `mpc_step` and
`simulate`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (cache_arrays, carry_arrays, oval_fleet, t64,
                                tube_arrays)
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import CoupledControlParams as JCP
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import CoupledControlParams as TCP
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO

BENCH = dict(max_iter=150, check_every=150, eps_abs=1e-3, eps_rel=1e-3,
             backend="lanes", scaling_iters=2, pallas_check_inner=10)
F64 = torch.float64


def _case(name):
    """(horizon, JAX tube, q0, t0): the short horizon on the straight test
    path (tests/test_soft.py's fleet), the full horizon on the oval."""
    if name == "short":
        B = 3
        q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.0]
                       for i in range(B)])
        return (2, 3), JT.straight_trajectory(60.0, 5.0, pad_to=32), q0, \
            np.zeros(B)
    q0, t0, cols = oval_fleet(4, seed=8)
    return (5, 10), JT.make_tube(**cols, pad_to=1024), q0, t0


@pytest.fixture(scope="module", params=["short", "full"])
def steps(request):
    (S, Lg), jtube, q0, t0 = _case(request.param)
    B = q0.shape[0]
    u0 = np.zeros((B, 3))
    oc = np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)).copy()

    jcfg = dataclasses.replace(
        JM.x1_coupled_config(hz=JHP(N_short=S, N_long=Lg), soft=True),
        solver=JSO(**BENCH))
    jcache = JH.inactive_cache()
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    J = lambda a: jnp.asarray(a)
    # one jitted program for both steps (the batch-level cold/warm branch
    # is a lax.cond inside it); compiling once is ~2x faster on the CPU
    # than dispatching the step op by op
    jstep = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, q, u, J(oc), t))
    jc1, ju1, jd1 = jstep(jc, J(q0), J(u0), J(t0))
    jc2, ju2, jd2 = jstep(jc1, J(q0), ju1, J(t0) + 0.01)

    tcfg = dataclasses.replace(
        TM.x1_coupled_config(hz=THP(N_short=S, N_long=Lg), soft=True),
        solver=TSO(**BENCH))
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    tc1, tu1, td1 = TM.mpc_step_batched(tcfg, ttube, tcache, tc, t64(q0),
                                        t64(u0), t64(oc), t64(t0))
    tc2, tu2, td2 = TM.mpc_step_batched(tcfg, ttube, tcache, tc1, t64(q0),
                                        tu1, t64(oc), t64(t0) + 0.01)
    return dict(jax=[(jc1, ju1, jd1), (jc2, ju2, jd2)],
                port=[(tc1, tu1, td1), (tc2, tu2, td2)])


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_commands_match(steps, k):
    ju = np.asarray(steps["jax"][k][1])
    tu = steps["port"][k][1].numpy()
    assert np.all(np.isfinite(tu))
    d = np.abs(ju - tu)
    assert d[:, 0].max() < 2e-4, d
    assert d[:, 1:].max() < 2.0, d


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_diagnostics_match(steps, k):
    jd, td = steps["jax"][k][2], steps["port"][k][2]
    np.testing.assert_array_equal(td.converged.numpy(),
                                  np.asarray(jd.converged))
    assert np.abs(td.iterations.numpy()
                  - np.asarray(jd.iterations)).max() <= 10
    assert td.solution_finite.numpy().all()
    np.testing.assert_allclose(td.s.numpy(), np.asarray(jd.s), rtol=1e-10)
    np.testing.assert_allclose(td.e.numpy(), np.asarray(jd.e), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_carry_matches(steps, k):
    jc, tc = steps["jax"][k][0], steps["port"][k][0]
    # q_prev is the rollout G x + g over the horizon of a float32 solver
    # iterate x that agrees to ~1e-5 (tests/test_torch_lane_admm.py); over
    # the full 15-stage horizon it agrees to ~4e-5
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-4)
    np.testing.assert_allclose(tc.prev_ts.numpy(), np.asarray(jc.prev_ts),
                               rtol=1e-12)
    np.testing.assert_array_equal(tc.solved.numpy(), np.asarray(jc.solved))
    # the JAX carry carried over through convert: same fields, values and
    # shapes as the port's carry
    cc = convert.carry_from_numpy(carry_arrays(jc), device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jc, name)))


@pytest.mark.parametrize("change,m", [
    pytest.param(dict(lin_substeps=2), 124, id="lin_substeps"),
    pytest.param(dict(coupled=TCP(use_walls=True)), 139, id="walls"),
    pytest.param(dict(lin_method="rk4"), 124, id="lin_method"),
    pytest.param(dict(formulation="decoupled", soft=False,
                      hz=THP(N_short=10, N_long=20)), 395,
                 id="decoupled_hard"),
    pytest.param(dict(formulation="lateral"), None,
                 id="unknown_formulation")])
def test_unported_options_raise(change, m):
    """Only an unknown formulation raises: every option the JAX package
    takes gives a carry of the JAX carry's shapes, with m warm rows (the
    soft coupled QP's 124, 139 with the wall rows; the sparse decoupled
    QP's 395)."""
    cfg = dataclasses.replace(TM.x1_coupled_config(soft=True), **change)
    if m is None:
        with pytest.raises(NotImplementedError):
            TM.init_carry(cfg, 2, device="cpu")
        return
    jchange = dict(change)
    if "coupled" in change:
        jchange["coupled"] = JCP(use_walls=True)
    if "hz" in change:
        jchange["hz"] = JHP(N_short=10, N_long=20)
    jcfg = dataclasses.replace(JM.x1_coupled_config(soft=True), **jchange)
    jc = JM.init_carry(jcfg, dtype=jnp.float64)
    carry = TM.init_carry(cfg, 2, device="cpu")
    for name in TM.MPCCarry._fields:
        assert getattr(carry, name).shape == (2,) + getattr(jc, name).shape
    assert carry.warm_y.shape == (2, m)


def test_sim_substeps_is_supported():
    cfg = dataclasses.replace(TM.x1_coupled_config(soft=True), sim_substeps=2)
    assert TM.init_carry(cfg, 2, device="cpu").q_prev.shape == (2, 16, 6)


# ---------------------------------------------------------------------------
# The HJI override
# ---------------------------------------------------------------------------

def _hammer_case():
    """The short-horizon fleet of tests/test_soft.py on the straight path;
    vehicles 0 and 1 with the other car 4 m ahead, head-on (inside the
    synthetic grid, V < 0), vehicle 2 with it 30 m ahead (outside the
    grid, V = inf, never overridden)."""
    q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.0]
                   for i in range(3)])
    oc = np.array([[0.0, 4.0, np.pi, 8.0], [0.7, 4.3, np.pi, 6.0],
                   [0.4, 30.6, np.pi, 8.0]])
    return q0, oc


@pytest.fixture(scope="module")
def hammer_steps():
    q0, oc = _hammer_case()
    B = q0.shape[0]
    u0, t0 = np.zeros((B, 3)), np.zeros(B)
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    jcache = JH.synthetic_cache(5)
    jcfg = dataclasses.replace(
        JM.x1_coupled_config(hz=JHP(N_short=2, N_long=3), soft=True),
        solver=JSO(**BENCH), use_hji_policy=True)
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    J = lambda a: jnp.asarray(a)
    jstep = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, q, u, J(oc), t))
    jc1, ju1, jd1 = jstep(jc, J(q0), J(u0), J(t0))
    jc2, ju2, jd2 = jstep(jc1, J(q0), ju1, J(t0) + 0.01)

    tcfg = dataclasses.replace(
        TM.x1_coupled_config(hz=THP(N_short=2, N_long=3), soft=True),
        solver=TSO(**BENCH), use_hji_policy=True)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    tc1, tu1, td1 = TM.mpc_step_batched(tcfg, ttube, tcache, tc, t64(q0),
                                        t64(u0), t64(oc), t64(t0))
    tc2, tu2, td2 = TM.mpc_step_batched(tcfg, ttube, tcache, tc1, t64(q0),
                                        tu1, t64(oc), t64(t0) + 0.01)
    return dict(jax=[(jc1, ju1, jd1), (jc2, ju2, jd2)],
                port=[(tc1, tu1, td1), (tc2, tu2, td2)])


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_override_commands_match(hammer_steps, k):
    ju = np.asarray(hammer_steps["jax"][k][1])
    tu = hammer_steps["port"][k][1].numpy()
    assert np.all(np.isfinite(tu))
    d = np.abs(ju - tu)
    assert d[:, 0].max() < 2e-4, d
    assert d[:, 1:].max() < 2.0, d
    # the overridden vehicles steer at the limit
    np.testing.assert_allclose(np.abs(tu[:2, 0]),
                               TM.x1_params().delta_max, rtol=1e-12)


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_override_flags_match(hammer_steps, k):
    (jc, _, jd), (tc, _, td) = hammer_steps["jax"][k], hammer_steps["port"][k]
    active = td.hji_active.numpy()
    np.testing.assert_array_equal(active, np.asarray(jd.hji_active))
    np.testing.assert_array_equal(active, [True, True, False])
    # an applied override leaves the carry unsolved (cold next step); the
    # vehicle it did not touch stays warm
    np.testing.assert_array_equal(tc.solved.numpy(), np.asarray(jc.solved))
    np.testing.assert_array_equal(tc.solved.numpy(), ~active)
    np.testing.assert_allclose(td.V_hji.numpy(), np.asarray(jd.V_hji),
                               rtol=1e-6)


def test_hammer_unbatched(x1):
    """tests/test_modes.py's hammer case on the port's unbatched
    `mpc_step` (the sparse coupled QP, as it comes): with the override the
    command's steering is the HJI optimal control's, at the steering
    limit; without it the QP's command is not at the limit."""
    jtube = JT.straight_trajectory(60.0, 8.0, pad_to=32)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    jcache = JH.synthetic_cache(5)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    q0 = np.array([0.0, 0.0, 0.0, 8.0, 0.0, 0.0])
    oc = np.array([0.0, 4.0, np.pi, 8.0])

    def run(policy):
        cfg = TM.x1_coupled_config(use_hji_policy=policy)
        carry = TM.init_carry(cfg, None, dtype=F64, device="cpu")
        return TM.mpc_step(cfg, ttube, tcache, carry, t64(q0),
                           torch.zeros(3, dtype=F64), t64(oc), 0.0)

    _, u_plain, _ = run(False)
    c_hammer, u_hammer, d_hammer = run(True)
    assert bool(d_hammer.hji_active) and not bool(c_hammer.solved)
    x_rel = JH.relative_state(jnp.asarray(q0), jnp.asarray(oc))
    _, g = JH.interpolate(jcache, x_rel)
    u_opt = np.asarray(JH.optimal_control(x1, x_rel, g.astype(jnp.float64)))
    np.testing.assert_allclose(float(u_hammer[0]), u_opt[0], atol=1e-9)
    assert abs(float(u_hammer[0])) == pytest.approx(x1.delta_max)
    assert abs(float(u_plain[0])) < x1.delta_max - 1e-3


def test_hammer_simulate():
    """`simulate` with the override on, five steps against a parked car 6
    m ahead, head-on: the JAX package's commands (the bar of
    tests/test_soft.py), states and filter flags."""
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    jcache = JH.synthetic_cache(5)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    q0 = np.array([0.1, 0.2, 0.01, 5.0, 0.0, 0.0])
    oc = np.array([0.3, 6.0, np.pi, 0.0])
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=2, N_long=3), soft=True,
                                use_hji_policy=True)
    tcfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3), soft=True,
                                use_hji_policy=True)
    jlog = jax.jit(lambda q: JM.simulate(jcfg, jtube, jcache, q,
                                         other_car=jnp.asarray(oc),
                                         n_steps=5))(jnp.asarray(q0))
    tlog = TM.simulate(tcfg, ttube, tcache, t64(q0), other_car=oc,
                       n_steps=5, device="cpu")
    active = tlog.diag.hji_active.numpy()
    np.testing.assert_array_equal(active, np.asarray(jlog.diag.hji_active))
    assert active[1:].all()
    d = np.abs(tlog.u.numpy() - np.asarray(jlog.u))
    assert d[:, 0].max() < 2e-4, d
    assert d[:, 1:].max() < 2.0, d
    np.testing.assert_allclose(tlog.q.numpy(), np.asarray(jlog.q),
                               rtol=1e-9, atol=1e-7)
