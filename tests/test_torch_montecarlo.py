"""The `dynamic_obstacle` Monte-Carlo of the port against the JAX
package on the CPU, at float64 outside the float32 solver: scenario
sampling, the avoidability certificate, the batched closed-loop
controller (`parallel.mesh.BatchedController`) and `run_dynamic_obstacle`
with the HJI filter and its override on, on the lane backend with
scripts/exp_safety_ab.py's solver options.

Commands of a step from the same state agree within the
solver-tolerance bar of tests/test_soft.py (2e-4 rad on delta, 2.0 N on
the forces)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, carry_arrays, t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import montecarlo as JMC
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.config import x1_params as jx1
from pigeon_tpu.parallel.mesh import BatchState as JBatchState
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import montecarlo as TMC
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.config import x1_params as tx1
from pigeon_tpu_torch.parallel.mesh import BatchedController, BatchState

F64 = torch.float64
# scripts/exp_safety_ab.py's solver: 12 segments of 50 iterations
SAFETY_AB = dict(max_iter=600, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
                 backend="lanes", scaling_iters=2, pallas_check_inner=10)
N_STEPS = 5


@pytest.fixture(scope="module")
def oval():
    jtube = JT.make_tube(**TT.oval_columns(), pad_to=1024)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    return jtube, ttube


def _scenarios(oval, B, **kw):
    jtube, ttube = oval
    return (JMC.sample_scenarios(jtube, B, dtype=jnp.float64, **kw),
            TMC.sample_scenarios(ttube, B, dtype=F64, **kw))


def test_sample_scenarios(oval):
    js, ts = _scenarios(oval, 8, seed=0)
    for name in JMC.ScenarioSet._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)
        assert b.dtype == F64 and tuple(b.shape) == a.shape, name
        np.testing.assert_array_equal(b.numpy(), a)
    d0 = np.hypot(*(ts.q0[:, :2] - ts.other0[:, :2]).numpy().T)
    assert np.all(d0 > 10.0)
    cs = convert.scenarios_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu",
        dtype=F64)
    for a, b in zip(cs, ts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_certify_avoidable(oval):
    """Four near starts (the other car 5-12 m ahead), 50 steps of the 9
    policies: the same certificate, the best policy's separation within
    1e-9 m."""
    js, ts = _scenarios(oval, 4, seed=3, oncoming_gap=(5.0, 12.0),
                        oncoming_lateral=(-1.0, 1.0))
    jm, jb = JMC.certify_avoidable(jx1(), js, n_steps=50)
    tm, tb = TMC.certify_avoidable(tx1(), ts, n_steps=50)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.any() and not tm.all()
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-9)


def _recording(cls, rollouts, steps=None):
    """A subclass of the controller class `cls` that records what its
    `rollout` returns and, if `steps` is a list, each `step`'s arguments
    and results."""
    class Recording(cls):
        def step(self, state, other_car=None, t=0.0):
            out = super().step(state, other_car, t)
            if steps is not None:
                steps.append(((state, other_car, t), out))
            return out

        def rollout(self, *a, **kw):
            out = super().rollout(*a, **kw)
            rollouts.append(out)
            return out
    return Recording


@pytest.fixture(scope="module")
def mc_runs(oval):
    """`run_dynamic_obstacle` in both packages on four scenarios (seed 0,
    the other car 6-24 m ahead: one scenario's start is unsafe at eps
    1.5, one lies outside the grid), five steps, the synthetic cache,
    the override on; with the rollout logs of each run, and the JAX
    package's step from each state the port's rollout stepped from."""
    jtube, ttube = oval
    js, ts = _scenarios(oval, 4, seed=0, oncoming_gap=(6.0, 24.0),
                        oncoming_lateral=(-1.0, 1.0))
    jcache = JH.synthetic_cache(5)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    jcfg = dataclasses.replace(JM.x1_coupled_config(soft=True),
                               solver=JSO(**SAFETY_AB), use_hji_policy=True,
                               hji_eps=1.5)
    tcfg = dataclasses.replace(TM.x1_coupled_config(soft=True),
                               solver=TSO(**SAFETY_AB), use_hji_policy=True,
                               hji_eps=1.5)
    jlogs, tlogs, tsteps = [], [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JMC, "BatchedController",
                   _recording(JMC.BatchedController, jlogs))
        mp.setattr(TMC, "BatchedController",
                   _recording(BatchedController, tlogs, tsteps))
        jsum, jper = JMC.run_dynamic_obstacle(jcfg, jtube, jcache, js,
                                              n_steps=N_STEPS,
                                              per_scenario=True)
        tsum, tper = TMC.run_dynamic_obstacle(tcfg, ttube, tcache, ts,
                                              n_steps=N_STEPS,
                                              per_scenario=True)
    finally:
        mp.undo()
    jctrl = JMC.BatchedController(jcfg, jtube, jcache)
    J = lambda v: jnp.asarray(v.numpy())
    forced = []
    for (st, oc, t), _ in tsteps:
        jst = JBatchState(carry=JM.MPCCarry(*[J(x) for x in st.carry]),
                          q=J(st.q), u=J(st.u))
        forced.append(jctrl.step(jst, J(oc), J(t)))
    return dict(jax=(jsum, jper, jlogs[0]), port=(tsum, tper, tlogs[0]),
                port_steps=[out for _, out in tsteps], jax_steps=forced)


def test_dynamic_obstacle_steps(mc_runs):
    """Each step of the port's rollout against the JAX package's step
    from the same state: the commands within the bar, the same filter
    flags, convergence and warm-start flags, iterations within one
    segment.  (The float32
    solve's iteration count, and with it a weakly determined command, is
    sensitive to perturbations of the state at the level of the two
    packages' rounding, in the JAX package as in the port, so free-running
    rollouts are held to the bar only where their inputs are equal.)"""
    assert len(mc_runs["port_steps"]) == N_STEPS
    for k, ((tst, td), (jst, jd)) in enumerate(zip(mc_runs["port_steps"],
                                                   mc_runs["jax_steps"])):
        d = np.abs(tst.u.numpy() - np.asarray(jst.u))
        assert d[:, 0].max() < 2e-4, (k, d)
        assert d[:, 1:].max() < 2.0, (k, d)
        np.testing.assert_array_equal(td.hji_active.numpy(),
                                      np.asarray(jd.hji_active))
        np.testing.assert_array_equal(td.converged.numpy(),
                                      np.asarray(jd.converged))
        # twelve segments with adaptive-rho refactors: rounding may move
        # the group's exit by up to one segment
        assert np.abs(td.iterations.numpy()
                      - np.asarray(jd.iterations)).max() <= 50, k
        np.testing.assert_array_equal(tst.carry.solved.numpy(),
                                      np.asarray(jst.carry.solved))
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q),
                                   rtol=0, atol=1e-12)


def test_dynamic_obstacle_logs(mc_runs):
    """The two packages' free-running rollouts: the same filter flags and
    convergence; the overridden commands at the same steering limit;
    states within 1e-4 (commands within the bar move a car by far less
    in five steps); the same final warm-start flags."""
    jsum, jper, (jst, (jq, ju, joc, jd)) = mc_runs["jax"]
    tsum, tper, (tst, (tq, tu, toc, td)) = mc_runs["port"]
    assert tu.shape == (N_STEPS, 4, 3) and tq.shape == (N_STEPS, 4, 6)
    active = td.hji_active.numpy()
    np.testing.assert_array_equal(active, np.asarray(jd.hji_active))
    # one scenario overridden on every step, the others never
    np.testing.assert_array_equal(active.any(axis=0), active.all(axis=0))
    assert 0 < active[0].sum() < 4
    np.testing.assert_array_equal(tu.numpy()[active][:, 0],
                                  np.asarray(ju)[active][:, 0])
    np.testing.assert_allclose(np.abs(tu.numpy()[active][:, 0]),
                               tx1().delta_max, rtol=1e-12)
    d = np.abs(tu.numpy()[0] - np.asarray(ju)[0])     # the same inputs
    assert d[:, 0].max() < 2e-4 and d[:, 1:].max() < 2.0, d
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-4)
    np.testing.assert_allclose(toc.numpy(), np.asarray(joc), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(td.converged.numpy(),
                                  np.asarray(jd.converged))
    np.testing.assert_allclose(td.V_hji.numpy(), np.asarray(jd.V_hji),
                               rtol=1e-5)
    # the final carries: overridden scenarios unsolved (cold next step)
    np.testing.assert_array_equal(tst.carry.solved.numpy(),
                                  np.asarray(jst.carry.solved))
    np.testing.assert_array_equal(tst.carry.solved.numpy(), ~active[-1])
    cs = convert.batch_state_from_numpy(
        dict(carry=carry_arrays(jst.carry), q=np.asarray(jst.q),
             u=np.asarray(jst.u)), device="cpu", dtype=F64)
    assert isinstance(cs, BatchState)
    for a, b in zip(cs.carry, tst.carry):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_dynamic_obstacle_summary(mc_runs):
    jsum, jper = mc_runs["jax"][:2]
    tsum, tper = mc_runs["port"][:2]
    assert (tsum.n_scenarios, tsum.n_steps) == (4, N_STEPS)
    for name in ("collision_frac", "hji_active_frac", "converged_frac",
                 "controls_finite"):
        assert getattr(tsum, name) == getattr(jsum, name), name
    for name in ("min_separation_m", "tracking_e_p50", "tracking_e_p99"):
        assert abs(getattr(tsum, name) - getattr(jsum, name)) < 1e-4, name
    np.testing.assert_allclose(tper.min_separation_m.numpy(),
                               np.asarray(jper.min_separation_m), atol=1e-4)
    for name in ("collided", "converged_frac", "hji_active_frac"):
        np.testing.assert_array_equal(getattr(tper, name).numpy(),
                                      np.asarray(getattr(jper, name)))
    np.testing.assert_allclose(tper.V_min.numpy(), np.asarray(jper.V_min),
                               rtol=1e-5)


def test_percentile_matches_jnp():
    x = np.random.default_rng(4).standard_normal((7, 13))
    for p in (0, 37.5, 50, 99, 100):
        assert TMC.percentile(t64(x), p) == pytest.approx(
            float(jnp.percentile(jnp.asarray(x), p)), rel=1e-14)
    x[2, 3] = np.nan
    assert np.isnan(TMC.percentile(t64(x), 50))


def test_rollout_per_scenario_t0():
    """tests/test_montecarlo.py's case on the port: two identical states
    at different path times see different Delta-s in the coupled Q_ds
    objective; the one ahead of its schedule brakes."""
    cfg = TM.x1_coupled_config()
    tube = TT.straight_trajectory(200.0, 6.0, pad_to=64, device="cpu",
                                  dtype=F64)
    ctrl = BatchedController(cfg, tube)
    state = ctrl.init_state(t64([[0.0, 60.0, 0.0, 6.0, 0.0, 0.0]] * 2))
    state, (q_log, u_log, oc_log, diag) = ctrl.rollout(
        state, 5, t0=t64([10.0, 0.0]))
    u = u_log.numpy()
    assert np.all(np.isfinite(u))
    Fx = u[-1, :, 1] + u[-1, :, 2]
    assert Fx[1] < Fx[0] - 500.0


def test_rollout_other_car_advances():
    """tests/test_montecarlo.py's case on the port: the human car moves at
    constant velocity during the rollout."""
    cfg = TM.x1_coupled_config()
    tube = TT.straight_trajectory(80.0, 6.0, pad_to=32, device="cpu",
                                  dtype=F64)
    ctrl = BatchedController(cfg, tube)
    state = ctrl.init_state(t64([[0.0, 0.0, 0.0, 6.0, 0.0, 0.0]]))
    state, (q_log, u_log, oc_log, diag) = ctrl.rollout(
        state, 30, other_car=t64([[0.0, 50.0, np.pi, 5.0]]))
    oc = oc_log.numpy()[:, 0]
    assert oc[-1, 1] < oc[0, 1] - 1.0
    assert np.allclose(oc[:, 3], 5.0)


def test_mesh_is_not_ported():
    """`mesh=` without an initialised process group raises a clear error
    (tests/test_torch_mesh.py runs the mesh on a gloo world), in the
    controller and in the Monte-Carlo engine."""
    tube = TT.straight_trajectory(80.0, 6.0, pad_to=32, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        BatchedController(TM.x1_coupled_config(soft=True), tube,
                          mesh=object())
    scen = TMC.ScenarioSet(q0=t64([[0.0, 10.0, 0.0, 6.0, 0.0, 0.0]]),
                           other0=t64([[0.0, 50.0, np.pi, 5.0]]),
                           t0=t64([0.0]))
    with pytest.raises(RuntimeError, match="init_process_group"):
        TMC.run_dynamic_obstacle(TM.x1_coupled_config(soft=True), tube,
                                 None, scen, n_steps=1, mesh=object())
