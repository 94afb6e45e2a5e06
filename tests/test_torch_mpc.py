"""The slice as a whole: the port's `mpc_step_batched` on the CPU (plain
kernel versions, float64 outside the float32 solver) against the JAX
package's `mpc_step_batched` on the lane backend with bench.py's solver
options, one cold step then one warm step.

Commands agree within the solver-tolerance bar of tests/test_soft.py
(2e-4 rad on delta, 2.0 N on the forces); `converged` is equal; iteration
counts differ by at most one check period; the carries agree."""

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


@pytest.mark.parametrize("change", [
    dict(lin_substeps=2), dict(coupled=TCP(use_walls=True)),
    dict(lin_method="rk4"), dict(use_hji_policy=True),
    dict(soft=False, condensed=True),
    dict(formulation="decoupled", soft=False),
    dict(formulation="lateral")],
    ids=["lin_substeps", "walls", "lin_method", "hji_policy", "hard",
         "decoupled_hard", "unknown_formulation"])
def test_unported_options_raise(change):
    cfg = dataclasses.replace(TM.x1_coupled_config(soft=True), **change)
    with pytest.raises(NotImplementedError):
        TM.init_carry(cfg, 2, device="cpu")


def test_sim_substeps_is_supported():
    cfg = dataclasses.replace(TM.x1_coupled_config(soft=True), sim_substeps=2)
    assert TM.init_carry(cfg, 2, device="cpu").q_prev.shape == (2, 16, 6)
