"""The decoupled fleet step as a whole: the port's `mpc_step_batched` on
the CPU (plain kernel versions, float64 outside the float32 lane solver)
against the JAX package's on the lane backend with bench.py's decoupled
solver options, one cold step then one step with a warm-started solver
(the decoupled nodes are always trim-seeded).

Commands agree within the solver-tolerance bar of
tests/test_soft_decoupled.py (2e-4 rad on delta, 2.0 N on the forces);
`converged` is equal; iteration counts differ by at most one check period;
the carries agree."""

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
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO

BENCH = dict(max_iter=300, check_every=300, eps_abs=1e-3, eps_rel=1e-3,
             backend="lanes", scaling_iters=2, pallas_check_inner=10)
F64 = torch.float64


def _case(name):
    if name == "short":
        B = 3
        q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.0]
                       for i in range(B)])
        return (3, 4), JT.straight_trajectory(60.0, 5.0, pad_to=32), q0, \
            np.zeros(B)
    q0, t0, cols = oval_fleet(4, seed=8)
    return (10, 20), JT.make_tube(**cols, pad_to=1024), q0, t0


@pytest.fixture(scope="module", params=["short", "full"])
def steps(request):
    (S, Lg), jtube, q0, t0 = _case(request.param)
    B = q0.shape[0]
    u0 = np.zeros((B, 3))
    oc = np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)).copy()

    jcfg = dataclasses.replace(
        JM.x1_decoupled_config(hz=JHP(N_short=S, N_long=Lg), soft=True),
        solver=JSO(**BENCH))
    jcache = JH.inactive_cache()
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    J = lambda a: jnp.asarray(a)
    jstep = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, q, u, J(oc), t))
    jc1, ju1, jd1 = jstep(jc, J(q0), J(u0), J(t0))
    jc2, ju2, jd2 = jstep(jc1, J(q0), ju1, J(t0) + 0.01)

    tcfg = dataclasses.replace(
        TM.x1_decoupled_config(hz=THP(N_short=S, N_long=Lg), soft=True),
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
                port=[(tc1, tu1, td1), (tc2, tu2, td2)], full=Lg == 20)


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
    assert td.converged.all()
    assert np.abs(td.iterations.numpy()
                  - np.asarray(jd.iterations)).max() <= 10
    assert td.solution_finite.numpy().all()
    assert np.isinf(td.V_hji.numpy()).all() and not td.hji_active.any()
    np.testing.assert_allclose(td.s.numpy(), np.asarray(jd.s), rtol=1e-10)
    np.testing.assert_allclose(td.e.numpy(), np.asarray(jd.e), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_carry_matches(steps, k):
    jc, tc = steps["jax"][k][0], steps["port"][k][0]
    assert tc.q_prev.shape[-1] == 4
    # q_prev is the rollout G x + g of a float32 solver iterate x that
    # agrees to ~1e-5 (tests/test_torch_lane_admm.py), over 30 stages
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-4)
    np.testing.assert_allclose(tc.u_prev.numpy(), np.asarray(jc.u_prev),
                               atol=2e-4 * max(1.0, float(np.abs(
                                   np.asarray(jc.u_prev)[..., 1]).max())))
    np.testing.assert_allclose(tc.prev_ts.numpy(), np.asarray(jc.prev_ts),
                               rtol=1e-12)
    np.testing.assert_array_equal(tc.solved.numpy(), np.asarray(jc.solved))
    # the JAX carry carried over through convert: the port's fields,
    # dtypes and shapes (q_prev (B, N, 4))
    cc = convert.carry_from_numpy(carry_arrays(jc), device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jc, name)))


def test_full_horizon_qp_size(steps):
    tc = steps["port"][0][0]
    if steps["full"]:
        assert tc.warm_x.shape[1] == 30 and tc.warm_y.shape[1] == 180
    else:
        assert tc.warm_x.shape[1] == 7 and tc.warm_y.shape[1] == 42


def test_xla_backend_matches_lanes():
    """`mpc_step_batched` takes the solver `cfg.solver.backend` names, as
    the JAX package does: the plain "xla" solve and the lane solve agree
    on the command to the same bar."""
    q0, t0, cols = oval_fleet(3, seed=5)
    hz = THP(N_short=3, N_long=4)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu", dtype=F64)
    cache = TH.inactive_cache(device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (3, 4)))
    us = []
    for backend in ("lanes", "xla"):
        cfg = dataclasses.replace(
            TM.x1_decoupled_config(hz=hz, soft=True),
            solver=TSO(**{**BENCH, "backend": backend, "max_iter": 300,
                          "check_every": 25, "eps_abs": 1e-5,
                          "eps_rel": 1e-5}))
        carry = TM.init_carry(cfg, 3, dtype=F64, device="cpu")
        _, u, d = TM.mpc_step_batched(cfg, tube, cache, carry, t64(q0),
                                      torch.zeros((3, 3), dtype=F64), oc,
                                      t64(t0))
        assert d.converged.all()
        us.append(u.numpy())
    assert np.abs(us[0] - us[1])[:, 0].max() < 2e-4
    assert np.abs(us[0] - us[1])[:, 1:].max() < 2.0


def test_lane_solver_only_when_asked(monkeypatch):
    """`SolverOptions.backend` defaults to "xla", as in the JAX package: a
    configuration taken as it comes runs the plain PyTorch solver, and
    the lane solver (the two solver kernels on the card) runs only under
    backend="lanes"."""
    from pigeon_tpu_torch.solver import lane_admm

    calls = []
    real = lane_admm.solve_lanes_batched

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(lane_admm, "solve_lanes_batched", counted)
    q0, t0, cols = oval_fleet(2, seed=6)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu", dtype=F64)
    cache = TH.inactive_cache(device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (2, 4)))
    base = TM.x1_decoupled_config(hz=THP(N_short=3, N_long=4), soft=True)
    assert base.solver.backend == "xla"
    lanes = dataclasses.replace(
        base, solver=dataclasses.replace(base.solver, backend="lanes"))
    for cfg, expected in ((base, 0), (lanes, 1)):
        carry = TM.init_carry(cfg, 2, dtype=F64, device="cpu")
        TM.mpc_step_batched(cfg, tube, cache, carry, t64(q0),
                            torch.zeros((2, 3), dtype=F64), oc, t64(t0))
        assert len(calls) == expected
