"""The hard condensed coupled QP's fleet step in the port against the
JAX package at float64: `mpc_step_batched` (backend "xla", factor
"chol") on a cold and a warm step of 3 vehicles on the straight test path
at horizon (2, 3), with the bar of tests/test_torch_mpc.py (2e-4 rad,
2 N; converged equal, iterations within one 10-iteration period at most,
the carries), with the far inactive cache and with HJI rows from the
proto cache (the other car head-on 6, 8 and 12 m ahead: one vehicle
active, all three rows in the grid)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (cache_arrays, carry_arrays, straight_fleet,
                                t64, tube_arrays)
from pigeon_tpu import hji as JH
from pigeon_tpu import hji_solve as JS
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO

F64 = torch.float64
XLA = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
           backend="xla", factor_method="chol", scaling_iters=4)
PROTO = os.path.join(os.path.dirname(__file__), os.pardir, "assets",
                     "hji_cache_proto.npz")


def _two_steps(jcache, tcache, oc):
    """One cold and one warm `mpc_step_batched` of both packages."""
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=2, N_long=3), condensed=True,
                                solver=JSO(**XLA))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3), condensed=True,
                                solver=TSO(**XLA))
    q0, t0 = straight_fleet(3)
    B = q0.shape[0]
    u0 = np.zeros((B, 3))
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    J = jnp.asarray
    jstep = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, q, u, J(oc), t))
    jc1, ju1, jd1 = jstep(jc, J(q0), J(u0), J(t0))
    jc2, ju2, jd2 = jstep(jc1, J(q0), ju1, J(t0) + 0.01)

    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    tc1, tu1, td1 = TM.mpc_step_batched(tcfg, ttube, tcache, tc, t64(q0),
                                        t64(u0), t64(oc), t64(t0))
    tc2, tu2, td2 = TM.mpc_step_batched(tcfg, ttube, tcache, tc1, t64(q0),
                                        tu1, t64(oc), t64(t0) + 0.01)
    return dict(jax=[(jc1, ju1, jd1), (jc2, ju2, jd2)],
                port=[(tc1, tu1, td1), (tc2, tu2, td2)])


@pytest.fixture(scope="module")
def steps():
    jcache = JH.inactive_cache()
    return _two_steps(jcache, convert.cache_from_numpy(
        cache_arrays(jcache), device="cpu"),
        np.broadcast_to([1e4, 1e4, 0.0, 0.0], (3, 4)).copy())


@pytest.fixture(scope="module")
def active_steps():
    """The proto cache, the other car head-on 6, 8 and 12 m ahead of the
    three vehicles: HJI rows in every QP, V < 0 (active) for the first."""
    jcache = JS.load_cache(PROTO)
    q0, _ = straight_fleet(3)
    oc = np.stack([[q[0] + 0.3, q[1] + gap, np.pi, 4.0]
                   for q, gap in zip(q0, (6.0, 8.0, 12.0))])
    return _two_steps(jcache, convert.cache_from_numpy(
        cache_arrays(jcache), device="cpu"), oc)


def _commands_match(steps, k):
    ju = np.asarray(steps["jax"][k][1])
    tu = steps["port"][k][1].numpy()
    assert np.all(np.isfinite(tu))
    d = np.abs(ju - tu)
    assert d[:, 0].max() < 2e-4, d
    assert d[:, 1:].max() < 2.0, d


def _diagnostics_match(steps, k):
    (jc, _, jd), (tc, _, td) = steps["jax"][k], steps["port"][k]
    np.testing.assert_array_equal(td.converged.numpy(),
                                  np.asarray(jd.converged))
    assert td.converged.all()
    assert np.abs(td.iterations.numpy()
                  - np.asarray(jd.iterations)).max() <= 10
    np.testing.assert_array_equal(td.hji_active.numpy(),
                                  np.asarray(jd.hji_active))
    np.testing.assert_array_equal(tc.solved.numpy(), np.asarray(jc.solved))
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-4)
    np.testing.assert_allclose(tc.u_prev.numpy(), np.asarray(jc.u_prev),
                               atol=1e-4 * np.abs(np.asarray(jc.u_prev)).max())
    np.testing.assert_allclose(tc.warm_rho.numpy(), np.asarray(jc.warm_rho),
                               rtol=1e-6)


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_step_commands_match(steps, k):
    _commands_match(steps, k)


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_step_diagnostics_and_carry_match(steps, k):
    _diagnostics_match(steps, k)
    (jc, _, _), (tc, _, _) = steps["jax"][k], steps["port"][k]
    assert tc.warm_x.shape == (3, 40) and tc.warm_y.shape == (3, 74)
    # the JAX carry through convert: the port's fields, dtypes, shapes
    cc = convert.carry_from_numpy(carry_arrays(jc), device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_active_hji_step_matches(active_steps, k):
    _commands_match(active_steps, k)
    _diagnostics_match(active_steps, k)
    (_, _, jd), (_, _, td) = active_steps["jax"][k], active_steps["port"][k]
    np.testing.assert_array_equal(td.hji_active.numpy(), [True, False,
                                                          False])
    V = td.V_hji.numpy()
    assert np.isfinite(V).all()
    np.testing.assert_allclose(V, np.asarray(jd.V_hji), rtol=1e-5,
                               atol=1e-6 * np.abs(V).max())
