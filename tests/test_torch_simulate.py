"""The unbatched route of the port against the JAX package, at float64:
`mpc_step` for one vehicle at the full horizons of both formulations, and
the closed loop `simulate` over ten steps at a short horizon.  This route
linearizes through the dense Van Loan stage matrix and solves with the
single-instance `solve_qp` (both float64 here, so the two packages run the
same iterates and differ by rounding only)."""

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
from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import discretize as TZ
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.qp import decoupled as TQ
from pigeon_tpu_torch.solver import admm as TA

F64 = torch.float64
CONFIGS = {"coupled": (JM.x1_coupled_config, TM.x1_coupled_config),
           "decoupled": (JM.x1_decoupled_config, TM.x1_decoupled_config)}
N_STEPS = 10


def _oval():
    q0, t0, cols = oval_fleet(1, seed=21, k_max=1)     # at the path's start
    jtube = JT.make_tube(**cols, pad_to=1024)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    jcache = JH.inactive_cache()
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    return q0[0], jtube, ttube, jcache, tcache


@pytest.fixture(scope="module")
def oval():
    return _oval()


def _command_close(tu, ju):
    """Same float64 iterates in both packages: rounding amplified by the
    ADMM iterations and, in `simulate`, by the closed loop.  1e-6 rad and
    1e-2 N, a hundredth of the solver-tolerance bar of
    tests/test_soft_decoupled.py."""
    d = np.abs(np.asarray(tu) - np.asarray(ju))
    assert d[..., 0].max() < 1e-6, d
    assert d[..., 1:].max() < 1e-2, d


@pytest.mark.parametrize("formulation", ["coupled", "decoupled"])
def test_mpc_step_full_horizon(oval, formulation):
    q0, jtube, ttube, jcache, tcache = oval
    jmake, tmake = CONFIGS[formulation]
    jcfg, tcfg = jmake(soft=True), tmake(soft=True)
    u0 = np.array([0.01, 200.0, 100.0])
    oc = np.array([1e4, 1e4, 0.0, 0.0])
    jc, ju, jd = jax.jit(lambda c, q, u: JM.mpc_step(
        jcfg, jtube, jcache, c, q, u, jnp.asarray(oc), 0.0))(
        JM.init_carry(jcfg, dtype=jnp.float64), jnp.asarray(q0),
        jnp.asarray(u0))

    seen = []
    spies = {(TZ, "expm_dense"): "expm_dense", (TZ, "vanloan"): "vanloan",
             (TQ, "rollout_affine"): "rollout",
             (TA, "_solve_masked"): "solve_qp"}
    originals = {k: getattr(*k) for k in spies}
    try:
        for (mod, name), tag in spies.items():
            def spy(*a, _f=originals[(mod, name)], _t=tag, **kw):
                seen.append((_t, tuple(a[0].shape) if _t != "solve_qp"
                             else tuple(a[0].q.shape)))
                return _f(*a, **kw)
            setattr(mod, name, spy)
        tc, tu, td = TM.mpc_step(tcfg, ttube, tcache,
                                 TM.init_carry(tcfg, None, dtype=F64,
                                               device="cpu"),
                                 t64(q0), t64(u0), t64(oc), 0.0)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    # the route: one dense stack of (T, n+2m+1, n+2m+1), no structured
    # exponential, no rollout kernel, one single-instance solve
    stack = (1, 15, 19, 19) if formulation == "coupled" else (1, 30, 17, 17)
    assert seen == [("expm_dense", stack), ("solve_qp", (1, 30))]

    assert tu.shape == (3,) and tc.q_prev.dim() == 2 and td.s.dim() == 0
    _command_close(tu.numpy(), ju)
    assert bool(td.converged) == bool(jd.converged)
    assert int(td.iterations) == int(jd.iterations)
    np.testing.assert_allclose(float(td.s), float(jd.s), rtol=1e-10)
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-6)
    np.testing.assert_allclose(tc.warm_x.numpy(), np.asarray(jc.warm_x),
                               atol=1e-6)
    cc = convert.carry_from_numpy(carry_arrays(jc), device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name


def _simulate_pair(oval, formulation, **change):
    q0, jtube, ttube, jcache, tcache = oval
    jmake, tmake = CONFIGS[formulation]
    jcfg = jmake(hz=JHP(N_short=3, N_long=4), soft=True, **change)
    tcfg = tmake(hz=THP(N_short=3, N_long=4), soft=True, **change)
    jlog = jax.jit(lambda q: JM.simulate(jcfg, jtube, jcache, q,
                                         n_steps=N_STEPS))(jnp.asarray(q0))
    tlog = TM.simulate(tcfg, ttube, tcache, t64(q0), n_steps=N_STEPS,
                       device="cpu")
    return jlog, tlog


@pytest.fixture(scope="module", params=["coupled", "decoupled"])
def logs(request, oval):
    return _simulate_pair(oval, request.param)


def test_simulate_states_match(logs):
    jlog, tlog = logs
    assert tlog.q.shape == (N_STEPS, 6)
    # positions in metres and speeds in m/s after ten closed-loop steps
    np.testing.assert_allclose(tlog.q.numpy(), np.asarray(jlog.q),
                               rtol=1e-9, atol=1e-7)
    # the plant moved: the loop propagates with the previous command
    assert np.abs(np.diff(tlog.q.numpy()[:, 0])).min() > 0


def test_simulate_commands_match(logs):
    jlog, tlog = logs
    assert tlog.u.shape == (N_STEPS, 3)
    np.testing.assert_array_equal(tlog.u[0].numpy(), 0.0)   # u0 in effect
    _command_close(tlog.u.numpy(), jlog.u)
    assert np.abs(tlog.u.numpy()[1:]).max() > 0


def test_simulate_diagnostics_match(logs):
    jlog, tlog = logs
    np.testing.assert_array_equal(tlog.diag.converged.numpy(),
                                  np.asarray(jlog.diag.converged))
    assert tlog.diag.converged.all()
    np.testing.assert_array_equal(tlog.diag.iterations.numpy(),
                                  np.asarray(jlog.diag.iterations))
    np.testing.assert_allclose(tlog.diag.e.numpy(), np.asarray(jlog.diag.e),
                               rtol=1e-8, atol=1e-9)


def test_simlog_converts(logs):
    jlog, tlog = logs
    arrays = dict(q=np.asarray(jlog.q), u=np.asarray(jlog.u),
                  diag={k: np.asarray(v)
                        for k, v in jlog.diag._asdict().items()})
    cl = convert.simlog_from_numpy(arrays, device="cpu", dtype=F64)
    assert cl.q.dtype == F64 and cl.q.shape == tlog.q.shape
    for name in TM.StepDiagnostics._fields:
        a, b = getattr(cl.diag, name), getattr(tlog.diag, name)
        assert a.shape == b.shape, name
        assert a.is_floating_point() == b.is_floating_point(), name


def test_simulate_substeps(oval):
    """`sim_substeps=2` integrates the plant in two RK4 half steps."""
    jlog, tlog = _simulate_pair(oval, "decoupled", sim_substeps=2)
    np.testing.assert_allclose(tlog.q.numpy(), np.asarray(jlog.q),
                               rtol=1e-9, atol=1e-7)
    _command_close(tlog.u.numpy(), jlog.u)


def test_simulate_needs_a_device_or_cpu(oval):
    """The entry point runs on the card unless asked for the CPU."""
    q0, _, ttube, _, tcache = oval
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.simulate(TM.x1_decoupled_config(soft=True), ttube, tcache,
                    t64(q0), n_steps=1)
    assert _kernels.launches()["expm_dense"] == 0
