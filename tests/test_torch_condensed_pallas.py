"""The hard condensed coupled QP on the "pallas" backend in the port
against the JAX package, 3 vehicles on the straight test path at horizon
(2, 3) (n=40, m=74, a dense P):

- `solve_qp_batched` (the Ruiz kernel fed the row maxima of |P|, the
  "chol" fallback of factor "banded", the dense ADMM kernel's dense-P
  mode, through their plain versions here) at float32 with tiles of 2,
  against the JAX pipeline in interpret mode; and its statistics
  recomputed from the solution (tests/test_condensed.py:105's check, at
  "highest");
- the single-instance route: `solve_qp(backend="pallas")` (one instance
  through the dense ADMM kernel at tile 1, the residuals outside) and
  `simulate`, against the JAX package's, whose unbatched kernel call is
  run in interpret mode as the JAX package's own tests run it; that route
  runs mode "highest" whatever `pallas_precision` says, as the JAX
  package's does;
- the pipeline and `solve_qp` again at horizon (4, 8) (n=84, m=162), whose
  layout pattern (rows up to 33 nonzeros, columns up to 64) the wrapper
  gives the kernel's wide build on the card, as the live horizon's."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, straight_fleet, t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.solver import admm as JA
from pigeon_tpu.solver import pallas_admm as JPA
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import admm as TA

# chip_smoke.py's solver options for the hard fleets (max_iter 400 in
# segments of 50, factor "banded", which a dense P turns into "chol"),
# with tiles of 2 here
PALLAS = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
              backend="pallas", factor_method="banded", scaling_iters=4,
              pallas_tile=2, pallas_precision="highest",
              pallas_check_inner=10, bf16_bulk_iters=0)
# tests/test_condensed.py:105-130's options for "mixedk6"
MIXEDK6 = dict(PALLAS, factor_method="ns", pallas_precision="mixedk6",
               max_iter=150, check_every=150)
HZ = (2, 3)
# a horizon whose layout pattern takes the dense ADMM kernel's wide build
HZ_WIDE = (4, 8)


def _configs(opts, hz=HZ):
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=hz[0], N_long=hz[1]),
                                condensed=True, solver=JSO(**opts))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                                condensed=True, solver=TSO(**opts))
    return jcfg, tcfg


def _tubes(dtype):
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    jcache = JH.inactive_cache()
    return (jtube, jcache,
            convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=dtype),
            convert.cache_from_numpy(cache_arrays(jcache), device="cpu"))


@pytest.fixture
def jax_unbatched_interpret(monkeypatch):
    """The JAX package's single-instance "pallas" route calls its kernel
    without `interpret`, which only a TPU lowers: run it in interpret
    mode, as tests/test_pallas_admm.py runs the kernel on the CPU."""
    monkeypatch.setattr(JPA, "admm_iterations", functools.partial(
        JPA.admm_iterations, interpret=True))


# ---------------------------------------------------------------------------
# The batched pipeline at float32
# ---------------------------------------------------------------------------

def _pallas_solves(opts, hz=HZ):
    B = 3
    jcfg, tcfg = _configs(opts, hz)
    lay = TM._layout(tcfg)
    _, _, ttube, tcache = _tubes(torch.float32)
    q0, t0 = straight_fleet(B)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    carry = TM.init_carry(tcfg, B, device="cpu")
    oc = f32(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, warm, aux = TM._pre_solve(tcfg, ttube, tcache, carry, f32(q0),
                                  f32(np.zeros((B, 3))), oc, f32(t0))
    assert aux.w is None and qp.P_diag.shape == (B, lay.n, lay.n)
    assert qp.A.shape == (B, lay.m, lay.n)
    tsol = TA.solve_qp_batched(qp, warm, tcfg.solver,
                               banded_plan=TM._banded_plan_for(tcfg),
                               eq_rows=TM._eq_rows_for(tcfg),
                               a_pattern=TM._a_pattern_for(tcfg))
    J = lambda tup: [jnp.asarray(x.numpy()) for x in tup]
    jsol = JA.solve_qp_batched(
        JA.QPData(*J(qp)), JA.QPWarmStart(*J(warm)), jcfg.solver,
        banded_plan=JM._banded_plan_for(jcfg), eq_rows=JM._eq_rows_for(jcfg))
    return dict(qp=qp, tsol=tsol, jsol=jsol, opts=tcfg.solver,
                pattern=TM._a_pattern_for(tcfg))


@pytest.fixture(scope="module")
def pallas_solves():
    return _pallas_solves(PALLAS)


@pytest.fixture(scope="module")
def pallas_solves_wide():
    return _pallas_solves(PALLAS, HZ_WIDE)


@pytest.fixture(scope="module")
def mixedk6_solves():
    return _pallas_solves(MIXEDK6)


def test_pallas_pipeline_matches_jax(pallas_solves):
    """Both pipelines compute in float32, where the 38 stiff equality rows
    (rho_eq = 1e3 rho) make the iterates rounding-determined at the
    solver's 1e-3 tolerance (tests/test_torch_mpc_sparse.py's finding on
    the sparse QP): the same converged flags, iterations within one
    segment, a rho_scale within the adaptive-rho tolerance (a factor of
    5) of the JAX one, and each of x, z, y no further from the float64
    solve (the "xla" backend on the same QPs) than three times the JAX
    pipeline's distance to it (plus 1e-4 of its scale)."""
    assert pallas_solves["pattern"].build == "narrow"
    _pipeline_matches_jax(pallas_solves)


def test_pallas_pipeline_matches_jax_wide_pattern(pallas_solves_wide):
    """`test_pallas_pipeline_matches_jax` at horizon (4, 8), where the
    pipeline hands the kernel a pattern of its wide build."""
    assert pallas_solves_wide["pattern"].build == "wide"
    _pipeline_matches_jax(pallas_solves_wide)


def _pipeline_matches_jax(solves):
    t, j, qp = solves["tsol"], solves["jsol"], solves["qp"]
    assert t.x.dtype == torch.float32
    np.testing.assert_array_equal(t.converged.numpy(),
                                  np.asarray(j.converged))
    assert t.converged.all()
    assert np.abs(t.iterations.numpy() - np.asarray(j.iterations)).max() \
        <= PALLAS["check_every"]
    assert (t.iterations % PALLAS["pallas_check_inner"] == 0).all()
    ratio = t.rho_scale.numpy() / np.asarray(j.rho_scale)
    assert (ratio < 5.0).all() and (ratio > 0.2).all(), ratio
    d64 = lambda tup: type(tup)(*[x.double() for x in tup])
    exact = TA.solve_qp_batched(
        d64(qp), d64(TA.cold_start(qp)),
        dataclasses.replace(solves["opts"], backend="xla"))
    assert exact.converged.all()
    for name in ("x", "z", "y"):
        e = getattr(exact, name).numpy()
        d_port = np.abs(getattr(t, name).numpy() - e).max()
        d_jax = np.abs(np.asarray(getattr(j, name)) - e).max()
        assert d_port <= 3.0 * d_jax + 1e-4 * np.abs(e).max(), (
            name, d_port, d_jax)


def test_pallas_dense_P_stats_truthful(pallas_solves):
    """The residuals the kernel reports, with its P x the dense matvec,
    equal those recomputed at float64 from the returned solution (the
    bars of tests/test_condensed.py:105), and `converged` implies the
    OSQP test holds."""
    _dense_P_stats_truthful(pallas_solves)


def test_pallas_dense_P_stats_truthful_wide_pattern(pallas_solves_wide):
    """`test_pallas_dense_P_stats_truthful` at horizon (4, 8)."""
    _dense_P_stats_truthful(pallas_solves_wide)


def test_mixedk6_pipeline_matches_jax(mixedk6_solves):
    """"mixedk6" (tests/test_condensed.py:105's options) against the JAX
    pipeline.  In one 150-iteration segment these QPs end with their dual
    residual at the tolerance's edge in float32, in "highest" too (there
    the port's pipeline stops two of the three at 120 iterations and the
    JAX one none), so the exits are not compared: x, z, y each no further
    from the float64 solve (backend "xla", "ns" at float64, 400
    iterations) than three times the JAX pipeline's distance to it, plus
    1e-4 of its scale."""
    t, j, qp = (mixedk6_solves["tsol"], mixedk6_solves["jsol"],
                mixedk6_solves["qp"])
    assert t.x.dtype == torch.float32 and torch.isfinite(t.x).all()
    d64 = lambda tup: type(tup)(*[x.double() for x in tup])
    exact = TA.solve_qp_batched(
        d64(qp), d64(TA.cold_start(qp)),
        dataclasses.replace(mixedk6_solves["opts"], backend="xla",
                            max_iter=400, check_every=50))
    assert exact.converged.all()
    for name in ("x", "z", "y"):
        e = getattr(exact, name).numpy()
        d_port = np.abs(getattr(t, name).numpy() - e).max()
        d_jax = np.abs(np.asarray(getattr(j, name)) - e).max()
        assert d_port <= 3.0 * d_jax + 1e-4 * np.abs(e).max(), (
            name, d_port, d_jax)


def test_mixedk6_dense_P_stats_truthful(mixedk6_solves):
    """The split products in the statistics, with the dense P x: the
    bars of tests/test_condensed.py:105."""
    _dense_P_stats_truthful(mixedk6_solves)


def _dense_P_stats_truthful(solves):
    qp, sol, opts = solves["qp"], solves["tsol"], solves["opts"]
    A, P, q = (qp.A.double().numpy(), qp.P_diag.double().numpy(),
               qp.q.double().numpy())
    x, z, y = (sol.x.double().numpy(), sol.z.double().numpy(),
               sol.y.double().numpy())
    for b in range(x.shape[0]):
        Ax, Aty, Px = A[b] @ x[b], A[b].T @ y[b], P[b] @ x[b]
        rp = np.abs(Ax - z[b]).max()
        rd = np.abs(Px + q[b] + Aty).max()
        np.testing.assert_allclose(float(sol.prim_res[b]), rp, rtol=1e-2,
                                   atol=2e-4)
        np.testing.assert_allclose(float(sol.dual_res[b]), rd, rtol=1e-2,
                                   atol=2e-4)
        if bool(sol.converged[b]):
            eps_p = opts.eps_abs + opts.eps_rel * max(np.abs(Ax).max(),
                                                      np.abs(z[b]).max())
            eps_d = opts.eps_abs + opts.eps_rel * max(
                np.abs(Px).max(), np.abs(Aty).max(), np.abs(q[b]).max())
            assert rp <= eps_p * 1.01 and rd <= eps_d * 1.01


# ---------------------------------------------------------------------------
# The single-instance route
# ---------------------------------------------------------------------------

SINGLE = dict(backend="pallas", max_iter=400, check_every=25,
              scaling_iters=10)


def test_solve_qp_pallas_matches_jax(pallas_solves, jax_unbatched_interpret):
    """One QP of the fleet at float64 through `solve_qp(backend="pallas")`
    in both packages: the kernel's segments in float32, Ruiz, the factor
    and the residuals at float64.  The same exit; the stiff equality rows
    leave the float32 iterates rounding-determined, so x, z, y each no
    further from the float64 solve (backend "xla") than three times the
    JAX route's distance to it, plus 1e-4 of its scale."""
    _solve_qp_matches_jax(pallas_solves, HZ)


def test_solve_qp_pallas_matches_jax_wide_pattern(pallas_solves_wide,
                                                  jax_unbatched_interpret):
    """`test_solve_qp_pallas_matches_jax` at horizon (4, 8), whose route
    hands the kernel a pattern of its wide build."""
    assert TM._a_pattern_for(_configs(SINGLE, HZ_WIDE)[1]).build == "wide"
    _solve_qp_matches_jax(pallas_solves_wide, HZ_WIDE)


def _solve_qp_matches_jax(solves, hz):
    _, tcfg = _configs(SINGLE, hz)
    qp = TA.QPData(*[t[1].double() for t in solves["qp"]])
    ts = TA.solve_qp(qp, None, tcfg.solver,
                     a_pattern=TM._a_pattern_for(tcfg))
    js = JA.solve_qp(JA.QPData(*[jnp.asarray(t.numpy()) for t in qp]), None,
                     JSO(**SINGLE))
    exact = TA.solve_qp(qp, None, TSO(**dict(SINGLE, backend="xla")))
    assert ts.x.dtype == torch.float64
    assert bool(ts.converged) and bool(js.converged) and bool(exact.converged)
    assert int(ts.iterations) == int(js.iterations)
    for name in ("x", "z", "y"):
        e = getattr(exact, name).numpy()
        d_port = np.abs(getattr(ts, name).numpy() - e).max()
        d_jax = np.abs(np.asarray(getattr(js, name)) - e).max()
        assert d_port <= 3.0 * d_jax + 1e-4 * np.abs(e).max(), (
            name, d_port, d_jax)


@pytest.mark.parametrize("change", [
    dict(pallas_precision="mixedk6"), dict(pallas_precision="mixed"),
    dict(pallas_precision="high"), dict(bf16_bulk_iters=20)],
    ids=["mixedk6", "mixed", "high", "bf16_bulk"])
def test_solve_qp_pallas_ignores_precision(pallas_solves, change):
    """The single-instance route runs the kernel in mode "highest"
    whatever the options' precision or bf16 bulk say (JAX admm.py:286-294
    passes neither): the same bits as "highest"."""
    qp = TA.QPData(*[t[1].double() for t in pallas_solves["qp"]])
    _, tcfg = _configs(SINGLE)
    ref = TA.solve_qp(qp, None, tcfg.solver,
                      a_pattern=TM._a_pattern_for(tcfg))
    got = TA.solve_qp(qp, None, TSO(**dict(SINGLE, **change)),
                      eq_rows=TM._eq_rows_for(tcfg),
                      a_pattern=TM._a_pattern_for(tcfg))
    for name in TA.QPSolution._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_simulate_pallas_matches_jax(jax_unbatched_interpret):
    """`simulate` on the condensed config, backend "pallas", five steps:
    the commands within the bar of tests/test_soft.py (2e-4 rad, 2 N),
    the same exits, and the states."""
    jcfg, tcfg = _configs(SINGLE)
    jtube, jcache, ttube, tcache = _tubes(torch.float64)
    q0 = np.array([0.2, 0.3, 0.01, 5.0, 0.05, 0.0])
    jlog = JM.simulate(jcfg, jtube, jcache, jnp.asarray(q0), n_steps=5)
    tlog = TM.simulate(tcfg, ttube, tcache, t64(q0), n_steps=5,
                       device="cpu")
    d = np.abs(tlog.u.numpy() - np.asarray(jlog.u))
    assert d[:, 0].max() < 2e-4, d
    assert d[:, 1:].max() < 2.0, d
    np.testing.assert_array_equal(tlog.diag.iterations.numpy(),
                                  np.asarray(jlog.diag.iterations))
    assert tlog.diag.converged.all() and np.asarray(jlog.diag.converged).all()
    np.testing.assert_allclose(tlog.q.numpy(), np.asarray(jlog.q),
                               rtol=1e-9, atol=1e-7)
