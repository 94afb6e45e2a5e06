"""The sparse coupled formulation (`x1_coupled_config()` as it comes:
soft=False, condensed=False) in the port against the JAX package:

- `solve_qp_batched(backend="pallas")` (the Ruiz kernel, the banded
  factor and the dense ADMM kernel, through their plain versions here)
  on the QPs of a 3-vehicle step at float32, with tiles of 2, against the
  JAX pipeline in interpret mode; and its statistics recomputed from the
  solution; the same in precision mode "mixedk6" (the layout's 128
  equality rows, `eq_rows`, in float32, the rest split into bf16 pairs),
  and with the bf16 bulk phase (`bf16_bulk_iters`) before it;
- the mixed modes' row handling on a small random QP, against the JAX
  pipeline: `eq_rows` that are not a prefix (the rows permuted for the
  kernel), a row whose bounds collapse at run time outside `eq_rows`
  (the static rho mask), and no `eq_rows` at all (ValueError);
- the whole `mpc_step_batched` (backend "xla", factor "banded") on a cold
  and a warm step at float64, with the bar of tests/test_torch_mpc.py;
- the carry of n=193 / m=290 through `convert.carry_from_numpy`.

tests/test_torch_simulate_sparse.py holds the single-vehicle route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, carry_arrays, t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.solver import admm as JA
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import admm as TA

F64 = torch.float64
# chip_smoke.py's solver options for the sparse fleet (max_iter 400 in
# segments of 50), with tiles of 2 here
PALLAS = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
              backend="pallas", factor_method="banded", scaling_iters=4,
              pallas_tile=2, pallas_precision="highest",
              pallas_check_inner=10, bf16_bulk_iters=0)
XLA = dict(PALLAS, backend="xla")
# scripts/exp_conv.py's precision mode, and the bf16 bulk before it: two
# bf16 iterations (the bf16 iteration diverges on these QPs in both
# packages: 50 bulk iterations end in NaN)
MIXEDK6 = dict(PALLAS, pallas_precision="mixedk6")
LADDER = dict(MIXEDK6, bf16_bulk_iters=2)
HZ = (2, 3)


def _straight_fleet(B=3):
    q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.0]
                   for i in range(B)])
    return q0, np.zeros(B)


def _configs(opts, hz=HZ):
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=hz[0], N_long=hz[1]),
                                solver=JSO(**opts))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                                solver=TSO(**opts))
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# The pallas pipeline at float32
# ---------------------------------------------------------------------------

def _pallas_solves(opts):
    B = 3
    jcfg, tcfg = _configs(opts)
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=torch.float32)
    tcache = convert.cache_from_numpy(cache_arrays(JH.inactive_cache()),
                                      device="cpu")
    q0, t0 = _straight_fleet(B)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    carry = TM.init_carry(tcfg, B, device="cpu")
    oc = f32(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, warm, aux = TM._pre_solve(tcfg, ttube, tcache, carry, f32(q0),
                                  f32(np.zeros((B, 3))), oc, f32(t0))
    assert aux.w is None and qp.A.shape == (B, 104, 70)
    tsol = TA.solve_qp_batched(qp, warm, tcfg.solver,
                               banded_plan=TM._banded_plan_for(tcfg),
                               eq_rows=TM._eq_rows_for(tcfg))
    J = lambda tup: [jnp.asarray(x.numpy()) for x in tup]
    jsol = JA.solve_qp_batched(
        JA.QPData(*J(qp)), JA.QPWarmStart(*J(warm)), jcfg.solver,
        banded_plan=JM._banded_plan_for(jcfg), eq_rows=JM._eq_rows_for(jcfg))
    return dict(qp=qp, tsol=tsol, jsol=jsol, opts=tcfg.solver,
                plan=TM._banded_plan_for(tcfg))


@pytest.fixture(scope="module")
def pallas_solves():
    return _pallas_solves(PALLAS)


@pytest.fixture(scope="module")
def mixedk6_solves():
    return _pallas_solves(MIXEDK6)


@pytest.fixture(scope="module")
def ladder_solves():
    return _pallas_solves(LADDER)


def test_pallas_pipeline_matches_jax(pallas_solves):
    """Both pipelines compute in float32, where the stiff equality rows
    (rho_eq = 1e3 rho) leave the iterates rounding-determined at the
    solver's 1e-3 tolerance: the two float32 solutions differ from the
    float64 solve (the "xla" backend on the same QPs) by up to ~1e-3 of
    their scale, and an early exit may move by a segment.  So: the same
    converged flags, iterations within one segment, a rho_scale within
    the adaptive-rho tolerance (a factor of 5) of the JAX one, and each
    of x, z, y no further from the float64 solve than three times the JAX
    pipeline's distance to it (plus 1e-4 of its scale)."""
    _pipeline_held_to_jax(pallas_solves)
    t = pallas_solves["tsol"]
    assert (t.iterations % PALLAS["pallas_check_inner"] == 0).all()


def _pipeline_held_to_jax(solves, converged=True):
    """`solves`' port solution against the JAX pipeline's, by the rule of
    test_pallas_pipeline_matches_jax."""
    t, j, qp = solves["tsol"], solves["jsol"], solves["qp"]
    assert t.x.dtype == torch.float32
    np.testing.assert_array_equal(t.converged.numpy(),
                                  np.asarray(j.converged))
    assert bool(t.converged.all()) == converged
    assert np.abs(t.iterations.numpy() - np.asarray(j.iterations)).max() \
        <= solves["opts"].check_every
    ratio = t.rho_scale.numpy() / np.asarray(j.rho_scale)
    assert (ratio < 5.0).all() and (ratio > 0.2).all(), ratio
    d64 = lambda tup: type(tup)(*[x.double() for x in tup])
    exact = TA.solve_qp_batched(
        d64(qp), d64(TA.cold_start(qp)),
        dataclasses.replace(solves["opts"], backend="xla"),
        banded_plan=solves.get("plan"))
    assert exact.converged.all()
    for name in ("x", "z", "y"):
        e = getattr(exact, name).numpy()
        d_port = np.abs(getattr(t, name).numpy() - e).max()
        d_jax = np.abs(np.asarray(getattr(j, name)) - e).max()
        assert d_port <= 3.0 * d_jax + 1e-4 * np.abs(e).max(), (
            name, d_port, d_jax)


def test_pallas_stats_truthful(pallas_solves):
    """The residuals the kernel reports equal those recomputed from the
    returned solution, and `converged` implies the OSQP test holds (as
    tests/test_batched_step.py checks the JAX pipeline)."""
    _stats_truthful(pallas_solves, atol=1e-6)


def _stats_truthful(solves, atol):
    qp, sol, opts = solves["qp"], solves["tsol"], solves["opts"]
    A, P, q = (qp.A.double().numpy(), qp.P_diag.double().numpy(),
               qp.q.double().numpy())
    x, z, y = (sol.x.double().numpy(), sol.z.double().numpy(),
               sol.y.double().numpy())
    for b in range(x.shape[0]):
        Ax, Aty, Px = A[b] @ x[b], A[b].T @ y[b], P[b] * x[b]
        rp = np.abs(Ax - z[b]).max()
        rd = np.abs(Px + q[b] + Aty).max()
        np.testing.assert_allclose(float(sol.prim_res[b]), rp, rtol=1e-2,
                                   atol=atol)
        np.testing.assert_allclose(float(sol.dual_res[b]), rd, rtol=1e-2,
                                   atol=atol)
        if bool(sol.converged[b]):
            eps_p = opts.eps_abs + opts.eps_rel * max(np.abs(Ax).max(),
                                                      np.abs(z[b]).max())
            eps_d = opts.eps_abs + opts.eps_rel * max(
                np.abs(Px).max(), np.abs(Aty).max(), np.abs(q[b]).max())
            assert rp <= eps_p * 1.01 and rd <= eps_d * 1.01


def test_mixedk6_pipeline_matches_jax(mixedk6_solves):
    """"mixedk6" with the layout's eq_rows (the 128 leading rows: no
    permutation), by the rule of test_pallas_pipeline_matches_jax: its
    bf16 pairs perturb the float32 fixed point further below the
    tolerance, in both pipelines alike."""
    _pipeline_held_to_jax(mixedk6_solves)
    assert (mixedk6_solves["tsol"].iterations
            % PALLAS["pallas_check_inner"] == 0).all()


def test_mixedk6_stats_truthful(mixedk6_solves):
    """The mixed mode's statistics take A x and A'y through the split
    products: within tests/test_batched_step.py's 5e-5 of the residuals
    recomputed from the solution."""
    _stats_truthful(mixedk6_solves, atol=5e-5)


def test_bf16_bulk_matches_jax(ladder_solves):
    """The bf16 bulk phase: its iterations count in full (2 more than a
    multiple of the check period), its statistics set no convergence (a
    segment always follows), and the executed counts and converged flags
    are the JAX pipeline's."""
    t, j = ladder_solves["tsol"], ladder_solves["jsol"]
    np.testing.assert_array_equal(t.iterations.numpy(),
                                  np.asarray(j.iterations))
    np.testing.assert_array_equal(t.converged.numpy(),
                                  np.asarray(j.converged))
    it = t.iterations.numpy()
    assert (it >= 2 + PALLAS["pallas_check_inner"]).all()
    assert ((it - 2) % PALLAS["pallas_check_inner"] == 0).all()
    _pipeline_held_to_jax(ladder_solves)


# ---------------------------------------------------------------------------
# The mixed modes' rows, on a small random QP
# ---------------------------------------------------------------------------

EQ_ROWS = np.array([3, 8, 15])
SMALL = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
             backend="pallas", factor_method="chol", scaling_iters=4,
             pallas_tile=2, pallas_precision="mixedk6",
             pallas_check_inner=10)


def _small_qp(collapse=None, B=3, n=12, m=20):
    """A random feasible QP batch with l = u on EQ_ROWS (and, for
    `collapse`, on that row too: bounds that meet at run time), float32."""
    rng = np.random.default_rng(17)
    P = rng.uniform(0.5, 2.0, (B, n))
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    c = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)))
    w = rng.uniform(0.1, 1.0, (B, m))
    w[:, EQ_ROWS] = 0.0
    if collapse is not None:
        w[:, collapse] = 0.0
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    return TA.QPData(f(P), f(q), f(A), f(c - w), f(c + w))


def _solve_small(qp, eq_rows, **change):
    opts = dict(SMALL, **change)
    t = TA.solve_qp_batched(qp, TA.cold_start(qp), TSO(**opts),
                            eq_rows=eq_rows)
    J = lambda tup: [jnp.asarray(x.numpy()) for x in tup]
    jqp = JA.QPData(*J(qp))
    j = JA.solve_qp_batched(jqp, jax.vmap(JA.cold_start)(jqp), JSO(**opts),
                            eq_rows=eq_rows)
    return dict(qp=qp, tsol=t, jsol=j, opts=TSO(**opts))


# One fixed segment of 50 iterations: with its stiff rows (rho_eq = 1e3
# rho) this QP's exits at eps 1e-3 are rounding-determined in float32 (the
# JAX and the port's pipelines exit several check periods apart in every
# mode, "highest" too), so the rows' handling is held on the iterates.
FIXED = dict(max_iter=50, check_every=50, pallas_check_inner=0)


def _gap(a, b):
    """The largest difference of x, z, y between two solutions."""
    return max(float(np.abs(np.asarray(getattr(a, k))
                            - np.asarray(getattr(b, k))).max())
               for k in ("x", "z", "y"))


def test_eq_rows_not_a_prefix_match_jax():
    """eq_rows at rows 3, 8 and 15: the kernel sees them first (A, l, u,
    rho, E, z and y permuted, z and y permuted back).  After one segment
    the port lies as close to the JAX pipeline as "highest" does (3x its
    gap), and at most a quarter as far as from a solve that takes the
    first three rows as the equality rows (what skipping the permutation
    would give)."""
    qp = _small_qp()
    got = _solve_small(qp, EQ_ROWS, **FIXED)
    highest = _solve_small(qp, EQ_ROWS, pallas_precision="highest", **FIXED)
    unpermuted = _solve_small(qp, np.arange(EQ_ROWS.size), **FIXED)
    gap = _gap(got["tsol"], got["jsol"])
    assert gap <= 3.0 * _gap(highest["tsol"], highest["jsol"])
    assert gap <= 0.25 * _gap(got["tsol"], unpermuted["tsol"])
    full = _solve_small(qp, EQ_ROWS)
    assert full["tsol"].converged.all() and full["jsol"].converged.all()


def test_static_eq_mask_matches_jax():
    """Row 11's bounds meet at run time but it is not in eq_rows: in a
    mixed mode it keeps the plain rho, as in the JAX pipeline (the
    run-time test would give it the stiff rho_eq while its products run
    split).  After one segment the port lies at most a quarter as far
    from the JAX pipeline as from a solve that lists row 11."""
    qp = _small_qp(collapse=11)
    got = _solve_small(qp, EQ_ROWS, **FIXED)
    listed = _solve_small(qp, np.sort(np.r_[EQ_ROWS, 11]), **FIXED)
    assert _gap(got["tsol"], got["jsol"]) \
        <= 0.25 * _gap(got["tsol"], listed["tsol"])
    full = _solve_small(qp, EQ_ROWS)
    assert full["tsol"].converged.all() and full["jsol"].converged.all()


def test_mixed_mode_without_eq_rows_raises():
    """A mixed mode needs the equality rows: without eq_rows the kernel
    gets m_eq = 0 and raises ValueError, in both pipelines."""
    qp = _small_qp()
    with pytest.raises(ValueError):
        TA.solve_qp_batched(qp, TA.cold_start(qp), TSO(**SMALL))
    J = lambda tup: [jnp.asarray(x.numpy()) for x in tup]
    jqp = JA.QPData(*J(qp))
    with pytest.raises(ValueError):
        JA.solve_qp_batched(jqp, jax.vmap(JA.cold_start)(jqp), JSO(**SMALL))


# ---------------------------------------------------------------------------
# The fleet step at float64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps():
    q0, t0 = _straight_fleet(3)
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    B = q0.shape[0]
    u0 = np.zeros((B, 3))
    oc = np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)).copy()
    jcfg, tcfg = _configs(XLA)
    jcache = JH.inactive_cache()
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    J = jnp.asarray
    jstep = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, q, u, J(oc), t))
    jc1, ju1, jd1 = jstep(jc, J(q0), J(u0), J(t0))
    jc2, ju2, jd2 = jstep(jc1, J(q0), ju1, J(t0) + 0.01)

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
def test_step_commands_match(steps, k):
    ju = np.asarray(steps["jax"][k][1])
    tu = steps["port"][k][1].numpy()
    assert np.all(np.isfinite(tu))
    d = np.abs(ju - tu)
    assert d[:, 0].max() < 2e-4, d
    assert d[:, 1:].max() < 2.0, d


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_step_diagnostics_and_carry_match(steps, k):
    (jc, _, jd), (tc, _, td) = steps["jax"][k], steps["port"][k]
    np.testing.assert_array_equal(td.converged.numpy(),
                                  np.asarray(jd.converged))
    assert td.converged.all()
    assert np.abs(td.iterations.numpy()
                  - np.asarray(jd.iterations)).max() <= 10
    np.testing.assert_array_equal(tc.solved.numpy(), np.asarray(jc.solved))
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-4)
    np.testing.assert_allclose(tc.warm_rho.numpy(), np.asarray(jc.warm_rho),
                               rtol=1e-6)
    # the JAX carry carried over through convert: same fields, values and
    # shapes as the port's carry
    cc = convert.carry_from_numpy(carry_arrays(jc), device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name


def test_carry_round_trip_full_horizon():
    """A JAX carry of the live horizon (warm vectors of n=193 / m=290),
    filled with seeded values, through convert: the port's own carry's
    fields, dtypes and shapes, and the values as they were."""
    B = 4
    jcfg = JM.x1_coupled_config()
    tcfg = TM.x1_coupled_config()
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    rng = np.random.default_rng(9)
    arrays = {}
    for name, v in carry_arrays(carry).items():
        shape = (B,) + v.shape
        if v.dtype == bool:
            arrays[name] = rng.integers(0, 2, shape).astype(bool)
        else:
            arrays[name] = rng.normal(size=shape)
    cc = convert.carry_from_numpy(arrays, device="cpu", dtype=F64)
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    assert cc.warm_x.shape == (B, 193) and cc.warm_y.shape == (B, 290)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), arrays[name])


def test_unported_sparse_options_raise():
    """lin_method "rk4" and lin_substeps, which raised before the RK4
    linearization was ported, give the sparse QP's carry (n = 70, m = 104
    at (2, 3)) with the JAX carry's shapes."""
    cfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3))
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=2, N_long=3))
    for change in (dict(lin_method="rk4"), dict(lin_substeps=2)):
        carry = TM.init_carry(dataclasses.replace(cfg, **change), 2,
                              device="cpu")
        jc = JM.init_carry(dataclasses.replace(jcfg, **change))
        for name in TM.MPCCarry._fields:
            assert (getattr(carry, name).shape
                    == (2,) + getattr(jc, name).shape)
        assert carry.warm_x.shape == (2, 70)
        assert carry.warm_y.shape == (2, 104)
