"""The sparse decoupled formulation (`x1_decoupled_config()` as it comes:
soft=False, N_short=10, N_long=20, n = 245, m = 395) in the port against
the JAX package, at float64 on the CPU unless named:

- the layout (`qp/decoupled.DecoupledLayout`): n, m, the variable blocks
  and every entry's row and column, equal;
- the exact per-stage linearizations (`discretize.linearize_affine_zoh`
  and `_foh`, batched over vehicles and stages as the JAX package's
  `vmap`) within 1e-12 of each output's scale, and `build_qp`'s P, q, A,
  l, u on the same nodes within 1e-12 of each one's scale (non-finite
  bounds at the same places);
- `extract_control` and `extract_trajectory` equal;
- the (2, 3) horizon of tests/test_mpc.py::test_decoupled_qp_matches_scipy
  solved by both packages' `solve_qp` at eps 1e-8: the same iterations,
  x within 1e-9;
- `mpc_step_batched` on backend "xla" (B = 3, a cold and a warm step) and
  `simulate` (one vehicle, 3 steps, the default solver: "chol", 2000
  iterations in segments of 25) at full width: commands within 1e-9 rad
  and 1e-6 N, the same iterations and convergence (float64 ADMM on the
  same QPs: only the rounding of the two libraries' products differs);
- the "pallas" pipeline at float32 on the CPU (its plain Ruiz and dense
  ADMM versions; "banded" falls through to the dense Cholesky, the
  decoupled QP having no banded plan) on the QPs of the cold step:
  converged by its own statistics, each solution within the solver
  tolerance of a float64 solve at eps 1e-9 (its unscaled residuals
  recomputed in float64 within eps_abs + eps_rel of the magnitudes, and
  commands within 2e-4 rad, test_soft_decoupled.py's bar), as the "xla"
  backend's are;
- the carry of n = 245 / m = 395 through `convert.carry_from_numpy`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (cache_arrays, carry_arrays, straight_fleet,
                                t64, tube_arrays)
from pigeon_tpu import discretize as JZ
from pigeon_tpu import dynamics as JDY
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.qp import decoupled as JD
from pigeon_tpu.solver import admm as JA
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import discretize as TZ
from pigeon_tpu_torch import dynamics as TDY
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.qp import decoupled as TD
from pigeon_tpu_torch.solver import admm as TA

F64 = torch.float64
# chip_smoke.py's SPARSE_SOLVER: the sparse fleets' "pallas" options
PALLAS = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
              backend="pallas", factor_method="banded", scaling_iters=4,
              pallas_tile=4, pallas_precision="highest",
              pallas_check_inner=10, bf16_bulk_iters=0)
TIGHT = dict(max_iter=20000, check_every=25, eps_abs=1e-9, eps_rel=1e-9)


def _scale(a) -> float:
    return max(1.0, float(np.abs(a[np.isfinite(a)]).max(initial=0.0)))


def _close(a, b, rel, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    fa, fb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(fa, fb, err_msg=what)
    np.testing.assert_array_equal(a[~fa], b[~fb], err_msg=what)
    assert np.abs(a[fa] - b[fb]).max(initial=0.0) <= rel * _scale(a), what


@pytest.fixture(scope="module")
def nodes():
    """The JAX package's trim-seeded nodes of a 3-vehicle straight-path
    step at full width, as numpy: dt (B, T), qs (B, N, 4), us (B, N, 2),
    ps (B, N, 4)."""
    cfg = JM.x1_decoupled_config()
    tube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    q0, _ = straight_fleet(3)

    @jax.jit
    def seed(q):
        ts, dt = JM.compute_time_steps(cfg.hz, 0.0)
        qs, us, ps = JM._nodes_decoupled(cfg, tube, q, jnp.zeros(3), ts, dt)
        return dt, qs, us, ps

    return [np.asarray(a) for a in jax.vmap(seed)(jnp.asarray(q0))]


def test_layout_matches_jax():
    hz = (10, 20)
    jl = JD.get_layout(JHP(*hz))
    tl = TD.get_layout(THP(*hz))
    assert (tl.n, tl.m) == (jl.n, jl.m) == (245, 395)
    for name in ("q", "d", "sig", "dd"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))
    np.testing.assert_array_equal(tl.lay._row_cat, jl.lay._row_cat)
    np.testing.assert_array_equal(tl.lay._col_cat, jl.lay._col_cat)
    assert tl.lay._sizes == jl.lay._sizes
    # the port's default controller takes this layout
    cfg = TM.x1_decoupled_config()
    assert TM._layout(cfg) is tl and TM._eq_rows_for(cfg) is None


@pytest.mark.parametrize("hold", ["zoh", "foh"])
def test_linearize_affine_matches_jax(nodes, hold):
    dt, qs, us, ps = nodes
    cfg = JM.x1_decoupled_config()
    S, N = cfg.hz.N_short, cfg.hz.N
    T = N - 1
    ur = np.concatenate([us, ps], axis=-1)
    jf = lambda q, u: JDY.vehicle_ode(cfg.veh, "lateral", q, u[:2], u[2:])
    tveh = TM.x1_decoupled_config().veh
    tf = lambda q, u: TDY.vehicle_ode(tveh, "lateral", q, u[..., :2],
                                      u[..., 2:])
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    if hold == "zoh":
        args = (flat(qs[:, :S]), flat(ur[:, :S]), flat(dt[:, :S]))
        jout = jax.jit(jax.vmap(
            lambda q, u, h: JZ.linearize_affine_zoh(jf, q, u, h, 1)))(*args)
        tout = TZ.linearize_affine_zoh(tf, *[t64(a) for a in args], 1)
    else:
        args = (flat(qs[:, S:T]), flat(ur[:, S:T]), flat(ur[:, S + 1:N]),
                flat(dt[:, S:T]))
        jout = jax.jit(jax.vmap(
            lambda q, u0, uf, h: JZ.linearize_affine_foh(jf, q, u0, uf, h,
                                                         1)))(*args)
        tout = TZ.linearize_affine_foh(tf, *[t64(a) for a in args], 1)
    assert len(jout) == len(tout)
    for i, (a, b) in enumerate(zip(jout, tout)):
        assert b.dtype == F64
        _close(np.asarray(a), b.numpy(), 1e-12, f"{hold} output {i}")


def test_build_qp_matches_jax(nodes):
    jcfg, tcfg = JM.x1_decoupled_config(), TM.x1_decoupled_config()
    jdata = JD.DecoupledStageData(*[jnp.asarray(a) for a in nodes])
    jqp = jax.jit(jax.vmap(lambda d: JD.build_qp(
        jcfg.veh, jcfg.decoupled, jcfg.hz, d)))(jdata)
    tqp = TD.build_qp(tcfg.veh, tcfg.decoupled, tcfg.hz,
                      TD.DecoupledStageData(*[t64(a) for a in nodes]))
    assert tqp.A.shape == (3, 395, 245) and tqp.P_diag.shape == (3, 245)
    for name, a, b in zip(JA.QPData._fields, jqp, tqp):
        _close(np.asarray(a), b.numpy(), 1e-12, name)
    # the rows with l == u: the 155 equality rows, not leading
    eq = (tqp.u - tqp.l).abs() < 1e-10
    assert (eq.sum(dim=-1) == 155).all() and not eq[:, 0].any()


def test_extract_matches_jax(nodes):
    hz = (10, 20)
    us = nodes[2]
    x = np.random.default_rng(4).normal(size=(3, 245))
    jhz, thz = JHP(*hz), THP(*hz)
    ju = jax.vmap(lambda xv, u: JD.extract_control(jhz, xv, u))(
        jnp.asarray(x), jnp.asarray(us))
    tu = TD.extract_control(thz, t64(x), t64(us))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    L = JD.get_layout(jhz)
    q_sol, u_sol = TD.extract_trajectory(thz, t64(x), t64(us))
    np.testing.assert_array_equal(q_sol.numpy(), x[:, L.q])
    np.testing.assert_array_equal(
        u_sol.numpy(), np.stack([x[:, L.d], us[:, :, 1]], axis=-1))


def test_small_horizon_solution_matches_jax():
    """tests/test_mpc.py's (2, 3) decoupled QP, which the JAX package
    holds to scipy: the port's `solve_qp` gives the JAX solve's iterate."""
    jcfg = JM.x1_decoupled_config(hz=JHP(N_short=2, N_long=3))
    tcfg = TM.x1_decoupled_config(hz=THP(N_short=2, N_long=3))
    tube = JT.straight_trajectory(100.0, 6.0, pad_to=16)
    opts = dict(max_iter=4000, eps_abs=1e-8, eps_rel=1e-8)

    @jax.jit
    def jax_side(q0):
        ts, dt = JM.compute_time_steps(jcfg.hz, 0.0)
        qs, us, ps = JM._nodes_decoupled(jcfg, tube, q0, jnp.zeros(3), ts,
                                         dt)
        qp = JD.build_qp(jcfg.veh, jcfg.decoupled, jcfg.hz,
                         JD.DecoupledStageData(dt=dt, qs=qs, us=us, ps=ps))
        return (dt, qs, us, ps), qp, JA.solve_qp(qp, opts=JSO(**opts))

    (dt, qs, us, ps), jqp, jsol = jax_side(
        jnp.array([0.3, 0.0, 0.02, 6.0, 0.0, 0.0]))
    tqp = TD.build_qp(tcfg.veh, tcfg.decoupled, tcfg.hz,
                      TD.DecoupledStageData(*[t64(a)[None] for a in
                                              (dt, qs, us, ps)]))
    for a, b in zip(jqp, tqp):
        _close(np.asarray(a), b[0].numpy(), 1e-12)
    tsol = TA.solve_qp(TA.QPData(*[t[0] for t in tqp]), opts=TSO(**opts))
    assert bool(jsol.converged) and bool(tsol.converged)
    assert int(tsol.iterations) == int(jsol.iterations)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=1e-9)


# ---------------------------------------------------------------------------
# The fleet step and the closed loop at float64
# ---------------------------------------------------------------------------

def _tube_cache(dtype=F64):
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    jcache = JH.inactive_cache()
    return (jtube, jcache,
            convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=dtype),
            convert.cache_from_numpy(cache_arrays(jcache), device="cpu"))


@pytest.fixture(scope="module")
def steps():
    jtube, jcache, ttube, tcache = _tube_cache()
    q0, t0 = straight_fleet(3)
    B = q0.shape[0]
    u0 = np.zeros((B, 3))
    oc = np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)).copy()
    jcfg, tcfg = JM.x1_decoupled_config(), TM.x1_decoupled_config()
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    J = jnp.asarray
    jstep = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, q, u, J(oc), t))
    jc1, ju1, jd1 = jstep(jc, J(q0), J(u0), J(t0))
    jc2, ju2, jd2 = jstep(jc1, J(q0), ju1, J(t0) + 0.01)

    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    assert tc.warm_x.shape == (B, 245) and tc.warm_y.shape == (B, 395)
    tc1, tu1, td1 = TM.mpc_step_batched(tcfg, ttube, tcache, tc, t64(q0),
                                        t64(u0), t64(oc), t64(t0))
    tc2, tu2, td2 = TM.mpc_step_batched(tcfg, ttube, tcache, tc1, t64(q0),
                                        tu1, t64(oc), t64(t0) + 0.01)
    return dict(jax=[(jc1, ju1, jd1), (jc2, ju2, jd2)],
                port=[(tc1, tu1, td1), (tc2, tu2, td2)])


def _same_diagnostics(jd, td):
    np.testing.assert_array_equal(td.converged.numpy(),
                                  np.asarray(jd.converged))
    np.testing.assert_array_equal(td.iterations.numpy(),
                                  np.asarray(jd.iterations))
    assert td.converged.all() and td.solution_finite.all()
    assert np.isinf(td.V_hji.numpy()).all() and not td.hji_active.any()
    np.testing.assert_allclose(td.s.numpy(), np.asarray(jd.s), rtol=1e-12)
    np.testing.assert_allclose(td.e.numpy(), np.asarray(jd.e), atol=1e-12)
    for name in ("prim_res", "dual_res"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   rtol=1e-6, atol=1e-12)


def _same_commands(ju, tu):
    d = np.abs(np.asarray(ju) - tu.numpy())
    assert np.all(np.isfinite(tu.numpy()))
    assert d[..., 0].max() < 1e-9 and d[..., 1:].max() < 1e-6, d


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_step_matches_jax(steps, k):
    (jc, ju, jd), (tc, tu, td) = steps["jax"][k], steps["port"][k]
    _same_commands(ju, tu)
    _same_diagnostics(jd, td)
    np.testing.assert_array_equal(tc.solved.numpy(), np.asarray(jc.solved))
    assert tc.q_prev.shape == (3, 31, 4)
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-9)
    np.testing.assert_allclose(tc.warm_x.numpy(), np.asarray(jc.warm_x),
                               atol=1e-9)
    # the JAX carry carried over through convert
    cc = convert.carry_from_numpy(carry_arrays(jc), device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name


def test_simulate_matches_jax():
    """`simulate` (and so `mpc_step`) of one vehicle, 3 closed-loop steps
    on the default solver."""
    jtube, jcache, ttube, tcache = _tube_cache()
    q0 = np.array([0.3, 0.2, 0.02, 5.0, 0.05, 0.0])
    jcfg, tcfg = JM.x1_decoupled_config(), TM.x1_decoupled_config()
    jlog = jax.jit(lambda q: JM.simulate(jcfg, jtube, jcache, q,
                                         n_steps=3))(jnp.asarray(q0))
    tlog = TM.simulate(tcfg, ttube, tcache, t64(q0), n_steps=3,
                       device="cpu")
    np.testing.assert_allclose(tlog.q.numpy(), np.asarray(jlog.q),
                               atol=1e-9)
    _same_commands(jlog.u, tlog.u)
    _same_diagnostics(jlog.diag, tlog.diag)


# ---------------------------------------------------------------------------
# The "pallas" pipeline at float32
# ---------------------------------------------------------------------------

def _residuals(qp, x, y):
    """Unscaled primal and dual residuals of (x, y) and their OSQP
    thresholds at eps (1e-3, 1e-3), in float64."""
    P, q, A, l, u = qp
    z = torch.clamp(TA._mv(A, x), l, u)
    Ax, Px, Aty = TA._mv(A, x), P * x, TA._mtv(A, y)
    amax = lambda v: v.abs().amax(dim=-1)
    r_prim, r_dual = amax(Ax - z), amax(Px + q + Aty)
    eps_p = 1e-3 + 1e-3 * torch.maximum(amax(Ax), amax(z))
    eps_d = 1e-3 + 1e-3 * torch.maximum(torch.maximum(amax(Px), amax(Aty)),
                                        amax(q))
    return r_prim / eps_p, r_dual / eps_d


def test_pallas_pipeline_within_solver_tolerance():
    _, _, ttube, tcache = _tube_cache(torch.float32)
    q0, t0 = straight_fleet(3)
    B = q0.shape[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    cfg = dataclasses.replace(TM.x1_decoupled_config(),
                              solver=TSO(**PALLAS))
    assert TM._a_pattern_for(cfg).build == "narrow"
    assert TM._banded_plan_for(cfg) is None
    carry = TM.init_carry(cfg, B, device="cpu")
    oc = f32(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, warm, aux = TM._pre_solve(cfg, ttube, tcache, carry, f32(q0),
                                  f32(np.zeros((B, 3))), oc, f32(t0))
    assert qp.A.shape == (B, 395, 245) and aux.w is None
    sol = TA.solve_qp_batched(qp, warm, cfg.solver,
                              a_pattern=TM._a_pattern_for(cfg))
    assert sol.converged.all() and (sol.iterations <= 400).all()
    qp64 = TA.QPData(*[t.double() for t in qp])
    xla = TA.solve_qp_batched(qp64, TA.cold_start(qp64),
                              TSO(**dict(PALLAS, backend="xla")))
    tight = TA.solve_qp_batched(qp64, TA.cold_start(qp64), TSO(**TIGHT))
    assert xla.converged.all() and tight.converged.all()
    hz = cfg.hz
    ref = TD.extract_control(hz, tight.x, aux.us.double())[:, 0]
    for got in (sol, xla):
        rp, rd = _residuals(qp64, got.x.double(), got.y.double())
        assert (rp <= 1.0).all() and (rd <= 1.0).all(), (rp, rd)
        delta = TD.extract_control(hz, got.x.double(), aux.us.double())[:, 0]
        assert (delta - ref).abs().max() < 2e-4, (delta, ref)


def test_carry_round_trip_full_horizon():
    """A JAX carry of the decoupled singleton (warm vectors of n = 245 /
    m = 395), filled with seeded values, through convert: the port's own
    carry's fields, dtypes and shapes, and the values as they were."""
    B = 4
    carry = JM.init_carry(JM.x1_decoupled_config(), dtype=jnp.float64)
    rng = np.random.default_rng(13)
    arrays = {}
    for name, v in carry_arrays(carry).items():
        shape = (B,) + v.shape
        arrays[name] = (rng.integers(0, 2, shape).astype(bool)
                        if v.dtype == bool else rng.normal(size=shape))
    cc = convert.carry_from_numpy(arrays, device="cpu", dtype=F64)
    tc = TM.init_carry(TM.x1_decoupled_config(), B, dtype=F64, device="cpu")
    assert cc.warm_x.shape == (B, 245) and cc.warm_y.shape == (B, 395)
    assert cc.q_prev.shape == (B, 31, 4)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), arrays[name])
