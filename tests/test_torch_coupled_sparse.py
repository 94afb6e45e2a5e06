"""pigeon_tpu_torch.qp.coupled (the sparse coupled QP) against
pigeon_tpu.qp.coupled at float64: the layout (n, m, equality rows and
the order of the nonzero entries) at the live horizon (5, 10) and at
(2, 3), the QP assembly on nodes seeded along the oval, and the solution
extraction."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.qp import coupled as JC
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.qp import coupled as TC

# horizon -> (n, m, equality rows)
HORIZONS = {"live": ((5, 10), (193, 290, 128)),
            "short": ((2, 3), (70, 104, 48))}


def _cfg(hz):
    return TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]))


def _stage_data(cfg, B=3):
    """Cold nodes of an oval fleet (the port's seeding, float64) and a
    random HJI half-plane row per vehicle; the last vehicle's row is the
    inactive one (M = 0, b = 1)."""
    q0, t0, cols = oval_fleet(B, seed=5)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    ts, dt = TM.compute_time_steps(cfg.hz, t64(t0))
    q0 = t64(q0)
    u0 = t64(np.tile([0.02, 300.0, 200.0], (B, 1)))
    s0, e0, _ = TT.path_coordinates(tube, q0[:, :2])
    qs, us, ps = TM._nodes_coupled_cold(cfg, tube, q0, u0, ts, dt, s0, e0)
    rng = np.random.default_rng(6)
    M = rng.normal(size=(B, 2)) * [1.0, 1e-4]
    b = rng.normal(size=B)
    M[-1], b[-1] = 0.0, 1.0
    return dict(dt=dt.numpy(), qs=qs.numpy(), us=us.numpy(), ps=ps.numpy(),
                hji_M=M, hji_b=b)


@pytest.mark.parametrize("name", list(HORIZONS))
def test_layout_matches(name):
    (S, Lg), (n, m, m_eq) = HORIZONS[name]
    jl = JC.get_layout(JHP(N_short=S, N_long=Lg))
    tl = TC.get_layout(THP(N_short=S, N_long=Lg))
    assert (tl.n, tl.m, tl.eq_rows.size) == (jl.n, jl.m,
                                             jl.eq_rows.size) == (n, m, m_eq)
    np.testing.assert_array_equal(tl.eq_rows, jl.eq_rows)
    for name_ in ("q", "u", "sig", "sHJI", "dd", "dF"):
        np.testing.assert_array_equal(getattr(tl, name_), getattr(jl, name_))
    np.testing.assert_array_equal(tl.lay._row_cat, jl.lay._row_cat)
    np.testing.assert_array_equal(tl.lay._col_cat, jl.lay._col_cat)
    assert tl.lay._sizes == jl.lay._sizes


def test_wall_layout_matches():
    hz = (2, 3)
    jl = JC.get_layout(JHP(N_short=hz[0], N_long=hz[1]), True)
    tl = TC.get_layout(THP(N_short=hz[0], N_long=hz[1]), True)
    assert (tl.n, tl.m) == (jl.n, jl.m)
    np.testing.assert_array_equal(tl.sw, jl.sw)
    np.testing.assert_array_equal(tl.lay._row_cat, jl.lay._row_cat)
    np.testing.assert_array_equal(tl.lay._col_cat, jl.lay._col_cat)


@pytest.mark.parametrize("name", list(HORIZONS))
def test_build_qp_matches_fp64(name):
    (S, Lg), (n, m, _) = HORIZONS[name]
    cfg = _cfg((S, Lg))
    jcfg_hz = JHP(N_short=S, N_long=Lg)
    d = _stage_data(cfg)
    ref = jax.jit(jax.vmap(lambda s: JC.build_qp(
        cfg.veh, cfg.coupled, jcfg_hz, s)))(
        JC.CoupledStageData(**{k: jnp.asarray(v) for k, v in d.items()}))
    out = TC.build_qp(cfg.veh, cfg.coupled, cfg.hz,
                      TC.CoupledStageData(**{k: t64(v) for k, v in d.items()}))
    assert out.A.shape == (3, m, n) and out.P_diag.shape == (3, n)
    for field in ref._fields:
        r = np.asarray(getattr(ref, field))
        o = getattr(out, field).numpy()
        assert o.shape == r.shape, field
        finite = np.isfinite(r)
        assert (~finite).any() == (field in ("l", "u")), field
        np.testing.assert_array_equal(np.isfinite(o), finite, err_msg=field)
        np.testing.assert_array_equal(o[~finite], r[~finite], err_msg=field)
        np.testing.assert_allclose(o[finite], r[finite], rtol=1e-10,
                                   atol=1e-10 * np.abs(r[finite]).max(),
                                   err_msg=field)


def test_build_qp_unbatched_route_matches():
    """The single-vehicle route (dense stage exponential) assembles the
    same QP as the fleet route, to float64 rounding."""
    cfg = _cfg((2, 3))
    d = _stage_data(cfg, B=1)
    data = TC.CoupledStageData(**{k: t64(v) for k, v in d.items()})
    fleet = TC.build_qp(cfg.veh, cfg.coupled, cfg.hz, data)
    single = TC.build_qp(cfg.veh, cfg.coupled, cfg.hz, data, unbatched=True)
    for a, b in zip(fleet, single):
        finite = torch.isfinite(a)
        assert torch.equal(finite, torch.isfinite(b))
        np.testing.assert_allclose(b[finite].numpy(), a[finite].numpy(),
                                   rtol=1e-9, atol=1e-9)


def test_extract_matches():
    rng = np.random.default_rng(7)
    B = 3
    cfg = _cfg((5, 10))
    jhz = JHP(N_short=5, N_long=10)
    x = rng.normal(size=(B, 193))
    ref_u = jax.vmap(lambda v: JC.extract_control(cfg.veh, jhz, v))(
        jnp.asarray(x))
    ref_q, ref_uu = jax.vmap(lambda v: JC.extract_trajectory(
        jhz, v, cfg.veh))(jnp.asarray(x))
    np.testing.assert_allclose(
        TC.extract_control(cfg.veh, cfg.hz, t64(x)).numpy(),
        np.asarray(ref_u), rtol=1e-14)
    q_sol, u_sol = TC.extract_trajectory(cfg.hz, t64(x), cfg.veh)
    assert q_sol.shape == (B, 16, 6) and u_sol.shape == (B, 16, 2)
    np.testing.assert_allclose(q_sol.numpy(), np.asarray(ref_q), rtol=1e-14)
    np.testing.assert_allclose(u_sol.numpy(), np.asarray(ref_uu), rtol=1e-14)


def test_unported_build_options_raise():
    """The options that raised before the RK4 linearization and the wall
    rows were ported now build, with the JAX package's shapes: "rk4"
    (n = 70, m = 104 at (2, 3)) and the wall rows (n = 75, m = 119)
    (tests/test_torch_rk4_qp.py and tests/test_torch_walls.py hold the
    values)."""
    cfg = _cfg((2, 3))
    d = _stage_data(cfg)
    N = d["qs"].shape[1]
    d["edges"] = np.stack([np.full((3, N), 1.2), np.full((3, N), -2.3)],
                          axis=-1)
    data = TC.CoupledStageData(**{k: t64(v) for k, v in d.items()})
    jdata = JC.CoupledStageData(**{k: jnp.asarray(v)[0]
                                   for k, v in d.items()})
    jhz = JHP(N_short=2, N_long=3)
    walls = dataclasses.replace(cfg.coupled, use_walls=True)
    for ctl, kw, (n, m) in ((cfg.coupled, dict(lin_method="rk4"), (70, 104)),
                            (walls, {}, (75, 119))):
        qp = TC.build_qp(cfg.veh, ctl, cfg.hz, data, **kw)
        ref = jax.eval_shape(lambda s: JC.build_qp(cfg.veh, ctl, jhz, s,
                                                   **kw), jdata)
        assert qp.A.shape == (3,) + ref.A.shape == (3, m, n)
        for a, r in zip(qp, ref):
            assert a.shape == (3,) + r.shape
