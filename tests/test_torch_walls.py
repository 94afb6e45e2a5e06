"""The wall rows (`CoupledControlParams(use_walls=True)`, the reference's
both_walls configuration) of the port's three coupled QPs against the
JAX package at float64:

- the layouts of the sparse, the hard condensed and the soft condensed
  QP at horizons (2, 3) and (5, 10): n, m, the equality rows and every
  nonzero position of A (the soft QP: its row families);
- `build_qp` / `build_qp_soft` on nodes seeded along the oval with edges
  that vary per vehicle and node (rtol 1e-10);
- tests/test_runtime.py's unbatched walls scenario through both
  packages' `mpc_step`;
- the banded factor's stage plan (block width 14) and the carries'
  widths through `convert.carry_from_numpy`.

tests/test_torch_walls_step.py holds the closed loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_coupled_sparse import _stage_data as coupled_stage_data
from torch_port_helpers import t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import CoupledControlParams as JCP
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.qp import condensed as JQC
from pigeon_tpu.qp import coupled as JC
from pigeon_tpu.solver import banded as JB
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import CoupledControlParams as TCP
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.qp import condensed as TQC
from pigeon_tpu_torch.qp import coupled as TC
from pigeon_tpu_torch.solver import banded as TB

F64 = torch.float64
FORMS = ("sparse", "condensed", "soft")
# (n, m, equality rows) with wall rows at the live horizon
LIVE = {"sparse": (208, 335, 128), "condensed": (118, 245, 38),
        "soft": (30, 139, 0)}
EDGES = dict(edge_L=1.2, edge_R=-2.3)
# the solvers: the sparse and condensed QPs on the plain ADMM with
# chip_smoke.py's budget (400 in segments of 50; the condensed dense P
# takes the dense Cholesky), the soft QP on bench.py's lane options
HARD = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
            backend="xla", factor_method="banded", scaling_iters=4)
SOFT = dict(max_iter=150, check_every=150, eps_abs=1e-3, eps_rel=1e-3,
            backend="lanes", scaling_iters=2, pallas_check_inner=10)
HZ = (2, 3)


def _layouts(form, hz):
    jhz, thz = JHP(N_short=hz[0], N_long=hz[1]), THP(N_short=hz[0],
                                                       N_long=hz[1])
    if form == "sparse":
        return JC.get_layout(jhz, True), TC.get_layout(thz, True)
    if form == "condensed":
        return JQC.get_layout(jhz, True), TQC.get_layout(thz, True)
    return JQC.get_soft_layout(jhz, True), TQC.get_soft_layout(thz, True)


@pytest.mark.parametrize("hz", [(2, 3), (5, 10)], ids=["short", "live"])
@pytest.mark.parametrize("form", FORMS)
def test_wall_layouts_match(form, hz):
    jl, tl = _layouts(form, hz)
    assert (tl.n, tl.m) == (jl.n, jl.m)
    np.testing.assert_array_equal(tl.eq_rows, jl.eq_rows)
    if hz == (5, 10):
        assert (tl.n, tl.m, tl.eq_rows.size) == LIVE[form]
    if form == "soft":
        np.testing.assert_array_equal(tl.r_wall, jl.r_wall)
        np.testing.assert_array_equal(tl._sp_rows, jl._sp_rows)
        np.testing.assert_array_equal(tl._sp_cols, jl._sp_cols)
        return
    np.testing.assert_array_equal(tl.sw, jl.sw)
    np.testing.assert_array_equal(tl.lay._row_cat, jl.lay._row_cat)
    np.testing.assert_array_equal(tl.lay._col_cat, jl.lay._col_cat)
    assert tl.lay._sizes == jl.lay._sizes


def _configs(form, hz=HZ):
    kw = dict(soft=form == "soft", condensed=form == "condensed")
    opts = SOFT if form == "soft" else HARD
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=hz[0], N_long=hz[1]),
                                coupled=JCP(use_walls=True),
                                solver=JSO(**opts), **kw)
    tcfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                                coupled=TCP(use_walls=True),
                                solver=TSO(**opts), **kw)
    return jcfg, tcfg


def _stage_data(cfg, B=3):
    """tests/test_torch_coupled_sparse.py's stage data (cold nodes of an
    oval fleet, a random HJI row per vehicle) with edges that vary by
    vehicle and node."""
    d = coupled_stage_data(cfg, B)
    rng = np.random.default_rng(6)
    N = d["qs"].shape[1]
    d["edges"] = np.stack([rng.uniform(0.5, 2.0, (B, N)),
                           -rng.uniform(0.5, 2.5, (B, N))], axis=-1)
    return d


def _assert_qp_close(ref, out):
    for field in ref._fields:
        r = np.asarray(getattr(ref, field))
        o = getattr(out, field).numpy()
        assert o.shape == r.shape, field
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(o), finite, err_msg=field)
        np.testing.assert_array_equal(o[~finite], r[~finite], err_msg=field)
        np.testing.assert_allclose(o[finite], r[finite], rtol=1e-10,
                                   atol=1e-10 * np.abs(r[finite]).max(),
                                   err_msg=field)


@pytest.mark.parametrize("form", FORMS)
def test_build_qp_walls_matches_fp64(form):
    hz = (5, 10)
    cfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                               coupled=TCP(use_walls=True))
    jhz = JHP(N_short=hz[0], N_long=hz[1])
    d = _stage_data(cfg)
    jdata = JC.CoupledStageData(**{k: jnp.asarray(v) for k, v in d.items()})
    tdata = TC.CoupledStageData(**{k: t64(v) for k, v in d.items()})
    build = {"sparse": (JC.build_qp, TC.build_qp),
             "condensed": (JQC.build_qp, TQC.build_qp),
             "soft": (JQC.build_qp_soft, TQC.build_qp_soft)}[form]
    ref = jax.jit(jax.vmap(lambda s: build[0](cfg.veh, cfg.coupled, jhz,
                                              s)))(jdata)
    out = build[1](cfg.veh, cfg.coupled, cfg.hz, tdata)
    n, m, _ = LIVE[form]
    assert out.A.shape == (3, m, n)
    _assert_qp_close(ref, out)


# ---------------------------------------------------------------------------
# The unbatched route, the banded plan and the carries
# ---------------------------------------------------------------------------

def test_walls_unbatched_scenario():
    """tests/test_runtime.py's scenario: a left wall at e = +0.1 with
    margin 0.3, so the band is [-0.7, -0.2]; the port's plan settles at
    the band's edge, as the JAX package's does (commands within the bar
    of tests/test_torch_mpc.py, planned e within 1e-4 m)."""
    cols = dict(t=[0.0, 12.0], s=[0.0, 60.0], V=[5.0, 5.0], A=[0.0, 0.0],
                E=[0.0, 0.0], N=[0.0, 60.0], psi=[0.0, 0.0],
                kappa=[0.0, 0.0], edge_L=[0.1, 0.1], edge_R=[-1.0, -1.0])
    jtube = JT.make_tube(**cols, pad_to=32)
    q0 = np.array([0.5, 0.0, 0.0, 5.0, 0.0, 0.0])
    oc = np.array([1e4, 1e4, 0.0, 0.0])
    jcfg = dataclasses.replace(JM.x1_coupled_config(), coupled=JCP(
        use_walls=True, wall_margin=0.3))
    tcfg = dataclasses.replace(TM.x1_coupled_config(), coupled=TCP(
        use_walls=True, wall_margin=0.3))
    jcarry, ju, _ = jax.jit(lambda c: JM.mpc_step(
        jcfg, jtube, JH.inactive_cache(), c, jnp.asarray(q0), jnp.zeros(3),
        jnp.asarray(oc), 0.0))(JM.init_carry(jcfg, dtype=jnp.float64))
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    tcarry, tu, tdiag = TM.mpc_step(
        tcfg, ttube, TH.inactive_cache(device="cpu"),
        TM.init_carry(tcfg, None, dtype=F64, device="cpu"),
        t64(q0), t64(np.zeros(3)), t64(oc), 0.0)
    assert bool(tdiag.solution_finite)
    e_wall = tcarry.q_prev[:, 5].numpy()
    assert e_wall[-1] < -0.15 and np.all(e_wall[2:] < -0.1)
    np.testing.assert_allclose(e_wall, np.asarray(jcarry.q_prev[:, 5]),
                               atol=1e-4)
    d = np.abs(tu.numpy() - np.asarray(ju))
    assert d[0] < 2e-4 and d[1:].max() < 2.0, d


def test_walls_banded_plan():
    """The sparse QP's stage plan with the wall slack: block width 14 (6
    states, 2 controls, 2 envelope slacks, 2 slews, the wall slack and,
    on the short stages, the HJI slack), equal to the JAX package's, in
    the banded kernel's padded build."""
    hz = (5, 10)
    slots, n, bw, nb = TB.coupled_stage_plan(THP(N_short=5, N_long=10),
                                             True)
    jslots, jn, jbw, jnb = JB.coupled_stage_plan(
        JHP(N_short=hz[0], N_long=hz[1]), True)
    assert (n, bw, nb) == (jn, jbw, jnb) == (208, 14, 16)
    np.testing.assert_array_equal(slots, np.asarray(jslots))
    assert TB.chol_build(bw) == TB.BW_MAX


@pytest.mark.parametrize("form", FORMS)
def test_walls_carry_widths(form):
    """`init_carry` of a walls configuration has the JAX carry's shapes,
    and a JAX carry of those widths converts field by field."""
    jcfg, tcfg = _configs(form, (5, 10))
    jc = JM.init_carry(jcfg, dtype=jnp.float64)
    B = 2
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    n, m, _ = LIVE[form]
    assert tc.warm_x.shape == (B, n) and tc.warm_y.shape == (B, m)
    arrays = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
              for k, v in jc._asdict().items()}
    cc = convert.carry_from_numpy(arrays, device="cpu", dtype=F64)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), arrays[name])
