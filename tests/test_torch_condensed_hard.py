"""The hard condensed coupled QP (`x1_coupled_config(condensed=True)`:
soft=False, the states eliminated through the rollout map, a dense P) in
the port against the JAX package at float64, on the straight test path
(3 vehicles, horizon (2, 3) unless stated):

- the layout (n, m, equality rows, the [q0; u] columns) and the static
  ELL pattern of A the dense ADMM kernel reads;
- `build_qp`'s P, q, A, l, u, G, g at horizon (2, 3) and (5, 10), to
  1e-10 of each array's scale, and `extract_control` /
  `extract_trajectory`;
- the "chol" fallbacks of `_factor_inv` and the carry of the live
  horizon through `convert`.

tests/test_torch_condensed_step.py holds the fleet step and
tests/test_torch_condensed_pallas.py the "pallas" pipeline and the
single-vehicle route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (cache_arrays, carry_arrays, straight_fleet,
                                t64, tube_arrays)
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.qp import condensed as JC
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.qp import condensed as TC
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver import pallas_admm as TP

F64 = torch.float64
XLA = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
           backend="xla", factor_method="chol", scaling_iters=4)


def _configs(hz=(2, 3), opts=XLA):
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=hz[0], N_long=hz[1]),
                                condensed=True, solver=JSO(**opts))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                                condensed=True, solver=TSO(**opts))
    return jcfg, tcfg


def _far(B):
    return np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)).copy()


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hz", [(2, 3), (5, 10)], ids=str)
def test_layout_matches(hz):
    jl = JC.get_layout(JHP(N_short=hz[0], N_long=hz[1]))
    tl = TC.get_layout(THP(N_short=hz[0], N_long=hz[1]))
    assert (tl.n, tl.m) == (jl.n, jl.m)
    for name in ("q0", "u", "sig", "sHJI", "dd", "dF", "gcols", "eq_rows"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))
    np.testing.assert_array_equal(tl.lay._row_cat, jl.lay._row_cat)
    np.testing.assert_array_equal(tl.lay._col_cat, jl.lay._col_cat)
    if hz == (5, 10):
        assert (tl.n, tl.m, tl.eq_rows.size) == (103, 200, 38)


def test_ell_pattern_of_the_live_horizon():
    """The static pattern the "pallas" pipeline hands the dense ADMM
    kernel: every position the layout writes, its widths, its 16-bit
    slots, and the kernel's shared memory with and without the dense P
    (csrc/admm_dense.cu's `smem_bytes`)."""
    _, tcfg = _configs((5, 10), dict(XLA, backend="pallas"))
    pat = TM._a_pattern_for(tcfg)
    lay = TM._layout(tcfg).lay
    assert isinstance(TM._layout(tcfg), TC.CondensedLayout)
    assert pat is TP.layout_pattern(lay)
    assert pat.nnz == np.unique(lay._row_cat * lay.n + lay._col_cat).size
    assert (pat.nnz, pat.row_width, pat.col_width) == (3105, 39, 79)
    assert pat.m * pat.row_width == 7800 <= TP.SLOTS_MAX
    assert TP.plan_smem(103, 200, 39, 79) == 146712
    assert TP.plan_smem(103, 200, 39, 79, dense_P=True) == 189148
    # the next longer condensed horizon, (5, 12): n=115, m=224, widths 43
    # and 89, does not fit with its dense P
    with pytest.raises(ValueError):
        TP.plan_smem(115, 224, 43, 89, dense_P=True)
    assert TM._eq_rows_for(tcfg).size == 38
    assert TM._banded_plan_for(tcfg) is None


# ---------------------------------------------------------------------------
# Assembly and extraction
# ---------------------------------------------------------------------------

def _assemble(hz):
    """Both packages' `_pre_solve` on the same cold fleet (JAX vmapped)."""
    jcfg, tcfg = _configs(hz)
    q0, t0 = straight_fleet(3)
    B = q0.shape[0]
    jtube = JT.straight_trajectory(100.0, 5.0, pad_to=32)
    jcache = JH.inactive_cache()
    carry = JM.init_carry(jcfg, dtype=jnp.float64)
    oc = _far(B)
    jqp, _, jaux = jax.jit(jax.vmap(lambda q, o, t: JM._pre_solve(
        jcfg, jtube, jcache, carry, q, jnp.zeros(3), o, t, "auto")))(
        jnp.asarray(q0), jnp.asarray(oc), jnp.asarray(t0))
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    tqp, _, taux = TM._pre_solve(
        tcfg, ttube, tcache, TM.init_carry(tcfg, B, dtype=F64, device="cpu"),
        t64(q0), t64(np.zeros((B, 3))), t64(oc), t64(t0))
    return (jqp, jaux), (tqp, taux)


@pytest.fixture(scope="module", params=[(2, 3), (5, 10)], ids=str)
def assembled(request):
    return request.param, _assemble(request.param)


def test_build_qp_matches(assembled):
    hz, ((jqp, jaux), (tqp, taux)) = assembled
    L = TC.get_layout(THP(N_short=hz[0], N_long=hz[1]))
    assert tqp.P_diag.shape == (3, L.n, L.n)
    pairs = list(zip("PqAlu", jqp, tqp)) + [("G", jaux.G, taux.G),
                                           ("g", jaux.g, taux.g)]
    for name, j, t in pairs:
        j, t = np.asarray(j), t.numpy()
        assert t.shape == j.shape, name
        fin = np.isfinite(j)
        np.testing.assert_array_equal(np.isfinite(t), fin, err_msg=name)
        np.testing.assert_array_equal(t[~fin], j[~fin], err_msg=name)
        scale = np.abs(j[fin]).max()
        assert np.abs(t[fin] - j[fin]).max() <= 1e-10 * scale, name
    # the dense Hessian is symmetric (to the einsum's rounding), and dense
    # only over [q0; u]
    P = tqp.P_diag.numpy()
    np.testing.assert_allclose(P, np.swapaxes(P, 1, 2), rtol=0,
                               atol=1e-14 * np.abs(P).max())
    off = np.ones(L.n, bool)
    off[L.gcols] = False
    assert not np.any(P[:, off][:, :, off] - np.stack(
        [np.diag(np.diag(p[off][:, off])) for p in P]))


def test_extract_matches(assembled):
    hz, ((_, jaux), (_, taux)) = assembled
    jcfg, tcfg = _configs(hz)
    L = TC.get_layout(tcfg.hz)
    x = np.random.default_rng(5).normal(size=(3, L.n))
    tu = TC.extract_control(tcfg.veh, tcfg.hz, t64(x))
    tq, tus = TC.extract_trajectory(tcfg.hz, t64(x), tcfg.veh, taux.G,
                                    taux.g)
    for b in range(3):
        ju = JC.extract_control(jcfg.veh, jcfg.hz, jnp.asarray(x[b]))
        jq, jus = JC.extract_trajectory(jcfg.hz, jnp.asarray(x[b]),
                                        jcfg.veh, jaux.G[b], jaux.g[b])
        np.testing.assert_allclose(tu[b].numpy(), np.asarray(ju),
                                   rtol=1e-14)
        np.testing.assert_allclose(tus[b].numpy(), np.asarray(jus),
                                   rtol=1e-14)
        np.testing.assert_allclose(tq[b].numpy(), np.asarray(jq),
                                   rtol=1e-12, atol=1e-12)
    assert tq.shape == (3, tcfg.hz.N, 6) and tus.shape == (3, tcfg.hz.N, 2)


# ---------------------------------------------------------------------------
# The carry
# ---------------------------------------------------------------------------

def test_carry_round_trip_full_horizon():
    """A JAX carry of the live horizon (warm vectors of n=103 / m=200),
    filled with seeded values, through convert: the port's own carry's
    fields, dtypes and shapes, and the values as they were."""
    B = 4
    jcfg = JM.x1_coupled_config(condensed=True)
    tcfg = TM.x1_coupled_config(condensed=True)
    rng = np.random.default_rng(11)
    arrays = {}
    for name, v in carry_arrays(JM.init_carry(jcfg,
                                              dtype=jnp.float64)).items():
        shape = (B,) + v.shape
        arrays[name] = (rng.integers(0, 2, shape).astype(bool)
                        if v.dtype == bool else rng.normal(size=shape))
    cc = convert.carry_from_numpy(arrays, device="cpu", dtype=F64)
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    assert cc.warm_x.shape == (B, 103) and cc.warm_y.shape == (B, 200)
    for name in TM.MPCCarry._fields:
        a, b = getattr(cc, name), getattr(tc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), arrays[name])


# ---------------------------------------------------------------------------
# The "chol" fallbacks of the factor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["banded", "banded_cr"])
def test_factor_falls_through_to_chol(assembled, method):
    """"banded" and "banded_cr" with a dense P, or without a stage plan,
    take the dense Cholesky inverse, as the JAX package's `_factor_inv`
    does (admm.py:160-168): the same bits as factor_method "chol"."""
    _, (_, (tqp, _)) = assembled
    (Pb, _, Ab, _, _), _, _, _ = TA.ruiz(tqp, 4)
    rho = torch.where((tqp.u - tqp.l) < 1e-10, 100.0, 0.1).to(F64)
    chol = TA._factor_inv(Pb, Ab, rho, 1e-6, TSO(factor_method="chol"))
    dense = TA._factor_inv(Pb, Ab, rho, 1e-6, TSO(factor_method=method))
    assert torch.equal(dense, chol)
    # a diagonal P without a plan falls through too
    Pd = torch.diagonal(Pb, dim1=-2, dim2=-1).contiguous()
    assert torch.equal(
        TA._factor_inv(Pd, Ab, rho, 1e-6, TSO(factor_method=method)),
        TA._factor_inv(Pd, Ab, rho, 1e-6, TSO(factor_method="chol")))
    K = (Ab.transpose(-1, -2) * rho[:, None, :]) @ Ab + Pb \
        + 1e-6 * torch.eye(Pb.shape[-1], dtype=F64)
    eye = torch.eye(Pb.shape[-1], dtype=F64)
    assert float((K @ chol - eye).abs().max()) < 1e-6
    with pytest.raises(ValueError, match="unknown factor_method"):
        TA._factor_inv(Pb, Ab, rho, 1e-6, TSO(factor_method="lu"))
