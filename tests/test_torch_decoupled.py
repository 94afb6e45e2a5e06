"""The decoupled soft formulation of the port against the JAX package, at
float64: the layout, the trim-seeded linearization nodes and the soft
condensed QP field by field, at the full horizon (10, 20) on the oval and
at a short horizon on the straight test path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64, tube_arrays
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.qp import decoupled as JQ
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.qp import decoupled as TQ

F64 = torch.float64


def test_layout_full_horizon():
    tl = TQ.get_soft_layout(THP(N_short=10, N_long=20))
    jl = JQ.get_soft_layout(JHP(N_short=10, N_long=20))
    assert (tl.n, tl.m) == (jl.n, jl.m) == (30, 180)
    assert tl.eq_rows.size == 0
    for name in ("u", "r_delta", "r_env", "r_rate", "_sp_rows", "_sp_cols",
                 "_sp_vals"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))


def _case(name):
    if name == "short":
        B = 3
        q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.02 * i]
                       for i in range(B)])
        u0 = np.stack([[0.01 * i, 100.0 * i, 50.0] for i in range(B)])
        return (3, 4), JT.straight_trajectory(60.0, 5.0, pad_to=32), q0, \
            u0, 0.3 * np.arange(B)
    q0, t0, cols = oval_fleet(4, seed=3)
    q0[:, 4] = [0.0, 0.1, -0.2, 0.05]
    q0[:, 5] = [0.0, 0.05, -0.1, 0.2]
    u0 = np.stack([[0.0, 0.0, 0.0], [0.02, 300.0, 200.0],
                   [-0.03, -500.0, -300.0], [0.01, 0.0, 900.0]])
    return (10, 20), JT.make_tube(**cols, pad_to=1024), q0, u0, t0


@pytest.fixture(scope="module", params=["short", "full"])
def assembled(request):
    (S, Lg), jtube, q0, u0, t0 = _case(request.param)
    jcfg = JM.x1_decoupled_config(hz=JHP(N_short=S, N_long=Lg), soft=True)
    tcfg = TM.x1_decoupled_config(hz=THP(N_short=S, N_long=Lg), soft=True)

    def jrun(q, u, t):
        ts, dt = JM.compute_time_steps(jcfg.hz, t)
        qs, us, ps = JM._nodes_decoupled(jcfg, jtube, q, u, ts, dt)
        sqp = JQ.build_qp_soft(jcfg.veh, jcfg.decoupled, jcfg.hz,
                               JQ.DecoupledStageData(dt=dt, qs=qs, us=us,
                                                     ps=ps))
        return (qs, us, ps), sqp

    jnodes, jqp = jax.jit(jax.vmap(jrun))(jnp.asarray(q0), jnp.asarray(u0),
                                          jnp.asarray(t0))

    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    ts, dt = TM.compute_time_steps(tcfg.hz, t64(t0))
    s0, e0, _ = TT.path_coordinates(ttube, t64(q0)[:, :2])
    tnodes = TM._nodes_decoupled(tcfg, ttube, t64(q0), t64(u0), ts, dt, s0,
                                 e0)
    data = TQ.DecoupledStageData(dt, *tnodes)
    tqp = TQ.build_qp_soft(tcfg.veh, tcfg.decoupled, tcfg.hz, data)
    tqp_dense = TQ.build_qp_soft(tcfg.veh, tcfg.decoupled, tcfg.hz, data,
                                 unbatched=True)
    return dict(jnodes=jnodes, jqp=jqp, tnodes=tnodes, tqp=tqp,
                tqp_dense=tqp_dense, S=S)


@pytest.mark.parametrize("k,name", [(0, "qs"), (1, "us"), (2, "ps")])
def test_nodes_match(assembled, k, name):
    """Same arithmetic at float64; the trim's fixed-point iterations and
    the table look-ups amplify rounding to ~1e-10."""
    t, j = assembled["tnodes"][k], np.asarray(assembled["jnodes"][k])
    assert t.shape == j.shape
    scale = max(1.0, np.abs(j).max())
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-9, atol=1e-9 * scale,
                               err_msg=name)


@pytest.mark.parametrize("field", ["P", "q", "A", "l", "u", "w", "G", "g"])
def test_qp_fields_match(assembled, field):
    """The structured route against the JAX assembly: float64 rounding
    through 4 squarings and a 30-stage rollout, 1e-8 of the field's
    scale.  Infinite bounds and weights must sit at the same entries."""
    t = getattr(assembled["tqp"], field).numpy()
    j = np.asarray(getattr(assembled["jqp"], field))
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    fin = np.isfinite(j)
    scale = max(1.0, np.abs(j[fin]).max())
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-8, atol=1e-8 * scale)


def test_qp_dense_route_matches_structured(assembled):
    """The single-vehicle route (dense Van Loan, sequential rollout)
    assembles the same QP (float64 rounding; the ZOH stages' Bf is
    rounding-level instead of exactly 0)."""
    for field in ("P", "q", "A", "l", "u", "G", "g"):
        a = getattr(assembled["tqp"], field).numpy()
        b = getattr(assembled["tqp_dense"], field).numpy()
        fin = np.isfinite(a)
        scale = max(1.0, np.abs(a[fin]).max())
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-9,
                                   atol=1e-9 * scale, err_msg=field)


def test_hard_rows_and_first_slew_row(assembled):
    w = assembled["tqp"].w.numpy()
    T = w.shape[1] // 6
    assert np.isinf(w[:, :T]).all()                    # delta rows hard
    assert np.isfinite(w[:, T:5 * T]).all()            # envelope soft
    np.testing.assert_array_equal(w[:, 5 * T], 1e3)    # first slew row
    assert np.isinf(w[:, 5 * T + 1:]).all()            # other slew hard
    qp = assembled["tqp"]
    assert not ((qp.u - qp.l) < 1e-10).any()           # no equality rows
