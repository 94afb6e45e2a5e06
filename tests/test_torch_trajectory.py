"""pigeon_tpu_torch.trajectory against pigeon_tpu.trajectory at float64 on
the straight test path and the numpy-built oval that chip_smoke.py drives:
time and arclength lookups (past both ends too) and path projection (far
off the path too)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import t64, tube_arrays
from pigeon_tpu import trajectory as JT
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import trajectory as TT

RTOL, ATOL = 1e-10, 1e-9


def _tubes(kind):
    if kind == "straight":
        return (JT.straight_trajectory(60.0, 5.0, pad_to=32),
                TT.straight_trajectory(60.0, 5.0, pad_to=32, device="cpu",
                                       dtype=t64(0).dtype))
    cols = TT.oval_columns()
    return (JT.make_tube(**cols, pad_to=1024),
            TT.make_tube(**cols, pad_to=1024, device="cpu",
                         dtype=t64(0).dtype))


def _compare_nodes(out, ref, fields):
    for name in ("t", "s", "V", "A") + tuple(fields):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind", ["straight", "oval"])
def test_tube_columns_and_index(kind):
    jt, tt = _tubes(kind)
    for name in TT.COLUMNS + ("packed",):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    assert tt.n_valid == int(jt.n_valid)
    for name in ("t_idx", "s_idx"):
        a, b = getattr(tt, name), getattr(jt, name)
        np.testing.assert_array_equal(a.table.numpy(), np.asarray(b.table))
        assert (a.lo, a.h, a.fixups) == (float(b.lo), float(b.h), b.fixups)
    # the JAX tube carried over through convert is the same tube
    ct = convert.tube_from_numpy(tube_arrays(jt), device="cpu",
                                 dtype=t64(0).dtype)
    for name in TT.COLUMNS + ("packed",):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      getattr(tt, name).numpy())


@pytest.mark.parametrize("kind", ["straight", "oval"])
def test_eval_time_and_arclength(kind):
    jt, tt = _tubes(kind)
    rng = np.random.default_rng(0)
    t_end = float(np.asarray(jt.t)[int(jt.n_valid) - 1])
    s_end = float(np.asarray(jt.s)[int(jt.n_valid) - 1])
    ts = np.concatenate([rng.uniform(0.0, t_end, 64),
                         [-1.0, 0.0, t_end, t_end + 3.0, 1e4]])
    ss = np.concatenate([rng.uniform(0.0, s_end, 64),
                         [-2.0, 0.0, s_end, s_end + 7.0, 1e4]])
    fields = ("E", "N", "psi", "kappa", "edge_L")
    ref = jax.vmap(lambda t: JT.eval_time(jt, t, fields=fields))(
        jnp.asarray(ts))
    _compare_nodes(TT.eval_time(tt, t64(ts), fields=fields), ref, fields)
    ref = jax.vmap(lambda s: JT.eval_arclength(jt, s, fields=fields))(
        jnp.asarray(ss))
    _compare_nodes(TT.eval_arclength(tt, t64(ss), fields=fields), ref,
                   fields)
    # a (B, T) query keeps its shape
    out = TT.eval_time(tt, t64(ts[:60]).reshape(6, 10), fields=())
    assert out.s.shape == (6, 10) and out.E is None


@pytest.mark.parametrize("kind", ["straight", "oval"])
def test_path_coordinates(kind):
    jt, tt = _tubes(kind)
    rng = np.random.default_rng(1)
    n = int(jt.n_valid)
    k = rng.integers(0, n, 48)
    pts = np.stack([np.asarray(jt.E)[k] + rng.uniform(-2, 2, 48),
                    np.asarray(jt.N)[k] + rng.uniform(-2, 2, 48)], axis=1)
    pts = np.concatenate([pts, [[1e5, -1e5], [-300.0, 40.0], [0.0, -50.0]]])
    ref = jax.vmap(lambda x: JT.path_coordinates(jt, x))(jnp.asarray(pts))
    out = TT.path_coordinates(tt, t64(pts))
    for o, r, name in zip(out, ref, ("s", "e", "t")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_path_coordinates_ties_take_first_segment():
    """On a path whose two halves are equally far from the query, the
    projection takes the first minimum, as jnp.argmin."""
    cols = dict(t=[0.0, 1.0, 2.0, 3.0], s=[0.0, 10.0, 20.0, 30.0],
                V=[10.0] * 4, A=[0.0] * 4, E=[0.0, 0.0, 0.0, 0.0],
                N=[0.0, 10.0, 10.0, 0.0], psi=[0.0] * 4, kappa=[0.0] * 4)
    jt = JT.make_tube(**cols)
    tt = TT.make_tube(**cols, device="cpu", dtype=t64(0).dtype)
    x = np.array([[1.0, 5.0]])
    ref = jax.vmap(lambda p: JT.path_coordinates(jt, p))(jnp.asarray(x))
    out = TT.path_coordinates(tt, t64(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL)
    assert float(out[0][0]) == pytest.approx(5.0)


def test_math_utils_match():
    from pigeon_tpu import math_utils as JMU
    from pigeon_tpu_torch import math_utils as TMU

    rng = np.random.default_rng(2)
    x = np.cumsum(rng.uniform(0.1, 1.0, 50))
    y = rng.uniform(1.0, 5.0, 50)
    for name in ("cumtrapz", "invcumtrapz"):
        np.testing.assert_allclose(
            getattr(TMU, name)(t64(y), t64(x), 2.0).numpy(),
            np.asarray(getattr(JMU, name)(jnp.asarray(y), jnp.asarray(x),
                                          2.0)), rtol=1e-12)
    a, b = rng.uniform(-20, 20, 50), rng.uniform(-20, 20, 50)
    np.testing.assert_allclose(TMU.adiff(t64(a), t64(b)).numpy(),
                               np.asarray(JMU.adiff(a, b)), rtol=1e-12,
                               atol=1e-12)
    v, w = rng.normal(size=(50, 2)), rng.normal(size=(50, 2))
    np.testing.assert_allclose(TMU.cross2(t64(v), t64(w)).numpy(),
                               np.asarray(JMU.cross2(v, w)), rtol=1e-12)
