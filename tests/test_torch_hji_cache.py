"""HJI caches of the port against the JAX package: the synthetic cache,
the central-difference gradient `grad_from_V`, the npz reader
`load_cache` on both caches the repository holds, and `interpolate` on a
cache read from disk."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigeon_tpu import hji as JH
from pigeon_tpu import hji_solve as JS
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import hji_solve as TS

ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "assets")
PROTO = os.path.join(ASSETS, "hji_cache_proto.npz")
MID = os.path.join(ASSETS, "hji_cache_mid.npz")


def _same_cache(t, j):
    """Every array of the port's cache equal to the JAX cache's."""
    assert t.dims == tuple(j.dims) and t.strides == tuple(j.strides)
    for tk, jk in zip(t.knots, j.knots):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(t.V.numpy(), np.asarray(j.V))
    assert t.V.dtype == torch.float32 and t.gradV.dtype == torch.float32
    np.testing.assert_array_equal(t.gradV.numpy(), np.asarray(j.gradV))


def test_synthetic_cache():
    """Both packages differentiate the surrogate at float64 and store it
    at float32: V within 1e-12, gradV within 1e-12 of the field's largest
    entry (the surrogate's soft minimum cancels O(1) terms, so a
    float64 gradient near zero carries ~1e-12 of rounding)."""
    j, t = JH.synthetic_cache(5), TH.synthetic_cache(5, device="cpu")
    assert t.dims == (5,) * 7 and t.gradV.shape == (7, 5 ** 7)
    np.testing.assert_allclose(t.V.numpy(), np.asarray(j.V), rtol=0,
                               atol=1e-12)
    jg = np.asarray(j.gradV)
    np.testing.assert_allclose(t.gradV.numpy(), jg, rtol=0,
                               atol=1e-12 * np.abs(jg).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_grad_from_V_random(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(2, 6, 7))
    knots = [np.sort(rng.uniform(-5, 5, 2)).astype(np.float32)[0]
             + np.arange(d, dtype=np.float32) * rng.uniform(0.1, 2.0)
             for d in dims]
    V = rng.standard_normal(dims).astype(np.float32)
    G = TS.grad_from_V(V, knots)
    assert G.shape == dims + (7,) and G.dtype == np.float32
    np.testing.assert_array_equal(G, JS.grad_from_V(V, knots))


def test_grad_from_V_mid_block():
    """A sub-block of the mid cache's value grid (its own edges
    replicated, as the whole grid's are)."""
    d = np.load(MID)
    knots = [d[f"knots_{i}"] for i in range(7)]
    V = np.ascontiguousarray(d["V"][20:30, 4:9, :, 1:5, :, 2:6, 3:])
    np.testing.assert_array_equal(TS.grad_from_V(V, knots),
                                  JS.grad_from_V(V, knots))


def test_load_cache_proto():
    _same_cache(TS.load_cache(PROTO, device="cpu"), JS.load_cache(PROTO))


def test_load_cache_mid():
    """The mid cache stores V only: gradV is `grad_from_V`'s, as the JAX
    package's reader builds it (its gradV compared here without building
    a second device copy)."""
    t = TS.load_cache(MID, device="cpu")
    d = np.load(MID)
    knots = [d[f"knots_{i}"] for i in range(7)]
    assert t.dims == (64, 16, 7, 7, 7, 7, 7)
    assert t.strides == tuple(s // 4 for s in d["V"].strides)
    np.testing.assert_array_equal(t.V.numpy(), d["V"].reshape(-1))
    G = JS.grad_from_V(d["V"], knots).reshape(-1, 7)
    for c in range(7):
        np.testing.assert_array_equal(t.gradV[c].numpy(), G[:, c])


def test_save_load_round_trip(tmp_path):
    """`save_cache` without the gradient writes what the JAX package's
    reader takes, and both readers rebuild the same gradV from it."""
    t = TH.synthetic_cache(4, device="cpu")
    path = str(tmp_path / "cache.npz")
    TS.save_cache(path, t, include_grad=False)
    assert "gradV" not in np.load(path).files
    _same_cache(TS.load_cache(path, device="cpu"), JS.load_cache(path))
    TS.save_cache(path, t)
    back = TS.load_cache(path, device="cpu")
    np.testing.assert_array_equal(back.gradV.numpy(), t.gradV.numpy())


def test_interpolate_loaded_cache():
    """`interpolate` on the proto cache read from disk, at seeded points
    inside the grid and outside it on each axis: V and gradV equal to the
    JAX package's up to float32 summation order; +inf and a zero
    gradient outside."""
    jc = JS.load_cache(PROTO)
    tc = TS.load_cache(PROTO, device="cpu")
    rng = np.random.default_rng(3)
    lo = np.array([float(k[0]) for k in jc.knots])
    hi = np.array([float(k[-1]) for k in jc.knots])
    inside = lo + (hi - lo) * rng.uniform(0.0, 1.0, (64, 7))
    outside = lo + (hi - lo) * rng.uniform(0.0, 1.0, (14, 7))
    for i in range(14):
        ax = i % 7
        outside[i, ax] = (lo[ax] - 0.1 * (hi[ax] - lo[ax]) if i < 7
                          else hi[ax] + 0.1 * (hi[ax] - lo[ax]))
    x = np.concatenate([inside, outside])
    jV, jg = jax.vmap(lambda p: JH.interpolate(jc, p))(jnp.asarray(x))
    tV, tg = TH.interpolate(tc, torch.as_tensor(x))
    jV, jg = np.asarray(jV), np.asarray(jg)
    assert np.all(np.isinf(tV[64:].numpy()))
    np.testing.assert_array_equal(tg[64:].numpy(), 0.0)
    np.testing.assert_array_equal(np.isinf(tV.numpy()), np.isinf(jV))
    scale = np.abs(np.asarray(jc.V)).max()
    np.testing.assert_allclose(tV[:64].numpy(), jV[:64], rtol=0,
                               atol=1e-6 * scale)
    gscale = np.abs(np.asarray(jc.gradV)).max(axis=1)
    assert np.all(np.abs(tg[:64].numpy() - jg[:64]) <= 1e-6 * gscale)
