"""pigeon_tpu_torch.viz against pigeon_tpu.viz: the (dE, dN) value
slice `hji_slice` on the proto cache (assets/hji_cache_proto.npz) at a
few relative states, and both plots written as PNG files under
matplotlib's Agg backend.

Both packages interpolate in float32 (the JAX package casts the point to
float32 whatever x64 says) and sum the 128 corners in another order.
Float32 rounding alone puts a slice up to 2.9 float32 ulps of the grid's
largest |V| from its float64 value (100 slices of either cache on the
CPU), so two float32 slices are held within twice that, 6 ulps (2.3e-5
on the proto cache), with +inf at the same points outside the grid."""

import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from pigeon_tpu import hji as JH
from pigeon_tpu import hji_solve as JS
from pigeon_tpu import viz as JV
from pigeon_tpu_torch import hji_solve as TS
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch import viz as TV

PROTO = os.path.join(os.path.dirname(__file__), os.pardir, "assets",
                     "hji_cache_proto.npz")
# float32 spacings at the grid's largest |V| between two float32 slices
SLICE_ULPS = 6
RELS = ([0.0, 0.0, 3.1, 6.0, 0.0, 5.0, 0.0],
        [0.0, 0.0, 2.5, 4.0, 0.3, 7.0, 0.2],
        [5.0, -1.0, -3.0, 8.0, -0.5, 3.0, -0.4])


@pytest.fixture(scope="module")
def caches():
    return TS.load_cache(PROTO, device="cpu"), JS.load_cache(PROTO)


def _jax_slice(jcache, rel, dE, dN):
    """The JAX package's slice at given axes: `pigeon_tpu.viz.hji_slice`'s
    own inner map (`hji.interpolate` at rel with dE, dN set)."""
    relj = jnp.asarray(rel)

    def at(e, n):
        return JH.interpolate(jcache, relj.at[0].set(e).at[1].set(n))[0]
    return np.asarray(jax.vmap(lambda e: jax.vmap(lambda n: at(e, n))(
        jnp.asarray(dN)))(jnp.asarray(dE)))


@pytest.mark.parametrize("rel", RELS, ids=["headon", "offset", "grid"])
def test_hji_slice_matches_jax(caches, rel):
    """The slice on the grid's extent (the default 41 x 41 points) and on
    a given one: the axes within float32 rounding of the JAX package's
    (which spaces them in float32, the port in float64), the values at
    the port's points within SLICE_ULPS of the JAX package's."""
    tcache, jcache = caches
    bar = SLICE_ULPS * np.spacing(tcache.V.abs().max().numpy())
    for kw in (dict(), dict(n_e=31, n_n=17, extent=(-5.0, 10.0, -4.0,
                                                    4.0))):
        dE, dN, V = TV.hji_slice(tcache, rel, **kw)
        jE, jN, _ = JV.hji_slice(jcache, rel, **kw)
        assert V.shape == (dE.size, dN.size) and V.dtype == np.float32
        assert dE.dtype == dN.dtype == np.float64
        np.testing.assert_allclose(dE, np.asarray(jE), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dN, np.asarray(jN), rtol=0, atol=1e-5)
        jV = _jax_slice(jcache, rel, dE, dN)
        fin = np.isfinite(jV)
        np.testing.assert_array_equal(np.isfinite(V), fin)
        assert fin.any()
        assert np.abs(V[fin] - jV[fin]).max() <= bar


def test_plots_write_png(caches, tmp_path):
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tcache, _ = caches
    ax = TV.plot_hji_slice(tcache, RELS[0], n_e=21, n_n=21)
    path = tmp_path / "slice.png"
    ax.figure.savefig(path)
    plt.close(ax.figure)
    tube = TT.make_tube(**TT.oval_columns(), pad_to=1024, device="cpu")
    log = TM.simulate(TM.x1_decoupled_config(soft=True), tube,
                      TS.hji_mod.inactive_cache(device="cpu"),
                      torch.tensor([0.3, 0.5, 0.03, 6.0, 0.0, 0.0]),
                      n_steps=4, device="cpu")
    fig = TV.plot_run(log, tube, path=str(tmp_path / "run.png"))
    plt.close(fig)
    for name in ("slice.png", "run.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
