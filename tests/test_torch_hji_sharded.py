"""The port's mesh-sharded HJI solver (`hji_solve.solve_hji_vi_sharded`,
`solve_hji(mesh=...)`) in 2 and 4 CPU processes over gloo, against the
port's whole-grid sweep and the JAX package's.

Each world is spawned fresh and meets through a FileStore in the test's
own directory (no port to race for between test workers); a join
timeout turns a hang into a failure.  On the smooth pursuit flow (no
argmax) the sharded sweep equals the whole-grid one to float64
roundoff; on the 7-D vehicle game the traces are held tightly and the
values at the JAX package's sharded bars (tests/test_hji_solve.py).
"""

import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import hji_sharded_worker
from pigeon_tpu import hji_solve as JS
from pigeon_tpu_torch import hji_solve as TS
from pigeon_tpu_torch.config import x1_params

JOIN_S = 120
SMOOTH = dict(n_sweeps=60)
VEHICLE = dict(shape=(8, 7, 5, 5, 3, 5, 3), n_sweeps=40, fx_samples=5,
               horizon_s=0.25, sweep_chunk=10)


def _spawn(tmp_path, world, case, kw):
    """Run hji_sharded_worker on `world` ranks; every rank's
    (V, deltas, times)."""
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / case)
    procs = [ctx.Process(target=hji_sharded_worker,
                         args=(r, world, str(tmp_path / "store"), out, case,
                               kw))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [np.load(f"{out}_{r}.npz") for r in range(world)]


@pytest.fixture(scope="module")
def smooth_refs():
    l, hs = TS.pursuit_target((40, 41))
    flow = TS.pursuit_flow(1.0)
    port = [x.numpy() for x in TS.solve_hji_vi(torch.as_tensor(l), hs, flow,
                                               **SMOOTH)]

    def jflow(start0, gradV):
        nrm = jnp.maximum(jnp.linalg.norm(gradV, axis=-1, keepdims=True),
                          1e-12)
        return -1.0 * gradV / nrm
    jax_ = [np.asarray(x) for x in JS.solve_hji_vi(jnp.asarray(l), hs, jflow,
                                                   **SMOOTH)]
    return port, jax_


@pytest.fixture(scope="module")
def vehicle_ref():
    cache, d, t = TS.solve_hji(x1_params(), dtype=torch.float64,
                               device="cpu", **VEHICLE)
    return cache.V.numpy(), d, t


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_smooth_flow(tmp_path, world, smooth_refs):
    """Every rank returns the whole V; it equals the port's and JAX's
    whole-grid sweeps to roundoff, with the same traces."""
    outs = _spawn(tmp_path, world, "smooth", SMOOTH)
    for out in outs[1:]:
        np.testing.assert_array_equal(out["V"], outs[0]["V"])
    for V, d, t in smooth_refs:
        np.testing.assert_allclose(outs[0]["times"], t, rtol=1e-13)
        np.testing.assert_allclose(outs[0]["deltas"], d, rtol=0, atol=1e-12)
        np.testing.assert_allclose(outs[0]["V"], V, rtol=0, atol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_vehicle(tmp_path, world, vehicle_ref):
    """solve_hji(mesh=...) on the 7-D game with the horizon break: the
    same sweeps and pseudo-time trace as the whole-grid solve, the
    updates to 1e-4, the values at the sharded bars."""
    outs = _spawn(tmp_path, world, "vehicle", VEHICLE)
    V, d, t = vehicle_ref
    assert len(t) < VEHICLE["n_sweeps"]
    for out in outs:
        np.testing.assert_array_equal(out["V"], outs[0]["V"])
        assert len(out["times"]) == len(t)
        np.testing.assert_allclose(out["times"], t, rtol=1e-12)
        np.testing.assert_allclose(out["deltas"], d, rtol=1e-4, atol=1e-4)
    err = np.abs(outs[0]["V"] - V)
    assert err.max() < 0.7 and err.mean() < 2e-3, (err.max(), err.mean())

