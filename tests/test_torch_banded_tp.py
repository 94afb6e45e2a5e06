"""The tensor-parallel banded factor of the port
(`solver/banded.factor_inv_banded(tp_axis=...)`, the JAX package's
`factor_inv_banded` under shard_map) on a (1, tp) device mesh of 2 and 4
CPU processes over gloo, against the same factor without tp at float64,
on the Ruiz-scaled sparse QPs of tests/test_torch_banded.py's fleet; and
its raises outside a bound axis and with method "cr"."""

import numpy as np
import pytest

from torch_port_helpers import mesh_worker, scaled_sparse_qp, spawn_world
from pigeon_tpu_torch.solver import banded as TB


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_factor(tmp_path, world):
    """factor_inv_banded(tp_axis="tp") on a (1, world) mesh against the
    factor without tp, relative 1e-12 at float64 on the (5, 10) horizon
    (n_perm = 208) and the (2, 3) one (78: tp = 4 does not divide it,
    ValueError); every member holds the same bits."""
    outs = spawn_world(tmp_path, world, mesh_worker, {
        "factor": ("factor", dict(hz=[(5, 10), (2, 3)]))})["factor"]
    for out in outs:
        for hz in ("5_10", "2_3"):
            if world == 4 and hz == "2_3":
                assert "does not divide" in str(out[f"error_{hz}"])
                continue
            plain, tp = out[f"plain_{hz}"], out[f"tp_{hz}"]
            scale = np.abs(plain).max()
            assert np.abs(tp - plain).max() <= 1e-12 * scale
            np.testing.assert_array_equal(tp, outs[0][f"tp_{hz}"])


def test_tp_axis_needs_a_bound_axis():
    """Outside a sharded step the axis name is unbound: NameError, as in
    JAX; method "cr" refuses tp_axis, as in JAX."""
    Pb, Ab, rho, (slots, n, bw, nb) = scaled_sparse_qp((2, 3))
    with pytest.raises(NameError, match="unbound axis name: tp"):
        TB.factor_inv_banded(Pb, Ab, rho, 1e-6, slots, n, bw, nb,
                             tp_axis="tp")
    with pytest.raises(NotImplementedError):
        TB.factor_inv_banded(Pb, Ab, rho, 1e-6, slots, n, bw, nb,
                             tp_axis="tp", method="cr")
