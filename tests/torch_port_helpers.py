"""Shared set-up of the tests that hold `pigeon_tpu_torch` against
`pigeon_tpu`: numpy views of JAX objects and the oval fleet."""

import numpy as np
import torch

from pigeon_tpu_torch import trajectory as TT

torch.set_num_threads(2)


def tube_arrays(jtube) -> dict:
    """A JAX TrajectoryTube as the numpy mapping `convert.tube_from_numpy`
    takes."""
    out = {k: np.asarray(getattr(jtube, k)) for k in TT.COLUMNS}
    out["n_valid"] = np.asarray(jtube.n_valid)
    for name in ("t_idx", "s_idx"):
        idx = getattr(jtube, name)
        out[name] = dict(table=np.asarray(idx.table), lo=np.asarray(idx.lo),
                         h=np.asarray(idx.h), fixups=idx.fixups)
    return out


def cache_arrays(jcache) -> dict:
    return dict(knots=[np.asarray(k) for k in jcache.knots],
                V=np.asarray(jcache.V),
                gradV=None if jcache.gradV is None
                else np.asarray(jcache.gradV),
                dims=jcache.dims, strides=jcache.strides)


def carry_arrays(jcarry) -> dict:
    return {k: np.asarray(v) for k, v in jcarry._asdict().items()}


def oval_fleet(B: int, seed: int = 0, k_max: int = 900):
    """bench.py's fleet placement on the in-repo oval: numpy (q0 (B, 6),
    t0 (B,)) and the oval's columns."""
    cols = TT.oval_columns()
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, k_max, B)
    E = cols["E"][k0] + rng.uniform(-0.5, 0.5, B)
    N = cols["N"][k0] + rng.uniform(-0.5, 0.5, B)
    psi = cols["psi"][k0] + rng.uniform(-0.05, 0.05, B)
    q0 = np.stack([E, N, psi, np.full(B, 6.0), np.zeros(B), np.zeros(B)],
                  axis=1)
    return q0, cols["t"][k0], cols


def straight_fleet(B: int = 3):
    """tests/test_soft.py's fleet for `trajectory.straight_trajectory`:
    numpy (q0 (B, 6), t0 (B,))."""
    q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.0]
                   for i in range(B)])
    return q0, np.zeros(B)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)
