"""The JAX package's proto HJI solve on the CPU, held against the asset.

Runs `pigeon_tpu.hji_solve.solve_hji` at the settings that built
`assets/hji_cache_proto.npz` (HJI_PROD.json's proto phase: PROTO_SHAPE,
horizon 3.0 s, 1200 sweeps in chunks of 50 with the horizon break, 15 Fx
samples, cfl 0.5, local LF, margin 3.0, float32) and prints one JSON
line: the sweeps returned, the pseudo-time reached, the CPU seconds, and
the grid's agreement with the asset
(`pigeon_tpu_torch.hji_solve.value_agreement`).  This is the reading
that tells whether the current JAX code reproduces the asset; the
port's bars on the proto solve start from it.

    JAX_PLATFORMS=cpu python scripts/jax_hji_proto_cpu.py
"""

import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from pigeon_tpu import hji_solve as HS  # noqa: E402
from pigeon_tpu.config import x1_params  # noqa: E402
from pigeon_tpu_torch.hji_solve import value_agreement  # noqa: E402

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     os.pardir, "assets", "hji_cache_proto.npz")
HORIZON_S = 3.0


def main():
    t0 = time.perf_counter()
    cache, deltas, times = HS.solve_hji(
        x1_params(), shape=HS.PROTO_SHAPE, margin=3.0, n_sweeps=1200,
        fx_samples=15, sweep_chunk=50, horizon_s=HORIZON_S)
    V = np.asarray(cache.V).reshape(cache.dims)
    seconds = time.perf_counter() - t0
    print(json.dumps(dict(
        solver="pigeon_tpu (JAX) on the CPU, float32",
        sweeps=int(len(deltas)), t_reached_s=float(times[-1]),
        sweeps_to_horizon=int(np.searchsorted(times, HORIZON_S)),
        cpu_seconds=seconds,
        against_asset=value_agreement(V, np.load(ASSET)["V"]))), flush=True)


if __name__ == "__main__":
    main()
