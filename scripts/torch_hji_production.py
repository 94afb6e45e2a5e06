"""Solve the HJI value caches on the card with the PyTorch port.

The port's counterpart of scripts/hji_production.py's proto, mid and
production phases, at their settings (HJI_PROD.json):

- proto: PROTO_SHAPE (1.8M points), whole-grid sweeps at the CFL step,
  the cache with its gradient field;
- mid: (64, 16, 7, 7, 7, 7, 7) (17.2M points) and production:
  DEFAULT_SHAPE (241.9M points), both stored in PROD_AXIS_ORDER and swept
  slab by slab (slab_chunk=1), the step capped at 0.0022 s, V only;

each to the pseudo-time horizon (3.0 s) in launches of 50 sweeps with
the horizon break, 15 Fx samples, float32.  Prints one JSON line a
phase: sweeps, pseudo-time reached, run seconds and ms a sweep, the
device's peak memory, the card's name and power limit, and, where the
repository holds the JAX package's cache of the phase
(`assets/hji_cache_{proto,mid}.npz`), the agreement with it
(`hji_solve.value_agreement`).  The cache is written to --out-dir
(default `hji_caches/`, which git ignores), never to `assets/`.

    python scripts/torch_hji_production.py --phase proto|mid|production
           [--sweeps 2000] [--horizon 3.0] [--out-dir hji_caches]

It needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

from pigeon_tpu_torch import hji_solve as HS  # noqa: E402
from pigeon_tpu_torch.config import x1_params  # noqa: E402

MID_SHAPE = (64, 16, 7, 7, 7, 7, 7)
DT_FIXED = 0.0022
SLABS = dict(slab_chunk=1, dt_fixed=DT_FIXED,
             axis_order=HS.PROD_AXIS_ORDER, with_grad=False)
PHASES = {"proto": dict(shape=HS.PROTO_SHAPE),
          "mid": dict(shape=MID_SHAPE, **SLABS),
          "production": dict(shape=HS.DEFAULT_SHAPE, **SLABS)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", required=True, choices=sorted(PHASES))
    ap.add_argument("--sweeps", type=int, default=2000,
                    help="most sweeps; the horizon break ends the solve "
                         "after the launch that reaches the horizon")
    ap.add_argument("--horizon", type=float, default=3.0)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "hji_caches"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hji_production: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kw = PHASES[args.phase]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, deltas, times = HS.solve_hji(
        x1_params(), n_sweeps=args.sweeps, fx_samples=15, sweep_chunk=50,
        horizon_s=args.horizon, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    rec = dict(phase=args.phase, nvidia_smi=smi, shape=list(kw["shape"]),
               grid_points=int(np.prod(kw["shape"])),
               slab_chunk=kw.get("slab_chunk", 0),
               dt_fixed=kw.get("dt_fixed"), horizon_s=args.horizon,
               sweeps=int(len(deltas)),
               sweeps_to_horizon=(int(np.searchsorted(times, args.horizon))
                                  if times[-1] >= args.horizon else None),
               pseudo_time_reached_s=float(times[-1]),
               run_s=run_s, ms_per_sweep=run_s / len(deltas) * 1e3,
               delta_first=float(deltas[0]), final_delta_sup=float(deltas[-1]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    asset = os.path.join(ROOT, "assets", f"hji_cache_{args.phase}.npz")
    if os.path.exists(asset):
        rec["against_asset"] = HS.value_agreement(
            cache.V.cpu().numpy(), np.load(asset)["V"].reshape(-1))
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"hji_cache_{args.phase}.npz")
    HS.save_cache(path, cache, include_grad=cache.gradV is not None)
    rec["cache_file"] = os.path.relpath(path, ROOT)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
