"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Loads the configuration and its kernels, warms up, steps the closed loop
for S seconds, compares a sample of what the window produced with the
plain reference, and prints one JSON object as the last line of standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`,
with --trace 1 `breakdown`, and last `checks` (each number compared,
with its limit).  The line before it is an "info" record; the last
lines of standard error repeat the numbers compared beside their limits.
It needs a CUDA device and exits non-zero, printing no result, without
one, when the run loads anything of the JAX side of the repository, or
when it writes outside its checkout and its given directories.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    shm_before = harness.shm_entries()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    try:
        cell = harness.Cell(ROOT, args.workload)
        need = int(cell.work["chips"])
        if torch.cuda.device_count() < need:
            print(f"{args.workload} needs {need} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", t0=T0)
    except (harness.RunError, FileNotFoundError, KeyError) as e:
        print(f"run failed: {e!r}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}; no result", file=sys.stderr)
        return 4
    new_shm = harness.shm_entries() - shm_before
    wrote = harness.written_bytes()
    if new_shm or wrote > harness.WRITE_LIMIT:
        print(f"the run wrote outside its places: /dev/shm {sorted(new_shm)}"
              f", {wrote} bytes", file=sys.stderr)
        return 5
    res = out["result"]
    print(json.dumps(dict(info=out["info"])), flush=True)
    for name, c in res["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
