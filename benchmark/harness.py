"""One run of one cell: set-up, warm-up, the measured window, the traced
periods, the comparison with the reference, and the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file under `benchmark/` of the checkout, found by
its name in `BENCHMARK.json`: `configs/<config>.json` (the entry's
`file`), `traffic/<mix>.json` and the generator module it names,
`cells/<workload>.json` (the limits of the numbers compared) and
`metrics/<metric>.py` (a reader: `read(rec) -> float | None`).  The
harness itself knows none of them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import loop
from benchmark.program import Program
from benchmark.reference import controller as ref_ct
from benchmark.reference.judge import Judge
from benchmark.reference.world import WORLDS

# the traced periods: the third to the fifth of the window (warm steps)
TRACE_FIRST, TRACE_PERIODS = 2, 3
# the JAX side of the repository, which no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "pigeon_tpu")
WRITE_LIMIT = 4 << 30


class RunError(RuntimeError):
    """A run that may print no result."""


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of the manifest with its configuration, traffic mix,
    limits and per-layer metrics, resolved by name under `root`."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.manifest = read_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        self.work = cells[name]
        self.name = name
        entry = {c["name"]: c for c in self.manifest["configs"]}[
            self.work["config"]]
        self.bench = self.root / "benchmark"
        self.config = read_json(self.root / entry["file"])
        self.mix = read_json(self.bench / "traffic"
                             / f"{self.work['traffic']}.json")
        self.traffic = load_module(self.bench / "traffic"
                                   / f"{self.mix['generator']}.py")
        self.limits = read_json(self.bench / "cells"
                                / f"{name}.json")["limits"]
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    def value_grid(self):
        g = self.mix.get("value_grid")
        return None if g is None else str(self.root / g)


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def written_bytes() -> int:
    """Bytes this process has had written to storage."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def shm_entries() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


def card_limits() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0]


def device_of(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                    count=1)
    return dict(platform="cpu", kind="cpu", count=1)


def _seeds(seed: int):
    """The traffic's and the sample's generator seeds."""
    s = int(seed) & ((1 << 64) - 1)
    return s, s ^ 0x5DEECE66D


def verdict(look: dict, limits: dict):
    """The numbers compared beside their limits, and `correct`: every
    number finite and within its limit, over a sample that is not
    empty."""
    checks = {k: dict(value=look[k], limit=float(limits[k]))
              for k in limits}
    correct = (look["samples"] > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    return checks, bool(correct)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0=None, program=Program) -> dict:
    """One run; returns the result object (the keys a caller reads, then
    "checks") and an "info" record for the line before it."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(root, workload)
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    if dev.type == "cuda":
        Program.build_kernels()
    cols = WORLDS[cfg["world"]["name"]]()
    ctrl = program(cfg, cols, cell.value_grid(), mix["period_s"], dev)
    world = {k: torch.as_tensor(cols[k], dtype=torch.float32, device=dev)
             for k in ("E", "N", "psi", "t")}
    s_traffic, s_sample = _seeds(seed)
    gen = torch.Generator(device=dev).manual_seed(s_traffic)
    table = torch.randint(
        int(mix["fleet"]), (loop.SAMPLE_ROWS, int(mix["samples_per_period"])),
        generator=torch.Generator().manual_seed(s_sample)).to(dev)
    B = int(mix["fleet"])

    # set-up: one cold and one warm period, and the profiler's own start
    loop.run_periods(ctrl, cell.traffic, mix, world, gen, math.inf,
                     loop.Sampler(table), loop.Counters(dev), max_periods=2)
    if trace and dev.type == "cuda":
        with _profiler_warm():
            torch.zeros(1, device=dev).add_(1.0)
            torch.cuda.synchronize(dev)
    loop.synchronize(dev)
    setup_s = time.perf_counter() - t0

    sampler, counters = loop.Sampler(table), loop.Counters(dev)
    traced = dict(prof=None, iterations=[])

    def on_period(k, phase, diag):
        if not trace or dev.type != "cuda":
            return
        first, last = TRACE_FIRST, TRACE_FIRST + TRACE_PERIODS - 1
        if phase == "start" and k == first:
            from benchmark import trace as tr
            traced["prof"] = tr.profiler()
            traced["prof"].start()
        elif phase == "end" and first <= k <= last:
            traced["iterations"].append(diag.iterations.clone())
            if k == last:
                traced["prof"].stop()

    out = loop.run_periods(ctrl, cell.traffic, mix, world, gen, seconds,
                           sampler, counters, on_period=on_period)
    loop.synchronize(dev)
    times = out["times"]
    periods = len(times)
    counts = counters.read()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise RunError(f"the run loaded {found}")

    summary = None
    n_traced = len(traced["iterations"])
    if traced["prof"] is not None and n_traced == TRACE_PERIODS:
        from benchmark import trace as tr
        summary = tr.summarize(traced["prof"], n_traced, float(sum(
            times[TRACE_FIRST:TRACE_FIRST + n_traced])))
    traced_its = (torch.cat(traced["iterations"]).cpu()
                  if n_traced == TRACE_PERIODS else None)

    # the program's state goes before the reference runs
    samples = sampler.collect()
    del ctrl, sampler, traced
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judge = Judge(cfg["reference"], cols, cell.value_grid(), cfg["solver"],
                  mix["period_s"], dev)
    look = judge(samples)
    checks, correct = verdict(look, cell.limits)

    solves = B * periods
    if trace:
        spec = ref_ct.SPECS[cfg["reference"]]
        L = ref_ct.layout(spec)
        rec = dict(trace=summary, counters=counts, periods=periods,
                   batch=B, traced_iterations=traced_its,
                   layout=dict(n=L.n, m=L.m, nnz=L.nonzeros()),
                   check=int(cfg["solver"]["pallas_check_inner"]),
                   peaks=read_json(cell.bench / "counts" / "peaks.json"))
        metrics = {}
        for m in cell.per_layer:
            v = load_module(cell.bench / "metrics"
                            / f"{m['name']}.py").read(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        e2e = dict(solves_per_s=solves / out["window_s"],
                   step_ms_p90=1e3 * float(np.percentile(times, 90)),
                   setup_s=setup_s)
        metrics = {m["name"]: dict(value=float(e2e[m["name"]]),
                                   unit=m["unit"])
                   for m in cell.end_to_end}
    dev_rec = dict(device_of(dev), memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=int(solves),
                  failed=int(counts["failed"]), metrics=metrics,
                  device=dev_rec)
    if trace and summary is not None:
        dev_rec.update(busy_s=summary["busy_s"],
                       window_s=summary["window_s"])
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    result["checks"] = checks
    info = dict(
        workload=workload, seed=int(seed), periods=periods,
        window_s=out["window_s"], setup_s=setup_s,
        hji_active_share=counts["hji_active"] / max(solves, 1),
        unconverged_share=1.0 - counts["converged"] / max(solves, 1),
        memory_peak_bytes=int(peak), look=look,
        card=card_limits() if dev.type == "cuda" else "cpu",
        step_ms_median=1e3 * float(np.median(times)))
    return dict(result=result, info=info)


class _profiler_warm:
    """A throwaway profiler session, so that the traced periods do not
    pay the profiler's first start."""

    def __enter__(self):
        from benchmark import trace as tr
        self.prof = tr.profiler()
        self.prof.start()

    def __exit__(self, *exc):
        self.prof.stop()
        return False
