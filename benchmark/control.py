"""The control of the comparison: the plain reference put in the program's
place, computed in the precision below the configurations' (float32 with
TF32 off): float32 with every matrix product's operands rounded to TF32.

The program steps a cell's traffic at the cell's fleet size for a fixed
number of periods (no timing); for each period's sampled vehicles the
control takes the inputs the program was handed, its controller state
included, and computes the step, the command, the state it carries and
the plant's step in the program's place.  The comparison judges those
outputs as it judges a run's, and has to fail them.

    python3 benchmark/control.py --workload NAME --seeds N [N ...]
        [--periods P] [--samples S] [--program | --failed]

`--program` judges the program's own outputs instead: its readings, many
seeds in one process.  `--failed` judges, of the program's outputs,
every vehicle whose command came out non-finite, against the
reference's own QP (`reference.judge`).  Each seed's line carries the
harness's verdict (`correct`, with the numbers beside their limits).
The benchmark's own runs do not run this; its output is a JSON line per
seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parent.parent


class Carry(NamedTuple):
    prev_ts: torch.Tensor
    q_prev: torch.Tensor
    u_prev: torch.Tensor
    solved: torch.Tensor
    warm_x: torch.Tensor
    warm_y: torch.Tensor
    warm_z: torch.Tensor
    current_control: torch.Tensor
    nan_fallback: torch.Tensor


class Diag(NamedTuple):
    s: torch.Tensor
    e: torch.Tensor
    V_hji: torch.Tensor
    hji_active: torch.Tensor
    iterations: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    converged: torch.Tensor
    solution_finite: torch.Tensor


class ReferenceInPlace:
    """The reference as a controller with the program's interface, in the
    arithmetic `ar`."""

    def __init__(self, config: dict, cols: dict, value_grid, dt: float,
                 device, ar):
        from benchmark.reference import controller as ct
        from benchmark.reference import vehicle as vh
        from benchmark.reference.hji import Grid
        from benchmark.reference.world import Path as WPath

        self.ct, self.ar = ct, ar
        self.sp = ct.SPECS[config["reference"]]
        self.veh = vh.x1()
        self.L = ct.layout(self.sp)
        self.path = WPath(cols, ar.dtype, device)
        self.grid = Grid(value_grid, ar.dtype, device)
        self.opts = config["solver"]
        self.dt = float(dt)
        self.device = torch.device(device)
        self.callback = None

    def init_carry(self, B: int) -> Carry:
        like = dict(dtype=self.ar.dtype, device=self.device)
        z = lambda *s: torch.zeros((B,) + s, **like)
        no = torch.zeros(B, dtype=torch.bool, device=self.device)
        N = self.sp.N
        return Carry(torch.arange(1, N + 1, **like).expand(B, N).clone(),
                     z(N, self.sp.nx), z(N, 2), no, z(self.L.n), z(self.L.m),
                     z(self.L.m), z(3), no.clone())

    def step(self, carry: Carry, q, u, oc, t):
        from benchmark.reference import admm

        ct = self.ct
        s0, e0, _ = self.path.project(q[:, :2])
        pre = ct.pre_solve(self.sp, self.veh, self.path, self.grid, q, u, oc,
                           t, carry.solved, carry.prev_ts, carry.q_prev,
                           carry.u_prev, ar=self.ar, projection=(s0, e0))
        if self.callback is not None:
            self.callback(pre.qp)
        w = carry.solved[:, None]
        warm = tuple(torch.where(w, v, 0.0) for v in
                     (carry.warm_x, carry.warm_y, carry.warm_z))
        sol = admm.solve(pre.qp, warm, self.opts, self.ar)
        u2, q_sol, u_sol = ct.extract(self.sp, self.veh, self.L, sol.x,
                                      pre.us)
        u3, finite = ct.command(self.veh, u2, q[:, 3], carry.current_control,
                                carry.nan_fallback)
        f1, f2 = finite[:, None], finite[:, None, None]
        new = Carry(pre.ts, torch.where(f2, q_sol, carry.q_prev),
                    torch.where(f2, u_sol, carry.u_prev), finite,
                    torch.where(f1, sol.x, 0.0), torch.where(f1, sol.y, 0.0),
                    torch.where(f1, sol.z, 0.0), u3, ~finite)
        diag = Diag(s0, e0, pre.V_hji, pre.V_hji <= self.sp.hji_eps,
                    sol.iterations, sol.prim_res, sol.dual_res,
                    sol.converged, finite)
        return new, u3, diag

    def plant(self, q, u3):
        return self.ct.plant(self.veh, q, u3, self.dt)

    @contextlib.contextmanager
    def capture(self, callback):
        self.callback = callback
        try:
            yield
        finally:
            self.callback = None


class ShadowSampler:
    """A sampler that records, for the same sampled vehicles and the same
    inputs the program was handed (its controller state included), the
    control's outputs in place of the program's."""

    def __init__(self, table, control: ReferenceInPlace):
        from benchmark import loop

        self.inner = loop.Sampler(table)
        self.control = control

    def begin(self, k, carry, st):
        self.inner.begin(k, carry, st)
        take = lambda x: x.index_select(0, self.inner.idx)
        self.warm = (take(carry.warm_x), take(carry.warm_y),
                     take(carry.warm_z))

    def qp(self, qp):
        pass

    def end(self, carry, u3, diag, q_next):
        c = self.inner.cur
        dt = self.control.ar.dtype
        f = lambda x: x.to(dt) if x.is_floating_point() else x
        carry_in = Carry(f(c["in_prev_ts"]), f(c["in_q_prev"]),
                         f(c["in_u_prev"]), c["in_solved"],
                         *(f(w) for w in self.warm), f(c["in_command"]),
                         c["in_fallback"])
        q, u, oc, t = (f(c[k]) for k in ("in_q", "in_u", "in_oc", "in_t"))
        # the control's step covers the sampled vehicles alone
        self.inner.idx = torch.arange(q.shape[0], device=q.device)
        with self.control.capture(self.inner.qp):
            new, u3s, dg = self.control.step(carry_in, q, u, oc, t)
        self.inner.end(new, u3s, dg, self.control.plant(q, u3s))

    def collect(self):
        return self.inner.collect()


class FailedSampler:
    """A sampler of the program's own outputs that records, in place of
    a sample, every vehicle of the fleet whose step left its command
    non-finite."""

    def __init__(self):
        from benchmark import loop

        self.inner = loop.Sampler(None)

    def begin(self, k, carry, st):
        self.held = (carry, st)

    def qp(self, qp):
        self.held_qp = qp

    def end(self, carry, u3, diag, q_next):
        idx = torch.nonzero(~diag.solution_finite).flatten()
        if idx.numel():
            self.inner.idx = idx
            self.inner.inputs(*self.held)
            self.inner.qp(self.held_qp)
            self.inner.end(carry, u3, diag, q_next)
        self.held = self.held_qp = None

    def collect(self):
        return self.inner.collect() if self.inner.rows else None


def readings(root, workload: str, seed: int, periods: int, samples: int,
             program: bool, device, failed: bool = False) -> dict:
    """The comparison's numbers for `periods` periods of the traffic of
    the cell of the checkout at `root`, which the program steps: of the
    program's own outputs (`program`), or of the control's, computed for
    the sampled vehicles from the inputs the program was handed."""
    from benchmark import harness, loop
    from benchmark.program import Program
    from benchmark.reference.judge import Judge
    from benchmark.reference.precision import Arith
    from benchmark.reference.world import WORLDS

    cell = harness.Cell(root, workload)
    cfg, mix = cell.config, dict(cell.mix, samples_per_period=samples)
    dev = torch.device(device)
    cols = WORLDS[cfg["world"]["name"]]()
    if dev.type == "cuda":
        Program.build_kernels()
    ctrl = Program(cfg, cols, cell.value_grid(), mix["period_s"], dev)
    world = {k: torch.as_tensor(cols[k], dtype=torch.float32, device=dev)
             for k in ("E", "N", "psi", "t")}
    s_traffic, s_sample = harness._seeds(seed)
    gen = torch.Generator(device=dev).manual_seed(s_traffic)
    table = torch.randint(int(mix["fleet"]), (loop.SAMPLE_ROWS, samples),
                          generator=torch.Generator().manual_seed(
                              s_sample)).to(dev)
    if failed:
        sampler = FailedSampler()
    elif program:
        sampler = loop.Sampler(table)
    else:
        sampler = ShadowSampler(table, ReferenceInPlace(
            cfg, cols, cell.value_grid(), mix["period_s"], dev,
            Arith(torch.float32, tf32=True)))
    counters = loop.Counters(dev)
    t0 = time.perf_counter()
    loop.run_periods(ctrl, cell.traffic, mix, world, gen, float("inf"),
                     sampler, counters, max_periods=periods)
    stepped_s = time.perf_counter() - t0
    recorded = sampler.collect()
    del ctrl, sampler
    judge = Judge(cfg["reference"], cols, cell.value_grid(), cfg["solver"],
                  mix["period_s"], dev)
    look = (judge(recorded) if recorded
            else dict(samples=0, det_gap=0.0, res_gap=0.0))
    checks, correct = harness.verdict(look, cell.limits)
    return dict(workload=workload, seed=seed, outputs_of=(
        "failed" if failed else "program" if program
        else "reference-tf32"), periods=periods, stepped_s=stepped_s,
        failed=counters.read()["failed"], correct=correct, checks=checks,
        look=look)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--periods", type=int, default=20)
    ap.add_argument("--samples", type=int, default=36)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--failed", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        rec = readings(ROOT, args.workload, seed, args.periods,
                       args.samples, args.program, args.device,
                       args.failed)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
