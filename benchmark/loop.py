"""The closed loop the window times, and what it records.

`run_periods` steps a controller (the program, or the reference in its
place for the control) through the traffic: a period is the redraw at an
episode's start, one controller step for the whole fleet, the plant's
step, the other cars' step, the sample's record and the
`torch.cuda.synchronize()` that ends it, as a fleet server hands back
every period's commands.  Each period's time runs from its start to that
synchronize.

`Sampler` records, for the vehicles of each period's row of a table
drawn from the seed, the step's inputs, the QP the step builds, and its
outputs (`reference.judge` names the fields).  `Counters` adds up the
step's diagnostics on the device, read once after the window.
"""

from __future__ import annotations

import time

import torch

# sample rows drawn ahead; a window with more periods reuses them in turn
SAMPLE_ROWS = 4096


class Sampler:
    """Index-selects each period's sampled vehicles from the step's inputs,
    its QP and its outputs; `collect()` concatenates the periods."""

    def __init__(self, table: torch.Tensor):
        self.table = table            # (SAMPLE_ROWS, per period) long
        self.rows = []
        self.idx = None
        self.cur = None

    def begin(self, k: int, carry, st: dict):
        self.idx = self.table[k % self.table.shape[0]]
        self.inputs(carry, st)

    def inputs(self, carry, st: dict):
        """Record the step's inputs for the vehicles `self.idx`."""
        take = lambda x: x.index_select(0, self.idx)
        self.cur = dict(
            in_q=take(st["q"]), in_u=take(st["u"]), in_oc=take(st["oc"]),
            in_t=take(st["t"]), in_solved=take(carry.solved),
            in_prev_ts=take(carry.prev_ts), in_q_prev=take(carry.q_prev),
            in_u_prev=take(carry.u_prev),
            in_command=take(carry.current_control),
            in_fallback=take(carry.nan_fallback))

    def qp(self, qp):
        take = lambda x: x.index_select(0, self.idx)
        P = qp[0]
        if P.dim() != 2:
            raise ValueError("the sampler records a diagonal P")
        self.cur.update(qp_P=take(P), qp_q=take(qp[1]), qp_A=take(qp[2]),
                        qp_l=take(qp[3]), qp_u=take(qp[4]))

    def end(self, carry, u3, diag, q_next):
        take = lambda x: x.index_select(0, self.idx)
        self.cur.update(
            out_u3=take(u3), out_prev_ts=take(carry.prev_ts),
            out_q_prev=take(carry.q_prev), out_u_prev=take(carry.u_prev),
            out_solved=take(carry.solved), out_x=take(carry.warm_x),
            out_y=take(carry.warm_y), out_z=take(carry.warm_z),
            out_command=take(carry.current_control),
            out_fallback=take(carry.nan_fallback),
            d_prim=take(diag.prim_res), d_dual=take(diag.dual_res),
            d_conv=take(diag.converged), d_finite=take(diag.solution_finite),
            d_s=take(diag.s), d_e=take(diag.e), out_q=take(q_next))
        self.rows.append(self.cur)
        self.cur = None

    def collect(self) -> dict:
        return {k: torch.cat([r[k] for r in self.rows])
                for k in self.rows[0]}


class Counters:
    """Per window, on the device: executed ADMM iterations, converged
    solves, failed solves (a non-finite solution, so the command fell
    back) and HJI-active vehicle-steps."""

    NAMES = ("iterations", "converged", "failed", "hji_active")

    def __init__(self, device):
        self.acc = torch.zeros(len(self.NAMES), dtype=torch.float64,
                               device=device)

    def add(self, diag):
        self.acc += torch.stack([
            diag.iterations.sum(dtype=torch.float64),
            diag.converged.sum(dtype=torch.float64),
            (~diag.solution_finite).sum(dtype=torch.float64),
            diag.hji_active.sum(dtype=torch.float64)])

    def read(self) -> dict:
        return dict(zip(self.NAMES, (float(v) for v in self.acc.tolist())))


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_periods(ctrl, traffic, mix: dict, world: dict, gen, seconds: float,
                sampler: Sampler, counters: Counters, max_periods=None,
                on_period=None) -> dict:
    """Step the closed loop until `seconds` have passed (or `max_periods`
    periods), starting with a fresh episode.  `on_period(k, phase, diag)`
    is called with phase "start" before period k and "end", with the
    step's diagnostics, after its synchronize (the traced run's
    profiler).  Returns the periods' times (s) and the window's length,
    from its start to the end of its last period."""
    dt = float(mix["period_s"])
    episode = int(mix["episode_periods"])
    device = world["E"].device
    times = []
    st = carry = None
    t_start = time.perf_counter()
    k = 0
    with ctrl.capture(sampler.qp):
        while True:
            if on_period is not None:
                on_period(k, "start", None)
            t0 = time.perf_counter()
            if k % episode == 0:
                st = traffic.draw(mix, world, gen)
                carry = ctrl.init_carry(st["q"].shape[0])
            sampler.begin(k, carry, st)
            carry, u3, diag = ctrl.step(carry, st["q"], st["u"], st["oc"],
                                        st["t"])
            q_next = ctrl.plant(st["q"], u3)
            sampler.end(carry, u3, diag, q_next)
            counters.add(diag)
            st = dict(q=q_next, u=u3, oc=traffic.advance(st["oc"], dt),
                      t=st["t"] + dt)
            synchronize(device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if on_period is not None:
                on_period(k, "end", diag)
            k += 1
            if t1 - t_start >= seconds or (max_periods is not None
                                           and k >= max_periods):
                break
    return dict(times=times, window_s=t1 - t_start)
