"""The comparison that decides a run's `correct`.

The harness records, for a sample of vehicle-periods drawn from the
seed, what it handed the program (state, command in effect, other car,
time, the controller state it carried in) and what the program produced:
the QP it built (at the solver's entry), its solution and reported
residuals, the command, the controller state it carries out, and the
plant's next state.  The reference works each stage out again in
float64 from the stage's own inputs and reads the program's outputs only
to judge them:

- `det_gap`, the stages that are functions of their inputs: the
  projection (s, e) of the vehicle onto the path, which the program
  reports, from the harness's inputs; the QP (time grid, nodes, HJI row,
  linearization, assembly) from those inputs and the program's
  projection; the command and the carried state from the program's
  solution; and the plant's step from the program's command.  Each
  entry's gap relative to the larger of 1 and the reference's value (A's
  rows relative to the row's largest entry); the largest over the
  sample.  (The projection's arclength comes from a square root of a
  difference, which float32 rounds to some 1e-3 m near a segment's
  start: taking the program's projection into the QP keeps that error,
  judged relative to the arclength, from standing as a QP entry's.)
  A solve the program left non-finite (its command fell back) has to
  be one whose QP, as the reference builds it, has no finite answer in
  float64 either (the reference's ADMM from a cold start), unless that
  QP has a stage or a row that float32 does not determine (left out of
  the QP's gap, below): there, whether a float32 solve stays finite is
  not determined either.
- `res_gap`, the solver: its residuals recomputed in float64 on the QP
  it was given, against the residuals it reported, in units of the
  termination tolerance; a solve reported converged also may not exceed
  the tolerance.  And its answer itself: z's distance outside [l, u] in
  units of the primal tolerance, and complementarity: a row whose
  multiplier y_i carries weight in the dual residual (|y_i| max |A_i|
  over the dual tolerance) has z_i at the bound y_i's sign names (u
  where y_i > 0, l where y_i < 0; the smaller of the two units counts).
  The largest over the sample.

Where float32 rounding may take a discrete branch the other way, the
reference takes both and keeps the one nearer the program's: the long
stages' grid point, the nearest segment of the path on the inside of a
bend, a node within rounding of an actuator limit (the
limits' derivatives: 1, 1/2 or 0 for the steering and the force, a
stage at a time), a node's force within rounding of 0 (the drive or
the brake split between the axles), and the HJI row of a
vehicle whose value lies within rounding of eps or whose other car's
control lies within rounding of a branch (its rows left out).  A stage's
model whose node sits on an axle's friction circle, and a stage's
envelope whose corners coincide, are rounding noise in float32 and
float64 alike: their rows are left out (`controller.Undetermined`), and
so is any row that moves by more than SENSITIVE when the nodes move by
two float32 spacings (a node where the vehicle is nearly stopped or
going backwards, say).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import controller as ct
from benchmark.reference import vehicle as vh
from benchmark.reference.hji import Grid
from benchmark.reference.precision import Arith
from benchmark.reference.world import Path

# a node this near an actuator limit (relative) may lie on either side in
# float32: knot times of some 30 s round to 2e-6 s, which moves a node
# resampled on a 10 ms stage by 2e-4 of its neighbours' difference
TIES_BAND = 3e-4
# the limits' derivative weights tried there, (steering, force); the
# first is the exact tie's and the one the other rules read
WEIGHTS = [(wd, wf) for wd in (0.5, 1.0, 0.0) for wf in (0.5, 1.0, 0.0)]
# a node's force within rounding of 0 may take the drive or the brake
# split in float32 (the split's derivative jumps there): TIES_BAND of the
# force's scale, as a resampled node moves by that share of its
# neighbours' difference
SPLIT_BAND = TIES_BAND * max(-vh.x1().Fx_min, vh.x1().Fx_max)
# the variants tried: the first is the exact tie's, with the probe
TIES = ([vh.Ties(TIES_BAND, wd, wf) for wd, wf in WEIGHTS]
        + [vh.Ties(TIES_BAND, split=d, split_band=SPLIT_BAND)
           for d in (1, -1)])
GRID_BAND = 1e-4
# nodes moved by PROBE (two float32 spacings); a row that moves by more
# than SENSITIVE with them is conditioned too badly for float32 to fix it
PROBE = 2.0 ** -22
SENSITIVE = 4e-6
BLOCK = 256

def _same(a, b):
    """Entries both sides agree are not finite: the same infinity, or
    NaN on both (a degenerate node's data, computed alike)."""
    return (torch.isinf(a) & (a == b)) | (torch.isnan(a) & torch.isnan(b))


def _rel(a, b):
    """|a - b| relative to max(1, |b|); inf where only one side is
    finite or where the two are different non-finite values."""
    gap = (a - b).abs() / torch.clamp(b.abs(), min=1.0)
    gap = torch.where(_same(a, b), torch.zeros_like(gap), gap)
    return torch.nan_to_num(gap, nan=math.inf, posinf=math.inf)


def _rows(A_p, A_r):
    """A's gap a row: the row's largest entry difference over its largest
    entry."""
    same = _same(A_p, A_r)
    A_p = torch.where(same, 0.0, A_p)
    A_r = torch.where(same, 0.0, A_r)
    scale = torch.clamp(torch.maximum(A_r.abs().amax(-1),
                                      A_p.abs().amax(-1)), min=1e-30)
    gap = (A_p - A_r).abs().amax(-1) / scale
    return torch.nan_to_num(gap, nan=math.inf, posinf=math.inf)


def complementarity(A, lo, hi, y, z, e_p, e_d):
    """Each solve's largest row that holds a multiplier away from the
    bound the multiplier's sign names: the smaller of the multiplier's
    weight, |y_i| max_j |A_ij| in units of the dual tolerance, and the
    distance of z_i from that bound in units of the primal tolerance."""
    weight = y.abs() * A.abs().amax(-1) / e_d[:, None]
    off = torch.where(y > 0, hi - z, torch.where(y < 0, z - lo, 0.0))
    return torch.minimum(weight, off / e_p[:, None]).amax(-1)


def _flag_gap(a, b):
    """0 where two flags agree, inf where they differ."""
    return torch.full(a.shape, math.inf, dtype=torch.float64,
                      device=a.device).masked_fill(a == b, 0.0)


class Judge:
    """The reference of one configuration and traffic mix: `spec` names
    the controller (controller.SPECS), `cols` the path's columns, `cache`
    the value grid's file (None: the grid that never binds), `solver`
    the configuration's solver options, `dt` the plant's step."""

    def __init__(self, spec: str, cols: dict, cache, solver: dict,
                 dt: float, device="cpu"):
        self.sp = ct.SPECS[spec]
        self.veh = vh.x1()
        self.L = ct.layout(self.sp)
        self.path = Path(cols, torch.float64, device)
        self.grid = Grid(cache, torch.float64, device)
        self.solver = solver
        self.eps = (float(solver["eps_abs"]), float(solver["eps_rel"]))
        self.dt = dt
        self.device = device

    def __call__(self, samples: dict) -> dict:
        """The numbers compared, and what the look found, over all
        samples (judged in blocks)."""
        K = samples["in_t"].shape[0]
        out = dict(det_gap=0.0, res_gap=0.0, samples=K, grid_flips=0,
                   projection_flips=0, hji_ambiguous=0, tie_variants=0,
                   stages_left_out=0, rows_left_out=0, nonfinite=0,
                   nonfinite_undetermined=0, nonfinite_ref_finite=0,
                   stage_gaps={})
        for k0 in range(0, K, BLOCK):
            blk = {k: v[k0:k0 + BLOCK].to(self.device) for k, v in
                   samples.items()}
            blk = {k: v.double() if v.is_floating_point() else v
                   for k, v in blk.items()}
            rec = self._block(blk)
            if rec["worst_row"][1] >= out.get("worst_row", (0, -1.0))[1]:
                out["worst_row"] = rec["worst_row"]
            for k in ("det_gap", "res_gap"):
                out[k] = max(out[k], rec[k])
            for k in ("grid_flips", "projection_flips", "hji_ambiguous",
                      "tie_variants", "stages_left_out", "rows_left_out",
                      "nonfinite", "nonfinite_undetermined",
                      "nonfinite_ref_finite"):
                out[k] += rec[k]
            for k, v in rec["stage_gaps"].items():
                out["stage_gaps"][k] = max(out["stage_gaps"].get(k, 0.0), v)
        return out

    def _pre(self, s, ties, shift, probe=0.0):
        return ct.pre_solve(
            self.sp, self.veh, self.path, self.grid, s["in_q"], s["in_u"],
            s["in_oc"], s["in_t"], s["in_solved"], s["in_prev_ts"],
            s["in_q_prev"], s["in_u_prev"], ties=ties, ar=Arith(),
            shift=shift, projection=(s["d_s"], s["d_e"]), probe=probe)

    def _shift(self, s):
        """The long stages' grid choice nearest the program's (its carried
        knot times), where the choice lies within rounding."""
        base = torch.zeros_like(s["in_t"])
        ts0, _, margin = ct.time_grid(self.sp, s["in_t"], base)
        near = margin <= GRID_BAND
        best = base
        best_gap = (ts0 - s["out_prev_ts"]).abs().amax(-1)
        for d in (-1.0, 1.0):
            ts, _, _ = ct.time_grid(self.sp, s["in_t"], base + d)
            gap = (ts - s["out_prev_ts"]).abs().amax(-1)
            take = near & (gap < best_gap)
            best = torch.where(take, base + d, best)
            best_gap = torch.where(take, gap, best_gap)
        return best, int((best != 0).sum())

    def _block(self, s):
        sp, L = self.sp, self.L
        shift, flips = self._shift(s)
        variants = [self._pre(s, ties, shift, PROBE if i == 0 else 0.0)
                    for i, ties in enumerate(TIES)]
        pre = variants[0]
        qp_p = ct.QP(s["qp_P"], s["qp_q"], s["qp_A"], s["qp_l"], s["qp_u"])

        # -- the QP: a gap per row, the best tie variant per row group
        row_gaps = []
        for v in variants:
            r = v.qp
            row_gaps.append(torch.maximum(_rows(qp_p.A, r.A), torch.maximum(
                _rel(qp_p.l, r.l), _rel(qp_p.u, r.u))))
        row_gaps = torch.stack(row_gaps)                     # (11, K, m)
        sensitive = pre.sensitivity > SENSITIVE
        row_gaps = torch.where(sensitive[None], 0.0, row_gaps)
        und = pre.undetermined
        as_idx = lambda r: torch.as_tensor(r.ravel(), device=self.device)
        groups = ([(as_idx(g), und.singular[:, t])
                   for t, g in enumerate(L.dyn_rows)]
                  + [(as_idx(g), und.degenerate[:, t])
                     for t, g in enumerate(L.env_rows)])
        if "hji" in L.groups:
            groups.append((as_idx(L.groups["hji"]), pre.hji_ambiguous))
        in_group = torch.zeros(L.m, dtype=torch.bool, device=self.device)
        best, ties_used = [], torch.zeros_like(s["in_solved"])
        for rows, undetermined in groups:
            in_group[rows] = True
            per_v = row_gaps[:, :, rows].amax(-1)             # (11, K)
            low = per_v.amin(0)
            ties_used = ties_used | (low < per_v[0])
            best.append(torch.where(undetermined, 0.0, low))
        qp_gap = torch.stack(best, -1).amax(-1)
        rest = row_gaps[0][:, ~in_group].amax(-1)
        pq = torch.maximum(_rel(qp_p.P, pre.qp.P).amax(-1),
                           _rel(qp_p.q, pre.qp.q).amax(-1))
        qp_gap = torch.maximum(torch.maximum(qp_gap, rest), pq)
        left_out = int(und.singular.sum() + und.degenerate.sum())
        rows_left_out = int(sensitive.sum())
        # where the QP's gap is largest: (sample, row, gap), for the record
        masked = row_gaps.amin(0).clone()
        for rows, undetermined in groups:
            masked[:, rows] = torch.where(undetermined[:, None], 0.0,
                                          masked[:, rows])
        k_w, r_w = divmod(int(masked.argmax()), L.m)
        worst_row = (r_w, float(masked[k_w, r_w]))

        # -- the solver, on the QP it was given
        finite = s["d_finite"]
        x, y, z = s["out_x"], s["out_y"], s["out_z"]
        ar = Arith()
        Ax = ar.mv(qp_p.A, x)
        Aty = ar.mtv(qp_p.A, y)
        Px = qp_p.P * x
        amax = lambda v: v.abs().amax(-1)
        r_p, r_d = amax(Ax - z), amax(Px + qp_p.q + Aty)
        e_p = self.eps[0] + self.eps[1] * torch.maximum(amax(Ax), amax(z))
        e_d = self.eps[0] + self.eps[1] * torch.maximum(
            torch.maximum(amax(Px), amax(Aty)), amax(qp_p.q))
        reported = torch.maximum((r_p - s["d_prim"]).abs() / e_p,
                                 (r_d - s["d_dual"]).abs() / e_d)
        over = torch.clamp(torch.maximum(r_p / e_p, r_d / e_d) - 1.0,
                           min=0.0)
        reported = torch.maximum(reported,
                                 torch.where(s["d_conv"], over, 0.0))
        # the answer itself: z within [l, u], and a multiplier only at
        # the bound its sign names (y > 0 at u, y < 0 at l)
        lo, hi = qp_p.l, qp_p.u
        feas = (torch.clamp(torch.maximum(lo - z, z - hi), min=0.0)
                .amax(-1) / e_p)
        comp = complementarity(qp_p.A, lo, hi, y, z, e_p, e_d)
        res = torch.maximum(reported, torch.maximum(feas, comp))
        nan_inf = lambda v: torch.where(
            finite, torch.nan_to_num(v, nan=math.inf), 0.0)
        res, feas, comp = nan_inf(res), nan_inf(feas), nan_inf(comp)

        # -- a solve the program left non-finite: the reference's QP has
        # to have no finite answer either, unless the QP is not determined
        # to float32 (a stage or a row the QP's gap leaves out above)
        undetermined = (und.singular.any(-1) | und.degenerate.any(-1)
                        | sensitive.any(-1))
        ref_finite = torch.zeros_like(finite)
        bad = ~finite & ~undetermined
        if bool(bad.any()):
            ref_finite[bad] = self._finite_answer(pre, s, bad)
        unfinished = _flag_gap(finite | ~ref_finite, torch.ones_like(finite))

        # -- the command and the carried state, from the solution
        u2, q_sol, u_sol = ct.extract(sp, self.veh, L, x, pre.us)
        u3, fin = ct.command(self.veh, u2, s["in_q"][:, 3],
                             s["in_command"], s["in_fallback"])
        fallback = torch.where(s["in_fallback"][:, None],
                               torch.zeros_like(u3), s["in_command"])
        u3 = torch.where(finite[:, None], u3, fallback)
        scale = torch.tensor([self.veh.delta_max, self.veh.Fx_max,
                              self.veh.Fx_max], dtype=u3.dtype,
                             device=u3.device)
        cmd = ((s["out_u3"] - u3).abs() / scale).amax(-1)
        # a solution the program called finite has to be; one it did not
        # comes back zeroed, and only its fallback command can be judged
        cmd = torch.maximum(torch.nan_to_num(cmd, nan=math.inf),
                            _flag_gap(fin | ~finite, torch.ones_like(fin)))
        f2 = finite[:, None, None]
        carry = torch.stack([
            _rel(s["out_prev_ts"], pre.ts).amax(-1),
            _rel(s["out_q_prev"], torch.where(f2, q_sol, s["in_q_prev"]))
            .amax((-1, -2)),
            _rel(s["out_u_prev"], torch.where(f2, u_sol, s["in_u_prev"]))
            .amax((-1, -2)),
            _rel(s["out_command"], s["out_u3"]).amax(-1),
            _flag_gap(s["out_solved"], finite),
            _flag_gap(s["out_fallback"], ~finite)], -1).amax(-1)

        # -- the plant, from the program's command
        q_next = ct.plant(self.veh, s["in_q"], s["out_u3"], self.dt)
        plant = _rel(s["out_q"], q_next).amax(-1)

        s0, e0, pflips = self.path.project(s["in_q"][:, :2], s["d_s"])
        proj = torch.maximum(_rel(s["d_s"], s0), _rel(s["d_e"], e0))
        stage = dict(projection=proj, qp=qp_gap, command=cmd, carry=carry,
                     plant=plant, nonfinite=unfinished)
        det = torch.stack(list(stage.values()), -1).amax(-1)
        return dict(det_gap=float(det.max()), res_gap=float(res.max()),
                    grid_flips=flips, projection_flips=pflips,
                    hji_ambiguous=int(pre.hji_ambiguous.sum()),
                    tie_variants=int(ties_used.sum()),
                    stages_left_out=left_out, rows_left_out=rows_left_out,
                    nonfinite=int((~finite).sum()),
                    nonfinite_undetermined=int((~finite & undetermined)
                                               .sum()),
                    nonfinite_ref_finite=int(ref_finite.sum()),
                    worst_row=worst_row,
                    stage_gaps={k: float(v.max()) for k, v in stage.items()}
                    | {"solver": float(res.max()),
                       "residuals": float(nan_inf(reported).max()),
                       "feasibility": float(feas.max()),
                       "complementarity": float(comp.max())})

    def _finite_answer(self, pre, s, sel):
        """Whether the float64 reference's own QP of the samples `sel`
        has a finite command: its ADMM solve from a cold start."""
        from benchmark.reference import admm

        qp = ct.QP(*(f[sel] for f in pre.qp))
        zero = lambda k: torch.zeros((qp.q.shape[0], k), dtype=qp.q.dtype,
                                     device=qp.q.device)
        sol = admm.solve(qp, (zero(self.L.n), zero(self.L.m),
                              zero(self.L.m)), self.solver, Arith())
        u2, _, _ = ct.extract(self.sp, self.veh, self.L, sol.x, pre.us[sel])
        _, fin = ct.command(self.veh, u2, s["in_q"][sel, 3],
                            s["in_command"][sel], s["in_fallback"][sel])
        return fin
