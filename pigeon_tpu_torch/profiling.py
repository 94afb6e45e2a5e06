"""Per-phase device profiling of the batched MPC step.  Counterpart of
`pigeon_tpu/profiling.py`.

`profile_step` times each phase of the batched coupled step as a
separate program on the same data: node seeding (warm and cold),
linearization and QP assembly, the solver pipeline's scaling, the KKT
factor, one segment of ADMM iterations, the residual check, and the
whole step.  Each phase is built from the port's own functions (on the
card, the kernels of its backend: B1 in the assembly, B9 in the "pallas"
scaling, B2 or B7 in the factor, B3 or B8 in the iterations) and timed as
the median of `iters` runs after `warmup`, with CUDA events on the card
and the host clock on the CPU.  A phase recomputes nothing of the others,
so the phases do not partition one step: their sum is no bound on it.

`soft_step_flops` and `mfu_row` give the roofline row of a step against
the H100's peaks; `torch_trace` writes a Chrome trace of the code inside
it through torch.profiler.  `python -m pigeon_tpu_torch.profiling` runs
the profile (or, with --mfu, the flagship's MFU row) on the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


def _time_fn(fn, iters: int = 5, warmup: int = 2,
             cuda: bool = False) -> float:
    """Median milliseconds of `fn()`: with `cuda`, CUDA events around each
    run (after a synchronize), else the host clock."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _iterate_plain(opts, Kinv, qps, rho_vec, x, z, y, k: int):
    """k plain ADMM iterations (box projection) on a scaled batch: the
    "xla" backend's segment, as the JAX package's profiler writes it."""
    from pigeon_tpu_torch.solver.admm import _mv, _mtv

    sigma, a = float(opts.sigma), float(opts.alpha)
    for _ in range(k):
        rhs = sigma * x - qps.q + _mtv(qps.A, rho_vec * z - y)
        x_t = _mv(Kinv, rhs)
        z_t = _mv(qps.A, x_t)
        x_n = a * x_t + (1 - a) * x
        z_mix = a * z_t + (1 - a) * z
        z_n = torch.minimum(torch.maximum(z_mix + y / rho_vec, qps.l), qps.u)
        y = y + rho_vec * (z_mix - z_n)
        x, z = x_n, z_n
    return x, z, y


def profile_step(cfg, tube, cache, carry_b, q0s, u0s, ocs, ts,
                 iters: int = 5, include_full: bool = True,
                 warmup: int = 2, keep_outputs: bool = False) -> dict:
    """Time each phase of the batched coupled MPC step.

    The inputs are a batch as `mpc.mpc_step_batched` takes it.  Returns
    {"phase_ms": {...}, "batch": B, "solver_backend", "factor_method",
    "platform", "device"} with the JAX package's phase names: nodes_warm,
    nodes_cold, linearize_assemble (the QP `cfg` solves, the HJI row
    inactive), ruiz (the backend's scaling and operand preparation: the
    lane layouts, or B9 and the packed A), factor, iterate_<check_every>
    (one segment from a zero start), residuals and full_step.
    `keep_outputs` adds "outputs": each phase's last result."""
    from pigeon_tpu_torch import mpc as M
    from pigeon_tpu_torch import trajectory as trj
    from pigeon_tpu_torch.qp.coupled import CoupledStageData
    from pigeon_tpu_torch.solver import admm

    assert cfg.formulation == "coupled", "profiler covers the coupled step"
    B = q0s.shape[0]
    opts = cfg.solver
    out, results = {}, {}

    def timed(name, fn):
        results[name] = fn()
        out[name] = _time_fn(fn, iters, warmup, q0s.is_cuda)
        return results[name]

    def seeding(warm: bool):
        tgrid, dt = M.compute_time_steps(cfg.hz, ts)
        s0, e0, _ = trj.path_coordinates(tube, q0s[:, :2])
        if warm:
            return M._nodes_coupled_warm(cfg, tube, q0s, u0s, tgrid, carry_b,
                                         s0, e0)
        return M._nodes_coupled_cold(cfg, tube, q0s, u0s, tgrid, dt, s0, e0)

    qs, us, ps = timed("nodes_warm", lambda: seeding(True))
    timed("nodes_cold", lambda: seeding(False))

    def build():
        _, dt = M.compute_time_steps(cfg.hz, ts)
        data = CoupledStageData(
            dt=dt, qs=qs, us=us, ps=ps, hji_M=torch.zeros_like(q0s[:, :2]),
            hji_b=torch.ones_like(q0s[:, 0]), edges=None)
        return M._assemble_coupled(cfg, data)

    qp, _, _, w = timed("linearize_assemble", build)

    plan = M._banded_plan_for(cfg)
    if opts.backend in ("lanes", "pallas"):
        pipe = timed("ruiz", lambda: admm.kernel_pipeline(
            qp, opts, plan, M._a_pattern_for(cfg), M._eq_rows_for(cfg), w))
        to_k = (pipe.layout or (lambda v: v, None))[0]
        is_eq = pipe.is_eq
    else:
        qps, D, E, c = timed("ruiz", lambda: admm.ruiz(qp,
                                                       opts.scaling_iters))
        is_eq = None

    rho_base, rho_scale = admm._rho_start(qp, admm.cold_start(qp), opts,
                                          is_eq)
    rho_vec = torch.clamp(rho_base * rho_scale[:, None], admm.RHO_MIN,
                          admm.RHO_MAX)
    n, m = qp.q.shape[-1], qp.l.shape[-1]
    zeros = lambda k: torch.zeros((B, k), dtype=q0s.dtype, device=q0s.device)
    k = opts.check_every
    if opts.backend in ("lanes", "pallas"):
        fac = timed("factor", lambda: pipe.factor(rho_vec))
        x0, z0, y0 = to_k(zeros(n)), to_k(zeros(m)), to_k(zeros(m))
        timed(f"iterate_{k}", lambda: pipe.run_iters(fac, x0, z0, y0))
    else:
        Kinv = timed("factor", lambda: admm._factor_inv(
            qps.P_diag, qps.A, rho_vec, float(opts.sigma), opts, plan))
        timed(f"iterate_{k}", lambda: _iterate_plain(
            opts, Kinv, qps, rho_vec, zeros(n), zeros(m), zeros(m), k))

    def resid():
        x0, z0, y0 = zeros(n), zeros(m), zeros(m)
        Px = (admm._mv(qp.P_diag, x0) if qp.P_diag.dim() == 3
              else qp.P_diag * x0)
        return ((admm._mv(qp.A, x0) - z0).abs().amax(dim=-1),
                (Px + qp.q + admm._mtv(qp.A, y0)).abs().amax(dim=-1))

    timed("residuals", resid)
    if include_full:
        timed("full_step", lambda: M.mpc_step_batched(
            cfg, tube, cache, carry_b, q0s, u0s, ocs, ts))

    row = {"phase_ms": out, "batch": int(B), "solver_backend": opts.backend,
           "factor_method": opts.factor_method,
           "platform": q0s.device.type,
           "device": (torch.cuda.get_device_name(q0s.device)
                      if q0s.device.type == "cuda" else "cpu")}
    if keep_outputs:
        row["outputs"] = results
    return row


# ---------------------------------------------------------------------------
# Operation accounting and roofline
# ---------------------------------------------------------------------------

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
# limit): float32 outside the tensor cores, TF32 on the tensor cores, HBM3
PEAKS_H100 = {
    "card": "NVIDIA H100 SXM (80GB HBM3)",
    "fp32_tflops": 67.0,
    "tf32_tensor_tflops": 494.7,
    "hbm_gbps": 3350.0,
}


def soft_step_flops(hz, n: int, m: int, iters: float,
                    check_every: int = 10, ns_polish: int = 1,
                    ruiz_iters: int = 2) -> dict:
    """Static per-instance operation counts for one flagship (soft
    condensed) control step, by phase: exact counts of the algorithm as
    written (2 a multiply-add), not padded device counts; the JAX
    package's `soft_step_flops`."""
    T = hz.N_short + hz.N_long
    d = 19                       # augmented expm stage matrix (n+2m+1)
    jac_ode = 500                # vehicle_ode ~250 MACs, fwd-mode x12 tangents
    lin = T * (12 * jac_ode * 2            # jacfwd duals (rough)
               + 9 * d ** 3 * 2            # expm chain: 5 Horner + 4 squarings
               + 2 * d * d * 2)            # extraction einsums
    rollout = T * (6 * 6 * (n + 2) * 2 + 6 * (n + 2) * 2)
    pbuild = T * 3 * n * n * 2 + n * n * 2
    nodes = T * 200 * 2          # lookups + trim-free warm resample (approx)
    ruiz = ruiz_iters * 3 * m * n * 2
    kbuild = m * n * n * 2
    factor = int((1.0 / 3 + 1.0 / 3 + 1.0 + 2.0 * ns_polish) * n ** 3) * 2
    per_iter = (2 * m * n + n * n + 8 * m) * 2
    per_check = 2 * m * n * 2
    iterate = int(iters * per_iter + (iters / max(check_every, 1))
                  * per_check)
    return {
        "nodes": nodes, "linearize": lin, "rollout_assemble":
        rollout + pbuild, "ruiz": ruiz, "kbuild": kbuild,
        "factor": factor, "iterate": iterate,
        "total": (nodes + lin + rollout + pbuild + ruiz + kbuild + factor
                  + iterate),
    }


def mfu_row(B: int, step_s: float, flops_per_step: dict,
            peaks: dict = PEAKS_H100) -> dict:
    """One roofline JSON row: the step's achieved FLOP/s against the
    card's float32 peak (the units the kernels run on) and its TF32
    tensor peak (the conventional denominator).  The problems are tiny
    (n=30, m=124), so the step is bound by launches, memory and the host,
    not by operations."""
    achieved = flops_per_step["total"] * B / step_s
    return {
        "metric": "mfu_roofline",
        "batch": B,
        "flops_per_solve": flops_per_step["total"],
        "achieved_gflops": achieved / 1e9,
        "mfu_vs_fp32_pct": 100.0 * achieved / (peaks["fp32_tflops"] * 1e12),
        "mfu_vs_tf32_tensor_pct": 100.0 * achieved
        / (peaks["tf32_tensor_tflops"] * 1e12),
        "phase_flops": flops_per_step,
        "bound_by": "launches, memory and the host (tiny problems), not "
                    "operations",
        "peaks_assumed": peaks,
    }


@contextlib.contextmanager
def torch_trace(logdir: str):
    """torch.profiler over the code inside (host and, on the card, device
    activity); writes `logdir`/trace.json, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _fleet(cfg, B: int, device, dtype=torch.float32):
    """bench.py's fleet on the in-repo oval (seed 0): (tube, cache,
    carry, q0, u0, other cars, t)."""
    from pigeon_tpu_torch import hji, mpc, trajectory

    cols = trajectory.oval_columns()
    tube = trajectory.make_tube(**cols, pad_to=1024, device=device,
                                dtype=dtype)
    rng = np.random.default_rng(0)
    k0 = rng.integers(0, 900, B)
    like = dict(dtype=dtype, device=device)
    q0 = torch.as_tensor(np.stack([
        cols["E"][k0], cols["N"][k0], cols["psi"][k0], np.full(B, 6.0),
        np.zeros(B), np.zeros(B)], axis=1), **like)
    t = torch.as_tensor(cols["t"][k0], **like)
    u0 = torch.zeros((B, 3), **like)
    oc = torch.tensor([1e4, 1e4, 0.0, 0.0], **like).expand(B, 4)
    carry = mpc.init_carry(cfg, B, dtype=dtype, device=device)
    return (tube, hji.inactive_cache(device=device), carry, q0, u0, oc, t)


def _mfu_main(args):
    """The flagship soft step (bench.py's lane solver) on the card at
    --batch, 10 chained steps timed 5 times; prints the MFU row."""
    import dataclasses

    from pigeon_tpu_torch import mpc
    from pigeon_tpu_torch.config import SolverOptions
    from pigeon_tpu_torch.qp.condensed import get_soft_layout

    cfg = dataclasses.replace(
        mpc.x1_coupled_config(soft=True), solver=SolverOptions(
            max_iter=150, check_every=150, eps_abs=1e-3, eps_rel=1e-3,
            backend="lanes", scaling_iters=2, pallas_check_inner=10))
    tube, cache, carry, q0, u0, oc, t = _fleet(cfg, args.batch, args.device)
    chain = 10

    def chained():
        nonlocal carry, t
        for _ in range(chain):
            carry, _, diag = mpc.mpc_step_batched(cfg, tube, cache, carry,
                                                  q0, u0, oc, t)
            t = t + 0.01
        return diag

    diag = chained()
    step_ms = _time_fn(chained, iters=5, warmup=0, cuda=q0.is_cuda) / chain
    iters_mean = float(diag.iterations.float().mean())
    L = get_soft_layout(cfg.hz, cfg.coupled.use_walls)
    row = mfu_row(args.batch, step_ms / 1e3,
                  soft_step_flops(cfg.hz, L.n, L.m, iters_mean))
    row.update(step_ms=step_ms, solves_per_s=args.batch / (step_ms / 1e3),
               iters_mean=iters_mean, platform=q0.device.type)
    print(json.dumps(row))


def _main():
    import argparse
    import dataclasses

    from pigeon_tpu_torch import mpc
    from pigeon_tpu_torch.config import SolverOptions

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--solver-iters", type=int, default=50)
    ap.add_argument("--backend", default=None,
                    help="default: pallas on the card, xla on the CPU")
    ap.add_argument("--factor", default="banded")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--mfu", action="store_true",
                    help="measure the flagship soft step and print the "
                         "roofline/MFU JSON row")
    args = ap.parse_args()

    from pigeon_tpu_torch import resolve_device
    args.device = resolve_device(args.device)
    if args.mfu:
        _mfu_main(args)
        return
    backend = args.backend or ("pallas" if args.device.type == "cuda"
                               else "xla")
    cfg = dataclasses.replace(mpc.x1_coupled_config(), solver=SolverOptions(
        max_iter=args.solver_iters * 2, check_every=args.solver_iters,
        eps_abs=1e-3, eps_rel=1e-3, backend=backend, scaling_iters=4,
        factor_method=args.factor))
    tube, cache, carry, q0, u0, oc, t = _fleet(cfg, args.batch, args.device)
    # one real step first, so the warm phases see a warm carry
    carry, _, _ = mpc.mpc_step_batched(cfg, tube, cache, carry, q0, u0, oc, t)
    print(json.dumps(profile_step(cfg, tube, cache, carry, q0, u0, oc, t)))


if __name__ == "__main__":
    _main()
