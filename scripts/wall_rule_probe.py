"""Probe chip_smoke.py's reference rules of the wall fleets on one card:
every step of every placement, and the per-vehicle exits behind a step
that breaks a rule.

    python3 scripts/wall_rule_probe.py [OUT_DIR]

`rules`: `reference_check` of "sparse_walls", "condensed_walls" and
"coupled_walls" on placements 0-2 (make_setup's seed), with each
fleet's REF_RULES entry as chip_smoke.py has it but for its placements;
a broken rule is recorded, not raised, so every step runs.  Each step's
record (`reference_verdict`'s, controls included) goes to
OUT_DIR/wall_rules_<fleet>.json and one summary line a fleet is printed:
the bars of the card, of the CPU float32 path, of the card's step with
B8's float32 plain version (`card_plain`) and of the CPU float32 solve
of the card's QPs, each from the CPU float64 commands, and the rules
broken.

`exits`: for each step that broke a rule, the fleet stepped on the card
to that step again, then from that state the step with the kernel, with
its plain version in float32 and in float64 (`step_with_admm`), and on
the CPU in float32 and float64: for the six vehicles furthest from
float64 on the card, each run's bars and executed iterations, and each
card run's `verified_convergence`.  One JSON line a step.

Imports nothing of JAX; needs one CUDA card.  OUT_DIR defaults to
chiprun_out/.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

FLEETS = ("sparse_walls", "condensed_walls", "coupled_walls")
PLACEMENTS = (0, 1, 2)
BAR = torch.tensor([2e-4, 2.0, 2.0], dtype=torch.float64)


def rules(out_dir):
    """Every step of each wall fleet's rule on PLACEMENTS; returns the
    (fleet, placement, step) of the steps that broke it."""
    broken_at, records = [], []
    verdict, require = cs.reference_verdict, cs.require

    def recorded(*args, **kw):
        rec, broken = verdict(*args, **kw)
        records.append((rec, broken))
        return rec, broken

    def noted(ok, msg):
        if not ok:
            failures.append(str(msg)[:400])

    cs.reference_verdict, cs.require = recorded, noted
    try:
        for fleet in FLEETS:
            rule = cs.REF_RULES[fleet]
            cs.REF_RULES[fleet] = dict(rule, seeds=PLACEMENTS)
            records.clear()
            failures = []
            try:
                out = cs.reference_check(torch, fleet)
            finally:
                cs.REF_RULES[fleet] = rule
            with open(os.path.join(out_dir, f"wall_rules_{fleet}.json"),
                      "w") as f:
                json.dump(out, f, default=str)
            steps = []
            for seed in out["seeds"]:
                for s in seed["steps"]:
                    steps.append(dict(
                        placement=seed["seed"], step=s["step"],
                        **{k: s.get(k) for k in (
                            "err_bars", "gap32_bars", "card_plain_gap_bars",
                            "card_qp_gap_bars", "max_excess",
                            "iters_mean", "converged")}))
            # a fleet-wide rule's step verdict is the one given
            # per_vehicle_rule_broken (its controls' and the per-vehicle
            # rule's are not); a per-vehicle rule gives one a step
            mains = [(r, b) for r, b in records
                     if "per_vehicle_rule_broken" in r
                     or not rule["fleet_wide"]]
            for st, (_, broken) in zip(steps, mains):
                st["broken"] = broken
                if broken:
                    broken_at.append((fleet, st["placement"], st["step"]))
            print(json.dumps(dict(fleet=fleet, steps=steps,
                                  failures=failures), default=str),
                  flush=True)
    finally:
        cs.reference_verdict, cs.require = verdict, require
    return broken_at


def exits(fleet, placement, step):
    """The per-vehicle exits of one step (see the module's docstring)."""
    gpu = cs.make_setup(torch, cs.B_REF, "cuda", formulation=fleet,
                        seed=placement)
    for _ in range(step):
        cs.closed_loop_step(torch, gpu)
    _, plain, plain64 = cs.plain_admm(torch, gpu["cfg"])
    runs = {}
    for name, fn in (("kernel", None), ("plain", plain),
                     ("plain64", plain64)):
        st = cs.copy_state(torch, gpu, "cuda", torch.float32)
        u, d, solve = cs.step_with_admm(torch, st, fn)
        runs[name] = (u.cpu().double(), d.iterations.cpu(),
                      cs.verified_convergence(torch, *solve))
    for name, dtype in (("cpu32", torch.float32), ("cpu64", torch.float64)):
        u, d = cs.closed_loop_step(torch, cs.copy_state(torch, gpu, "cpu",
                                                        dtype))
        runs[name] = (u.double(), d.iterations, None)
    u64 = runs["cpu64"][0]
    bars = {k: ((r[0] - u64).abs() / BAR).amax(dim=1)
            for k, r in runs.items()}
    worst = torch.argsort(bars["kernel"], descending=True)[:6].tolist()
    print(json.dumps(dict(
        fleet=fleet, placement=placement, step=step,
        verified={k: r[2] for k, r in runs.items() if r[2] is not None},
        worst=[dict(vehicle=v, **{f"bars_{k}": float(b[v])
                                  for k, b in bars.items()},
                    **{f"iters_{k}": int(r[1][v]) for k, r in runs.items()})
               for v in worst])), flush=True)


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out"
    if not torch.cuda.is_available():
        print("wall_rule_probe: no CUDA device available", file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    from pigeon_tpu_torch import _kernels as kernels

    print(json.dumps(dict(device=cs.nvidia_smi())), flush=True)
    kernels.build_all()
    for where in rules(out_dir):
        exits(*where)
    return 0


if __name__ == "__main__":
    sys.exit(main())
