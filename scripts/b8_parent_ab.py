"""Run the dense ADMM kernel (B8) of two checkouts of the port, or its two
builds, on the same captured inputs, on one card, and compare them.

    python3 scripts/b8_parent_ab.py capture DIR
    python3 scripts/b8_parent_ab.py run ROOT DIR NAME
    python3 scripts/b8_parent_ab.py compare DIR NAME [NAME ...]
    python3 scripts/b8_parent_ab.py builds DIR
    python3 scripts/b8_parent_ab.py placements

`capture` (with this checkout's package) saves one call of the kernel
from each hard path, captured as chip_smoke.py captures it: the first
segment of a cold and of a warm step of the sparse fleet (B = 2048, mode
"highest", the narrow build), of a cold and a warm step of the sparse
fleet in mode "mixedk6", of the condensed fleet (dense P), of the sparse
decoupled fleet (n = 245, "highest": the large build, the pair build
before its register rows left shared memory), and the unbatched
condensed route's first segment (tile 1).  `run` loads them (and runs
the sparse cold call in "mixed" and "high" too, MODE_CASES) and, with
the package and the chip_smoke.py of the checkout at ROOT,
packs A into that checkout's pattern of the path's layout (in the build
of the call's mode, where the checkout picks builds by mode), runs each
call, times it (chip_smoke's `cuda_ms`, 5 calls) and saves the outputs
and times as NAME.  `compare` prints one JSON line: for each call,
whether the outputs of the NAMEs are bit-equal, and each NAME's times.
Run parent, change, change, parent, so that drift on the card shows.
`builds` runs each saved call in the builds of this checkout that take
it (`EllPattern.as_build`: the sparse calls in the narrow, the wide and
the large build, each in "highest" and in "mixedk6"; the sparse
decoupled calls in the large and the pair build; the condensed calls in
the wide and the narrow one), in turns (each build, then each again
in reverse order; device times), prints each build's shared bytes,
registers, resident clusters, waves and pipe floor, and holds each build
the path does not take as chip_smoke.py holds the path's own, under its
bars (`held_segment`, `held_mode` in a split mode, `held_fixed` at tile
1): one JSON line.  `placements` runs chip_smoke.py's rounding-limited
checks of the mixedk6 path on PLACEMENTS (fleet placements, make_setup's
seed) in the large build, as the path takes it, and in the narrow one
(`pallas_admm.plan_build` made to return it): the precision ladder
(`ladder_check`, each of LADDER_BULKS) and the mixedk6 reference check
(`reference_check`, REF_RULES["sparse_mixedk6"] on that placement alone,
without its controls, which test the rule and not the build); one JSON
line a check, whether it passed, the rule it broke, and each step's
converged shares and iterations.  Needs a CUDA card.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

CASES = {
    # name: (chip_smoke formulation, warm step, unbatched route)
    "sparse_cold": ("sparse", False, False),
    "sparse_warm": ("sparse", True, False),
    "sparse_mixedk6_cold": ("sparse_mixedk6", False, False),
    "sparse_mixedk6_warm": ("sparse_mixedk6", True, False),
    "condensed_cold": ("condensed", False, False),
    "condensed_warm": ("condensed", True, False),
    "condensed_tile1": ("condensed", False, True),
    "decoupled_sparse_cold": ("decoupled_sparse", False, False),
    "decoupled_sparse_warm": ("decoupled_sparse", True, False),
}
# `run` and `compare` also take the sparse cold call in the modes whose
# K^-1 words are split (the large build's 8 register rows a lane):
# name: (saved call, mode, leading equality rows)
MODE_CASES = {"sparse_mixed_cold": ("sparse_cold", "mixed", 128),
              "sparse_high_cold": ("sparse_cold", "high", 0)}
OPTIONS = ("tile", "check", "eps_abs", "eps_rel", "dense_P", "precision",
           "bf16", "m_eq")
PLACEMENTS = (0, 1, 2, 3)


def _chip_smoke(root):
    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke
    return chip_smoke


def _call(c, pattern):
    """A saved call's operands and options, A packed into `pattern`."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    n_iters, sigma, alpha = c["sched"]
    kw = dict(c["options"], sigma=sigma, alpha=alpha, pattern=pattern,
              A_packed=pa.pack(c["ops"][1], pattern))
    if c["scalings"] is not None:
        kw["scalings"] = tuple(c["scalings"])
    return c["ops"], kw, n_iters, kw.get("check", 0)


def _pattern(cs, form, unbatched, options=None):
    """The static pattern of the path's layout, as the path passes it: in
    the build of the call's mode where the checkout picks builds by mode
    (`EllPattern.for_mode`)."""
    from pigeon_tpu_torch import mpc

    cfg = (cs.simulate_setup(torch, form, "cuda", torch.float32)[0]
           if unbatched else cs.fleet_config(form))
    pattern = mpc._a_pattern_for(cfg)
    if options and hasattr(pattern, "for_mode"):
        mode = ("bf16" if options.get("bf16") else
                options.get("precision", "highest"))
        pattern = pattern.for_mode(mode, options.get("m_eq", 0),
                                   options.get("dense_P", False))
    return pattern


def capture(out_dir):
    cs = _chip_smoke(".")
    from pigeon_tpu_torch import mpc

    saved = {}
    for name, (form, warm, unbatched) in CASES.items():
        if unbatched:
            cfg, tube, cache, q0 = cs.simulate_setup(torch, form, "cuda",
                                                     torch.float32)
            step = lambda: mpc.simulate(cfg, tube, cache, q0, n_steps=1)
        else:
            st = cs.make_setup(torch, cs.B_SPARSE, "cuda", formulation=form)
            if warm:
                cs.closed_loop_step(torch, st)
            step = lambda: cs.closed_loop_step(torch, st)
        args, kw = cs.capture_kernel_inputs(step)["admm_dense"]
        saved[name] = dict(
            ops=[t.clone() for t in args[:9]], sched=list(args[9:12]),
            scalings=(None if kw.get("scalings") is None
                      else [t.clone() for t in kw["scalings"]]),
            options={k: kw[k] for k in OPTIONS if k in kw})
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    torch.save(saved, Path(out_dir) / "inputs.pt")


def _runs(saved):
    """Each call `run` makes: name, its saved call (options in the mode of
    MODE_CASES where named there) and its path (CASES)."""
    for name in list(CASES) + list(MODE_CASES):
        base, mode, m_eq = MODE_CASES.get(name, (name, None, 0))
        c = saved[base]
        if mode:
            c = dict(c, options=dict(c["options"], precision=mode,
                                     bf16=False, m_eq=m_eq))
        yield name, c, CASES[base]


def run(root, out_dir, tag):
    cs = _chip_smoke(root)
    from pigeon_tpu_torch import _kernels

    saved = torch.load(Path(out_dir) / "inputs.pt")
    outs, rec = {}, {}
    for name, c, (form, _, unbatched) in _runs(saved):
        pattern = _pattern(cs, form, unbatched, c["options"])
        ops, kw, n_iters, check = _call(c, pattern)
        _kernels.reset_launches()
        out = cs.dense_admm(torch, ops, kw, n_iters, check)
        torch.cuda.synchronize()
        builds = {k: v.launches_by for k, v in _kernels.KERNELS.items()
                  if v.launches_by}
        outs[name] = [t.cpu() for t in out]
        rec[name] = dict(ms=cs.cuda_ms(torch, lambda: cs.dense_admm(
            torch, ops, kw, n_iters, check), 5), builds=builds,
            build=getattr(pattern, "build", "narrow"))
    torch.save(outs, Path(out_dir) / f"{tag}.pt")
    rec["device"] = cs.nvidia_smi()
    (Path(out_dir) / f"{tag}.json").write_text(json.dumps(rec))
    print(json.dumps({tag: rec}), flush=True)


def compare(out_dir, tags):
    outs = {t: torch.load(Path(out_dir) / f"{t}.pt") for t in tags}
    recs = {t: json.loads((Path(out_dir) / f"{t}.json").read_text())
            for t in tags}
    res = {}
    for name in list(CASES) + list(MODE_CASES):
        first = outs[tags[0]][name]
        res[name] = dict(
            bit_equal={t: all(torch.equal(a, b) for a, b in
                              zip(first, outs[t][name])) for t in tags},
            ms={t: recs[t][name]["ms"] for t in tags},
            build={t: recs[t][name]["build"] for t in tags})
    res["device"] = recs[tags[0]]["device"]
    print(json.dumps({"b8_parent_ab": res}), flush=True)


def _held(cs, ops, kw, n_iters, check, mode, what, own_stats=False):
    """A build's call held as chip_smoke.py holds the path's own (with
    `own_stats`, the statistics against its own iterates', as the sparse
    decoupled QP's)."""
    try:
        if mode != "highest":
            return cs.held_mode(torch, ops, kw, n_iters, check, what)
        if check > 0:
            truth = (cs.stats_of_iterates(torch, ops, kw) if own_stats
                     else None)
            return cs.held_segment(torch, ops, kw, n_iters, check, what,
                                   some_early=False, truth=truth)[2]
        return cs.held_fixed(torch, ops, kw, n_iters, what)
    except RuntimeError as e:            # a bar it misses: recorded
        return dict(failed=str(e))


def builds(out_dir):
    cs = _chip_smoke(".")
    from pigeon_tpu_torch import mpc
    from pigeon_tpu_torch.solver import pallas_admm as pa

    saved = torch.load(Path(out_dir) / "inputs.pt")
    res = {}
    for name, (form, _, unbatched) in CASES.items():
        c = saved[name]
        layout = _pattern(cs, form, unbatched)
        sparse = form.startswith("sparse")
        modes = ("highest", "mixedk6") if sparse else (
            c["options"].get("precision", "highest"),)
        names = (("narrow", "wide", "large") if sparse
                 else ("large", "pair") if form == "decoupled_sparse"
                 else ("wide", "narrow"))
        for mode in modes:
            opt = dict(c["options"], precision=mode, bf16=False)
            if mode in pa.MIXED_MODES:
                opt["m_eq"] = int(np.asarray(
                    mpc._eq_rows_for(cs.fleet_config(form))).size)
            call = dict(c, options=opt)
            own = layout.for_mode(mode, opt.get("m_eq", 0),
                                  opt.get("dense_P", False))
            pats = {b: (own if b == own.build else layout.as_build(
                b, own.m_split if b in pa.LARGE_FORMS else 0))
                for b in names}
            calls = {b: _call(call, p) for b, p in pats.items()}
            ops, kw, n_iters, check = calls[own.build]
            held = {b: _held(cs, *calls[b], mode,
                             f"{name} {mode}, the {b} build",
                             form == "decoupled_sparse")
                    for b in names if b != own.build}
            t = lambda b: cs.cuda_ms(torch, lambda: cs.dense_admm(
                torch, *calls[b]), 5)
            order = names + names[::-1]
            ms = [t(b) for b in order]
            resid = {}
            for b, p in pats.items():
                r = cs.residency(torch, p, ops[1].shape[0], kw["tile"],
                                 kw.get("dense_P", False), mode)
                iters = float(cs.dense_admm(torch, *calls[b])[3][:, 6]
                              .mean())
                r["pipe_floor_ms"] = cs.pipe_floor_ms(torch, p, r,
                                                      kw["tile"], iters)
                resid[b] = r
            res[f"{name}_{mode}"] = dict(
                own=own.build, mode=mode, order=order, ms=ms,
                held_other=held, residency=resid)
            print(json.dumps({f"{name}_{mode}": res[f"{name}_{mode}"]}),
                  flush=True)
    res["device"] = cs.nvidia_smi()
    print(json.dumps({"b8_builds": res}), flush=True)


def _steps(rec):
    """A check's steps: converged shares and mean iterations (card, CPU
    float32) and the command error in bars."""
    return [dict(step=st["step"], converged=st["converged"],
                 iters_mean=st["iters_mean"], err_bars=st["err_bars"],
                 outside_bar=st["outside_bar"])
            for st in rec.get("steps", [])]


def placements():
    cs = _chip_smoke(".")
    from pigeon_tpu_torch import _kernels
    from pigeon_tpu_torch.solver import pallas_admm as pa

    plan, rule = pa.plan_build, cs.REF_RULES["sparse_mixedk6"]
    narrow = lambda rw, cw, mode="highest", dense_P=False: (
        "wide" if max(rw, cw) > pa.NARROW_WIDTH_MAX else "narrow")
    cs.REF_CONTROLS = {}
    res = []
    try:
        for build, b8 in (("large", "admm_large"), ("narrow", "admm_dense")):
            pa.plan_build = plan if build == "large" else narrow
            for seed in PLACEMENTS:
                cs.REF_RULES["sparse_mixedk6"] = dict(rule, seeds=(seed,))
                checks = [(f"ladder_{bulk}", lambda bulk=bulk: cs.ladder_check(
                    torch, _kernels, bulk, seed=seed, b8=b8))
                    for bulk in cs.LADDER_BULKS]
                checks.append(("reference", lambda: cs.reference_check(
                    torch, "sparse_mixedk6")["seeds"][0]))
                for name, fn in checks:
                    _kernels.reset_launches()
                    try:
                        rec = dict(ok=True, steps=_steps(fn()))
                    except RuntimeError as e:       # a bar it misses
                        rec = dict(ok=False, failed=str(e)[:1500])
                    rec.update(build=build, seed=seed, check=name,
                               b8_launches={k: _kernels.launches_by(k)
                                            for k in cs.B8_KERNELS})
                    res.append(rec)
                    print(json.dumps(rec), flush=True)
    finally:
        pa.plan_build, cs.REF_RULES["sparse_mixedk6"] = plan, rule
    print(json.dumps({"b8_placements": [
        {k: r[k] for k in ("build", "seed", "check", "ok")} for r in res],
        "device": cs.nvidia_smi()}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("b8_parent_ab: needs a CUDA card")
    cmd, rest = sys.argv[1], sys.argv[2:]
    t0 = time.perf_counter()
    {"capture": capture, "run": run, "builds": builds,
     "placements": placements,
     "compare": lambda d, *t: compare(d, list(t))}[cmd](*rest)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
