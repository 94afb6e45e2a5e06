"""Run the dense ADMM kernel (B8) of two checkouts of the port, or its two
builds, on the same captured inputs, on one card, and compare them.

    python3 scripts/b8_parent_ab.py capture DIR
    python3 scripts/b8_parent_ab.py run ROOT DIR NAME
    python3 scripts/b8_parent_ab.py compare DIR NAME [NAME ...]
    python3 scripts/b8_parent_ab.py builds DIR

`capture` (with this checkout's package) saves one call of the kernel
from each hard path, captured as chip_smoke.py captures it: the first
segment of a cold and of a warm step of the sparse fleet (B = 2048, mode
"highest", the narrow build), of the sparse fleet in mode "mixedk6", of
the condensed fleet (dense P), and the unbatched condensed route's first
segment (tile 1).  `run` loads them and, with the package and the
chip_smoke.py of the checkout at ROOT, packs A into that checkout's
pattern of the path's layout, runs each call, times it (chip_smoke's
`cuda_ms`, 5 calls) and saves the outputs and times as NAME.  `compare`
prints one JSON line: for each call, whether the outputs of the NAMEs
are bit-equal, and each NAME's times.  Run parent, change, change,
parent, so that drift on the card shows.  `builds` runs each saved call in
both builds of this checkout (`EllPattern.as_build`: the narrow and the
wide one), the other build, the path's own, its own, the other (device
times), prints each build's shared bytes, registers, resident clusters
and waves, and holds the build the path does not take as chip_smoke.py
holds the path's own, under its bars (`held_segment`, `held_mode` in a
split mode, `held_fixed` at tile 1): one JSON line.  Needs a CUDA card.
"""

import json
import sys
import time
from pathlib import Path

import torch

CASES = {
    # name: (chip_smoke formulation, warm step, unbatched route)
    "sparse_cold": ("sparse", False, False),
    "sparse_warm": ("sparse", True, False),
    "sparse_mixedk6_cold": ("sparse_mixedk6", False, False),
    "condensed_cold": ("condensed", False, False),
    "condensed_warm": ("condensed", True, False),
    "condensed_tile1": ("condensed", False, True),
}
OPTIONS = ("tile", "check", "eps_abs", "eps_rel", "dense_P", "precision",
           "bf16", "m_eq")


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


def _pattern(cs, form, unbatched):
    """The static pattern of the path's layout, as the path passes it."""
    from pigeon_tpu_torch import mpc

    cfg = (cs.simulate_setup(torch, form, "cuda", torch.float32)[0]
           if unbatched else cs.fleet_config(form))
    return mpc._a_pattern_for(cfg)


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


def run(root, out_dir, tag):
    cs = _chip_smoke(root)
    from pigeon_tpu_torch import _kernels

    saved = torch.load(Path(out_dir) / "inputs.pt")
    outs, rec = {}, {}
    for name, (form, _, unbatched) in CASES.items():
        c = saved[name]
        pattern = _pattern(cs, form, unbatched)
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
    for name in CASES:
        first = outs[tags[0]][name]
        res[name] = dict(
            bit_equal={t: all(torch.equal(a, b) for a, b in
                              zip(first, outs[t][name])) for t in tags},
            ms={t: recs[t][name]["ms"] for t in tags},
            build={t: recs[t][name]["build"] for t in tags})
    res["device"] = recs[tags[0]]["device"]
    print(json.dumps({"b8_parent_ab": res}), flush=True)


def builds(out_dir):
    cs = _chip_smoke(".")
    from pigeon_tpu_torch.solver import pallas_admm as pa

    saved = torch.load(Path(out_dir) / "inputs.pt")
    res = {}
    for name, (form, _, unbatched) in CASES.items():
        c = saved[name]
        layout = _pattern(cs, form, unbatched)
        own = layout.build
        other = {"narrow": "wide", "wide": "narrow"}[own]
        calls = {b: _call(c, layout.as_build(b)) for b in (own, other)}
        ops, kw, n_iters, check = calls[other]
        mode = pa.mode_of(kw.get("precision", "highest"),
                          kw.get("bf16", False), kw.get("m_eq", 0),
                          ops[1].shape[1])
        what = f"{name}, the {other} build"
        try:
            if mode != "highest":
                held = cs.held_mode(torch, ops, kw, n_iters, check, what)
            elif check > 0:
                held = cs.held_segment(torch, ops, kw, n_iters, check, what,
                                       some_early=False)[2]
            else:
                held = cs.held_fixed(torch, ops, kw, n_iters, what)
        except RuntimeError as e:            # a bar it misses: recorded
            held = dict(failed=str(e))
        t = lambda b: cs.cuda_ms(torch, lambda: cs.dense_admm(
            torch, *calls[b]), 5)
        order = (other, own, own, other)
        res[name] = dict(
            own=own, mode=mode, order=order, ms=[t(b) for b in order],
            held_other=held,
            residency={b: cs.residency(
                torch, calls[b][1]["pattern"], ops[1].shape[0], kw["tile"],
                kw.get("dense_P", False), mode) for b in (own, other)})
    res["device"] = cs.nvidia_smi()
    print(json.dumps({"b8_builds": res}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("b8_parent_ab: needs a CUDA card")
    cmd, rest = sys.argv[1], sys.argv[2:]
    t0 = time.perf_counter()
    {"capture": capture, "run": run, "builds": builds,
     "compare": lambda d, *t: compare(d, list(t))}[cmd](*rest)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
