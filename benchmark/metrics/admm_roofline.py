"""The dense ADMM kernel's share of its roofline over the traced periods:
the least time the card's published peaks allow for the operations and
bytes the solves needed (`benchmark/counts/admm.py`, from each solve's
executed iterations; bytes once a step, however many launches), over
the kernel's device time in the trace."""

from benchmark.counts import admm


def read(rec):
    tr = rec.get("trace")
    its = rec.get("traced_iterations")
    if not tr or its is None:
        return None
    hits = [v for k, v in tr["kernels"].items() if admm.KERNEL.search(k)]
    seconds = sum(v["seconds"] for v in hits)
    if seconds <= 0.0:
        return None
    L = rec["layout"]
    ops = admm.operations(its, L["n"], L["m"], L["nnz"], rec["check"])
    steps = its.numel() // rec["batch"]
    nbytes = steps * admm.bytes_per_step(rec["batch"], L["n"], L["m"],
                                         L["nnz"])
    return 100.0 * admm.least_seconds(ops, nbytes, rec["peaks"]) / seconds
