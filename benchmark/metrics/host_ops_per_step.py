"""Aten operations the host dispatches a period (the traced periods'
outermost aten operations, from torch.profiler's CPU events)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["periods"]:
        return None
    return tr["host_ops"] / tr["periods"]
