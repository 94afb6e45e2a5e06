"""Mean executed ADMM iterations a solve over the window (the step's
diagnostics, `StepDiagnostics.iterations`, summed on the device)."""


def read(rec):
    solves = rec["batch"] * rec["periods"]
    if not solves:
        return None
    return rec["counters"]["iterations"] / solves
