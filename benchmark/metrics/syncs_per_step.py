"""The host's waits on the device a period, less the harness's own
synchronize that ends each period (CUDA runtime events of the traced
periods)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["periods"]:
        return None
    return tr["syncs"] / tr["periods"]
