"""Share of the traced periods' time in which no kernel, copy or fill ran
on the device (1 - busy / window, from torch.profiler's device events and
the host's clock over those periods)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0.0 or tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
