"""Share of the traced window in which no operation runs on the device:
100 * (1 - union of the device events' intervals / window)."""


def read(obs):
    tr = obs.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.events else None
