"""device_idle_pct: the share of the traced window's wall time that no
device operation covers, in percent."""


def read(obs):
    t = obs.trace
    w = None if t is None else t.window()
    if w is None or not t.ops:
        return None
    busy = sum(b - a for a, b in t.busy(*w))
    return 100.0 * (1.0 - busy / (w[1] - w[0]))
