"""setup_s: host seconds from the process's start to the window: imports,
the series, stream prep, the scheduler's plan, and the warm-up jobs, which
build the kernel on a checkout's first run."""


def read(obs):
    return obs.setup_s
