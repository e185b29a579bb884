"""round_launches: kernels launched per round, as the profiler counts them
inside the rounds' spans."""


def read(obs):
    t = obs.trace
    if t is None or not t.ops:
        return None
    per = [len(ops) for _, ops in t.launched_in("mpbench.round",
                                                 kinds=("kernel",))]
    return sum(per) / len(per) if per else None
