"""checkpoint_read_ms: the host wall of the program's checkpoint read in
the anytime resume (`repro_torch.scheduler.checkpoint_read`: `np.load`
and the crc32 checks), summed over the traced window and divided by its
jobs. None where the trace holds no such span."""

from mpbench import program_spans


def read(obs):
    t = program_spans.of(obs)
    if t is None:
        return None
    spans = t.spans.get("repro_torch.scheduler.checkpoint_read")
    jobs = t.spans.get("mpbench.job")
    if not spans or not jobs:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(jobs)
