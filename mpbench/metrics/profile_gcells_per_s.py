"""profile_gcells_per_s: exact profile cells of every job completed in the
window over the window's host seconds, which run to the end of the last
job started within --seconds. The cells are the harness's count."""


def read(obs):
    if not obs.jobs_done:
        return None
    return obs.jobs_done * obs.cells_per_job / obs.window_s / 1e9
