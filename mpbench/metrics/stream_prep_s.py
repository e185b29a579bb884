"""stream_prep_s: host seconds of the call that builds the series' streams
in set-up: `core/zstats.py compute_stats_host` with its upload (one-shot
cells), the `AnytimeScheduler` constructor, which is that and the chunk
plan (anytime cells)."""


def read(obs):
    return obs.setup_parts.get("stream_prep_s")
