"""One reader a metric: `read(obs)` gives its value from what a run
observed (the namespace `harness` builds), or None where the run has
nothing to read it from; a share of a roofline or of a peak is then left
out, never 0."""
