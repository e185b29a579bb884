"""The benchmark of `repro_torch`, the PyTorch and CUDA port: exact matrix
profiles of the NATSA paper's series on one card, one-shot and anytime.

`run.py` is the entry point. Everything that belongs to one configuration
(`configs/<name>.json`), one traffic mix (`traffic/<name>.json`), one kind
of job (`jobs/<job>.py`), one kind of configuration with its inputs and
comparison (`kinds/<kind>.py`), one metric (`metrics/<name>.py`) or one
plain reference (`references/<name>.py`) sits in a file of its own, found
by the name `BENCHMARK.json`, a configuration or a mix gives it.
"""
