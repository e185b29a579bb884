"""Kinds of configuration, one module a kind (`kinds/<kind>.py`), found by
a configuration's `kind` key. A kind makes the input from `--seed`
(`inputs`), compares a delivered answer with the configuration's plain
reference (`readings`, with `EXACT` the numbers that must read 0), and
gives the lower-precision control (`control`). A kind imports nothing of
the program."""
