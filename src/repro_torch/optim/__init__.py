"""The optimizer of the LM training path — port of `repro.optim`."""
