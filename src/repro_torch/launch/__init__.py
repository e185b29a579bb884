"""Command-line drivers of the port (`python -m repro_torch.launch.serve`,
`python -m repro_torch.launch.train`, `python -m repro_torch.launch.dryrun`,
`python -m repro_torch.launch.report`), the mesh builders (`mesh`), the
layouts (`sharding`) and the roofline model (`roofline`)."""
