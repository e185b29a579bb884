"""Checkpoints of the port: `ckpt`, the reference's format-2 npz store."""
