"""End-to-end training on the PyTorch/CUDA port: a small dense LM
trained for a few hundred steps with checkpoint/restart and the NATSA
telemetry monitor attached — `examples/train_lm.py`'s scenario through
`repro_torch.launch.train`. The model (`llama3-mini`, ~17M parameters, f32)
is registered in `repro_torch.configs.REGISTRY` for the two runs and taken
out again afterwards; its attention runs the flash kernel's `fma` route on
the card (f32), the kernel's plain version on the host.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 150]               # the card
    PYTHONPATH=src python examples/train_lm_torch.py [--steps 150] --device cpu  # the host
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

ARCH = "llama3-mini"


def mini_config():
    """The reference example's model: llama3-8b cut to 6 layers of width
    384 (6 heads, 3 KV heads of 64), d_ff 1152, a 16,384 vocabulary, f32,
    no remat."""
    from repro_torch.configs import llama3_8b

    return dataclasses.replace(
        llama3_8b.config(), n_layers=6, d_model=384, n_heads=6, n_kv_heads=3,
        head_dim=64, d_ff=1152, vocab_size=16384, dtype=torch.float32,
        q_chunk=128, remat=False, name=ARCH)


def train_and_restart(device=None, steps: int = 150,
                      ckpt_dir: str | None = None, ckpt_every: int = 50,
                      restart: int = 10) -> tuple[float, float, str]:
    """Train `steps` steps on `device` (None: the card), logging every 20,
    then restart from the written checkpoint for `restart` more, logging
    every 5; returns both final losses and the checkpoint directory (None:
    a new temporary one). `llama3-mini` is in `configs.REGISTRY` only
    while this runs."""
    from repro_torch import configs
    from repro_torch.launch import train

    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    small = mini_config()
    configs.REGISTRY[ARCH] = type(
        "M", (), {"config": staticmethod(lambda: small),
                  "smoke": staticmethod(lambda: small)})
    dev = [] if device is None else ["--device", str(device)]

    def run(n_steps: int, log_every: int) -> float:
        return train.main([
            "--arch", ARCH, "--smoke",
            "--steps", str(n_steps), "--batch", "4", "--seq", "96",
            "--lr", "3e-3", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(ckpt_every), "--log-every", str(log_every),
            *dev])

    try:
        return run(steps, 20), run(steps + restart, 5), ckpt_dir
    finally:
        del configs.REGISTRY[ARCH]


def main(device=None, steps: int = 150, ckpt_dir: str | None = None) -> dict:
    """The reference example's schedule on `device` (None: the card):
    `steps` steps, checkpoints every 50, a restart for 10 more; returns
    both final losses and the checkpoint directory."""
    loss, loss2, ckpt_dir = train_and_restart(device, steps, ckpt_dir)
    assert loss < 6.5, f"loss did not improve enough: {loss}"  # corpus entropy floor ~6.0
    print(f"final loss {loss:.3f} (from ~9.7 at init) — learned the "
          f"synthetic corpus; checkpoints in {ckpt_dir}")
    print(f"restart-from-checkpoint OK (resumed and reached {loss2:.3f})")
    return {"loss": loss, "restart_loss": loss2, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new one under "
                         "the system's temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(args.device, args.steps, args.ckpt_dir)
