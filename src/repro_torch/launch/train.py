"""Training driver: config -> data -> train step -> checkpoint/restart,
with the NATSA telemetry monitor watching loss/grad-norm/step-time traces
— port of `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/run1

Runs on the CUDA card unless `--device cpu` is given. Restart resumes
from the newest intact checkpoint automatically. Checkpoints are written
in the reference's tree layout (`models.convert.params_to_reference`:
params and both AdamW moments stacked as `cfg.layer_groups()` says), so a
run resumes across packages, in either direction. Every family of
`repro_torch.configs` trains here (the loss adds `steps.AUX_WEIGHT` times
the MoE layers' aux). As the reference's trainer does, an M-RoPE model
(qwen2-vl-2b) gets 0..seq-1 in all three position streams, and an
encoder-decoder (whisper-large-v3) one fixed batch of frames,
`default_rng(0).normal(size=(batch, encoder_seq, d_model)) * 0.02`, drawn
in f64 by numpy and rounded to f32, then to the model's dtype.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.core.monitor import TelemetryMonitor
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.models import convert, transformer
from repro_torch.models import steps as steps_lib
from repro_torch.optim import adamw
from repro_torch.utils.device import resolve_device


def _ckpt_tree(cfg, model, opt_state) -> dict:
    """{params, opt} in the reference's layout, as host tensors."""
    def ref(tree):
        return convert.params_to_reference(adamw.leaves(tree), cfg)
    return {"params": ref(model),
            "opt": {"m": ref(opt_state["m"]), "v": ref(opt_state["v"]),
                    "step": opt_state["step"].cpu(), "err": None}}


@torch.no_grad()
def _load(model, opt_state, tree) -> None:
    """Copy a restored `_ckpt_tree` into the model and the state."""
    model.load_state_dict(convert.params_from_reference(tree["params"]))
    for key in ("m", "v"):
        got = convert.params_from_reference(tree["opt"][key])
        for path, t in adamw.leaves(opt_state[key]).items():
            t.copy_(got[path])
    opt_state["step"].copy_(tree["opt"]["step"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--monitor-window", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    dev = resolve_device(args.device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                                total_steps=args.steps)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    model = transformer.Transformer(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(args.seed))
    opt_state = adamw.init_state(model)
    start_step, final_loss = 0, float("nan")
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (restored, start_step, meta) = ckpt.restore(
            args.ckpt_dir, _ckpt_tree(cfg, model, opt_state))
        _load(model, opt_state, restored)
        # a run resumed at its end takes no step and keeps its loss
        final_loss = meta.get("loss", final_loss)
        print(f"[train] resumed from step {start_step}")

    step_fn = steps_lib.make_train_step(cfg, None, opt_cfg,
                                        microbatches=args.microbatches)

    monitors = {
        name: TelemetryMonitor(window=args.monitor_window, min_history=64,
                               device=dev)
        for name in ("loss", "grad_norm", "step_time")}

    extra = {}
    if cfg.mrope_sections:
        extra["positions"] = torch.arange(
            args.seq, dtype=torch.int32, device=dev).expand(
                3, args.batch, args.seq)
    if cfg.is_encdec:
        frames = np.random.default_rng(0).normal(
            size=(args.batch, cfg.encoder_seq, cfg.d_model)) * 0.02
        extra["frames"] = torch.from_numpy(frames.astype(np.float32)).to(
            dev, cfg.dtype)

    t_prev = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(step).items()}
        batch.update(extra)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        final_loss = float(metrics["loss"])

        dt = time.time() - t_prev
        t_prev = time.time()
        monitors["loss"].push(final_loss)
        monitors["grad_norm"].push(float(metrics["grad_norm"]))
        monitors["step_time"].push(dt)

        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {final_loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} dt {dt*1e3:.0f}ms", flush=True)
            for name, mon in monitors.items():
                for d in mon.scan(top_k=1):
                    print(f"[monitor] DISCORD in {name} trace @step~"
                          f"{start_step + d.position} z={d.zscore:.1f} "
                          f"(matrix-profile telemetry alarm)", flush=True)
        if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                              or step == args.steps - 1):
            ckpt.save(args.ckpt_dir, step + 1,
                      _ckpt_tree(cfg, model, opt_state),
                      metadata={"arch": args.arch, "loss": final_loss})
    print(f"[train] done: final loss {final_loss:.4f}")
    return final_loss


if __name__ == "__main__":
    main()
