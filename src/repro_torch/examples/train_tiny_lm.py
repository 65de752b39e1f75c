"""Train a ~100M-parameter starcoder2-family model (starcoder2-3b's tiny
config widened: 6 layers, d_model 512) for a few hundred steps, with
checkpoints every 100 steps and, optionally, a share of the optimizer
state paged through the slow tier; asserts that the loss decreases.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm \\
        [--steps 200] [--offload 0.25] [--device cpu]

The port of ``examples/train_tiny_lm.py``: it drives the training
driver through its own arguments (``train.main(cfg=..., params=...)``)
instead of patching the registry.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.launch import train
from repro_torch.models import registry

ARCH = "starcoder2-3b"


def config():
    """starcoder2-3b's tiny config widened to ~100M parameters."""
    return dataclasses.replace(
        registry.get(ARCH).cfg.tiny(), name="starcoder2-100m", n_layers=6,
        d_model=512, n_heads=8, n_kv_heads=2, d_ff=2048, vocab=32768,
        head_dim=64, max_seq=512)


def main(argv=None, *, params=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--offload", type=float, default=0.0,
                    help="fraction of optimizer state paged to the slow tier")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    args = ap.parse_args(argv)
    losses = train.main([
        "--arch", ARCH, "--tiny", "--steps", str(args.steps),
        "--batch", "4", "--seq", "256", "--lr", "6e-4",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--offload-fraction", str(args.offload), "--log-every", "20",
        "--device", args.device,
    ], params=params, cfg=config())
    assert losses[-1] < losses[0], "loss should decrease"
    return losses


if __name__ == "__main__":
    main()
