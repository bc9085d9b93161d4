"""Serving launcher for the port (counterpart of ``repro/launch/serve.py``).

``--task pool`` serves ``--batch`` concurrent sessions through one
``SessionPool`` on the deployed hop, on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve --task pool --batch 8

The weights are random (``init_tft`` from ``--seed``). The input is noisy
audio made with numpy from ``--seed`` (a sine tone in white noise); the
reference's ``audio/synthetic`` corpus is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def reduced_cfg(cfg):
    """The small-trunk config behind ``--reduced`` (paper front end)."""
    return dataclasses.replace(cfg, freq_bins=64, channels=16, att_dim=8,
                               num_heads=1, gru_hidden=16, dilation_rates=(1, 2, 4))


def noisy_audio(batch: int, samples: int, seed: int, sample_rate: int = 8000) -> np.ndarray:
    """(batch, samples) float32: a random-pitch tone in white noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sample_rate
    f0 = rng.uniform(150.0, 400.0, size=(batch, 1))
    tone = 0.5 * np.sin(2 * np.pi * f0 * t)
    return (tone + 0.3 * rng.standard_normal((batch, samples))).astype(np.float32)


def serve_pool(args) -> None:
    from repro_torch.core.quant import FP10
    from repro_torch.models import tftnn as tft
    from repro_torch.serve import SessionPool

    cfg = tft.tftnn_config()
    if args.reduced:
        cfg = reduced_cfg(cfg)
    params = tft.init_tft(torch.Generator().manual_seed(args.seed), cfg)
    pool = SessionPool(params, cfg, capacity=max(args.batch, 1),
                       quant=FP10 if args.quant else None, device=args.device)
    audio = noisy_audio(args.batch, args.samples, args.seed, pool.sample_rate)
    sessions = [pool.attach() for _ in range(args.batch)]
    for i, s in enumerate(sessions):
        pool.feed(s, audio[i])
    pool.pump()
    print(pool.report())
    for s in sessions:
        pool.detach(s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve the deployed TFTNN hop through the PyTorch/CUDA port. "
        "Weights are random (from --seed); the input is a noisy tone made "
        "with numpy from --seed, since the reference's synthetic corpus "
        "(audio/synthetic) is not ported yet."
    )
    ap.add_argument("--task", default="pool", choices=["pool"],
                    help="pool: --batch sessions through one SessionPool")
    ap.add_argument("--reduced", action="store_true", help="small trunk (quick runs)")
    ap.add_argument("--quant", action="store_true", help="serve on the FP10 grid")
    ap.add_argument("--batch", type=int, default=1, help="concurrent sessions")
    ap.add_argument("--samples", type=int, default=16000, help="samples fed per session")
    ap.add_argument("--seed", type=int, default=0, help="seed for weights and audio")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    {"pool": serve_pool}[args.task](args)


if __name__ == "__main__":
    main()
