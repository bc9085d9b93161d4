"""The streaming hop: STFT front half, OLA back half, batched masked step.

Counterpart of ``repro/serve/streaming_se.py`` for the deployed hop: the
per-stream ``StreamState`` (every leaf has a leading slot axis),
``init_stream``, ``reset_slots``, ``hop_analysis``, ``hop_synthesis`` and
``make_stream_hop`` with one hop per step on the deploy graph. The
reference donates the state to its jitted step; here the step updates the
state's tensors in place, which is what donation stands for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.audio.stft import hann
from repro_torch.core.quant import QuantSpec, quantize
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import tftnn as tft_mod


@dataclasses.dataclass
class StreamState:
    analysis: torch.Tensor  # (B, n_fft) rolling input window
    synthesis: torch.Tensor  # (B, n_fft) overlap-add accumulator
    wsum: torch.Tensor  # (B, n_fft) per-stream window-square accumulator
    model: Dict[str, torch.Tensor]  # TFTNN recurrent state, leaves (B, ...)

    def leaves(self):
        return [self.analysis, self.synthesis, self.wsum, *self.model.values()]


def init_stream(params: Any, cfg: tft_mod.TFTConfig, batch: int, *,
                device: DeviceLike = None) -> StreamState:
    """Zeroed streaming state for ``batch`` independent streams."""
    dev = resolve_device(device)
    return StreamState(
        analysis=torch.zeros((batch, cfg.n_fft), device=dev),
        synthesis=torch.zeros((batch, cfg.n_fft), device=dev),
        wsum=torch.zeros((batch, cfg.n_fft), device=dev),
        model=tft_mod.init_stream_state(params, cfg, batch, device=dev),
    )


def reset_slots(state: StreamState, slot_mask: torch.Tensor) -> StreamState:
    """Zero, in place, every slot's state where ``slot_mask`` (B,) is True."""
    for leaf in state.leaves():
        leaf[slot_mask.to(leaf.device)] = 0.0
    return state


def hop_analysis(
    state: StreamState,
    hop_samples: torch.Tensor,
    cfg: tft_mod.TFTConfig,
    quant: Optional[QuantSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roll the analysis window, window, rFFT, quantize.

    Returns ``(analysis, frame_ri)``: the new (B, n_fft) window and the
    (B, F, 2) spectral frame entering the model.
    """
    w = hann(cfg.n_fft, hop_samples.dtype, hop_samples.device)
    analysis = torch.cat([state.analysis[:, cfg.hop :], hop_samples], dim=1)
    # The FFT runs in float64 and rounds once to float32, so the frame is the
    # same on every device before it is quantized: grid rounding is
    # discontinuous, and float32 FFTs of cuFFT and the CPU differ in the last
    # bits often enough to move FP10 values to the next grid point.
    spec = torch.fft.rfft((analysis * w).double(), dim=-1)
    frame_ri = torch.stack([spec.real, spec.imag], dim=-1).float()
    if quant is not None:
        frame_ri = quantize(frame_ri, quant)
    return analysis, frame_ri


def hop_synthesis(
    state: StreamState,
    analysis: torch.Tensor,
    frame_ri: torch.Tensor,
    mask: torch.Tensor,
    model_state: Dict[str, torch.Tensor],
    cfg: tft_mod.TFTConfig,
) -> Tuple[StreamState, torch.Tensor]:
    """Apply the complex mask, irFFT, weighted overlap-add with ``wsum``."""
    n_fft, hop = cfg.n_fft, cfg.hop
    w = hann(n_fft, frame_ri.dtype, frame_ri.device)
    a, b = frame_ri[..., 0], frame_ri[..., 1]
    m = 2.0 * torch.tanh(mask)
    mc, md = m[..., 0], m[..., 1]
    est = torch.complex(a * mc - b * md, a * md + b * mc)
    y = torch.fft.irfft(est, n=n_fft, dim=-1) * w
    synthesis = state.synthesis + y
    wsum = state.wsum + (w * w)[None, :]
    out = synthesis[:, :hop] / torch.clamp(wsum[:, :hop], min=1e-8)
    new_state = StreamState(
        analysis=analysis,
        synthesis=torch.cat([synthesis[:, hop:], torch.zeros_like(synthesis[:, :hop])], dim=1),
        wsum=torch.cat([wsum[:, hop:], torch.zeros_like(wsum[:, :hop])], dim=1),
        model=model_state,
    )
    return new_state, out


def make_stream_hop(
    params: Any,
    cfg: tft_mod.TFTConfig,
    *,
    quant: Optional[QuantSpec] = None,
    donate: bool = True,
    backend: str = "pallas",
    prune_keep: Optional[float] = None,
    max_hops_per_step: int = 1,
    from_ring: Optional[int] = None,
    passthrough: bool = False,
    device: DeviceLike = None,
) -> Callable[[StreamState, torch.Tensor, torch.Tensor], Tuple[StreamState, torch.Tensor]]:
    """The batched one-hop step on the deploy graph.

    Returns ``step(state, hops, active) -> (state, out)`` where ``hops`` is
    (B, hop) audio (garbage for idle slots) and ``active`` a (B,) bool mask:
    slots where it is False keep their state bit for bit and emit zeros.
    ``state`` is updated in place (the reference's ``donate=True``) and
    returned.

    ``backend`` keeps the reference's name for the deploy graph
    (``"pallas"``); on the card it runs the hand-written CUDA kernels. The
    reference's other settings (``donate=False``, ``backend="xla"``,
    ``prune_keep``, ``max_hops_per_step > 1``, ``from_ring``,
    ``passthrough``) are not ported yet and raise ``NotImplementedError``.
    """
    from repro_torch.serve.deploy import build_deploy_plan, stream_hop_fused

    unported = {
        "donate=False": not donate,
        f"backend={backend!r}": backend != "pallas",
        "prune_keep": prune_keep is not None,
        "max_hops_per_step > 1": max_hops_per_step != 1,
        "from_ring": from_ring is not None,
        "passthrough": passthrough,
    }
    for knob, asked in unported.items():
        if asked:
            raise NotImplementedError(f"make_stream_hop: {knob} is not ported yet")
    plan = build_deploy_plan(params, cfg, quant=quant, device=device)

    @torch.no_grad()
    def step(state: StreamState, hops: torch.Tensor, active: torch.Tensor):
        stepped, out = stream_hop_fused(plan, state, hops)
        for old, new in zip(state.leaves(), stepped.leaves()):
            m = active.reshape((-1,) + (1,) * (new.dim() - 1))
            old.copy_(torch.where(m, new, old))
        return state, torch.where(active[:, None], out, torch.zeros_like(out))

    return step
