"""The streaming hop: STFT front half, OLA back half, batched masked step.

Counterpart of ``repro/serve/streaming_se.py``: the per-stream
``StreamState`` (every leaf has a leading slot axis), ``init_stream``,
``reset_slots``, ``hop_analysis``, ``hop_synthesis``, the training-graph hop
``stream_hop``, ``make_stream_hop`` with one hop per step on either graph
(``backend="xla"``: ``stream_hop``; ``backend="pallas"``: the deploy graph),
and the utterance drivers ``enhance_streaming`` and ``enhance_offline``. The
reference donates the state to its jitted step; here the step updates the
state's tensors in place, which is what donation stands for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.audio.stft import hann
from repro_torch.bridge import tree_to
from repro_torch.core.quant import QuantSpec, quantize, quantize_tree
from repro_torch.kernels.runtime import DeviceLike, resolve_device, strict_fp32
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


def stream_hop(
    params: Any,
    cfg: tft_mod.TFTConfig,
    state: StreamState,
    hop_samples: torch.Tensor,
    *,
    quant: Optional[QuantSpec] = None,
    sub_grus: Optional[Tuple[torch.nn.GRU, ...]] = None,
) -> Tuple[StreamState, torch.Tensor]:
    """Push one hop of audio (B, hop) through the training graph; emit one hop.

    Pure in ``(state, hop_samples)``: returns a new ``StreamState`` and the
    (B, hop) enhanced audio. ``quant`` rounds the spectral frame entering
    the model and the mask leaving it (weights are the caller's job, as in
    ``make_stream_hop``). ``sub_grus``: ``tftnn.sub_band_grus(params)``,
    built once by a caller that steps many hops.
    """
    analysis, frame_ri = hop_analysis(state, hop_samples, cfg, quant)
    model_state, mask = tft_mod.stream_step(params, state.model, frame_ri, cfg, sub_grus=sub_grus)
    if quant is not None:
        mask = quantize(mask, quant)
    return hop_synthesis(state, analysis, frame_ri, mask, model_state, cfg)


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
    """The batched one-hop step shared by the pool and the benchmarks.

    Returns ``step(state, hops, active) -> (state, out)`` where ``hops`` is
    (B, hop) audio (garbage for idle slots) and ``active`` a (B,) bool mask:
    slots where it is False keep their state bit for bit and emit zeros.
    ``state`` is updated in place (the reference's ``donate=True``) and
    returned.

    ``backend`` selects the hop, with the reference's names:

    - ``"pallas"`` (the port's default): the deploy graph
      (``serve.deploy``), BN folded out, on the card the hand-written
      dilated-conv, linear-attention-step and masked-MAC kernels;
    - ``"xla"`` (the reference's default): the training graph
      (``stream_hop``), on the card the non-causal linear-attention kernel.

    With ``quant`` the weights are rounded onto its grid once, here, and
    every hop rounds its frame and its mask (on the card through the FP10
    kernel). The reference's other settings (``donate=False``,
    ``prune_keep``, ``max_hops_per_step > 1``, ``from_ring``,
    ``passthrough``) are not ported yet and raise ``NotImplementedError``.

    Raises:
        ValueError: ``backend`` is neither ``"xla"`` nor ``"pallas"``.
        NotImplementedError: an unported setting was asked for.
        RuntimeError: the device is CUDA and CUDA is not available.
    """
    from repro_torch.serve.deploy import build_deploy_plan, stream_hop_fused

    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}: expected 'xla' or 'pallas'")
    unported = {
        "donate=False": not donate,
        "prune_keep": prune_keep is not None,
        "max_hops_per_step > 1": max_hops_per_step != 1,
        "from_ring": from_ring is not None,
        "passthrough": passthrough,
    }
    for knob, asked in unported.items():
        if asked:
            raise NotImplementedError(f"make_stream_hop: {knob} is not ported yet")
    if backend == "xla":
        dev = resolve_device(device)
        strict_fp32(dev)
        params = tree_to(params, dev)
        if quant is not None and quant.kind != "none":
            params = quantize_tree(params, quant)
        sub_grus = tft_mod.sub_band_grus(params)

        def hop(state: StreamState, hops: torch.Tensor):
            return stream_hop(params, cfg, state, hops, quant=quant, sub_grus=sub_grus)
    else:
        plan = build_deploy_plan(params, cfg, quant=quant, device=device)

        def hop(state: StreamState, hops: torch.Tensor):
            return stream_hop_fused(plan, state, hops)

    @torch.no_grad()
    def step(state: StreamState, hops: torch.Tensor, active: torch.Tensor):
        stepped, out = hop(state, hops)
        for old, new in zip(state.leaves(), stepped.leaves()):
            m = active.reshape((-1,) + (1,) * (new.dim() - 1))
            old.copy_(torch.where(m, new, old))
        return state, torch.where(active[:, None], out, torch.zeros_like(out))

    return step


def _wave_on(wave: Any, dev: torch.device) -> torch.Tensor:
    if not isinstance(wave, torch.Tensor):
        wave = torch.from_numpy(np.ascontiguousarray(wave, np.float32))
    if wave.dim() != 2:
        raise ValueError(f"wave: expected (B, S), got shape {tuple(wave.shape)}")
    return wave.to(device=dev, dtype=torch.float32)


@torch.no_grad()
def enhance_streaming(
    params: Any,
    cfg: tft_mod.TFTConfig,
    wave: Any,
    *,
    quant: Optional[QuantSpec] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Run the streaming loop over a batch of utterances, hop by hop.

    Args:
        wave: (B, S) raw audio (tensor or array); trailing samples past a
            whole hop are dropped.
        quant: optional activation grid, as in ``stream_hop`` (weights are
            not quantized here; pre-quantize ``params`` for full PTQ).
        device: where it runs (``cuda`` unless told otherwise).

    Returns:
        (B, S') enhanced audio on ``device``, ``S' = (S // hop) * hop``,
        equal to ``enhance_offline`` up to float error (the streaming
        invariant). A Python loop over the hops stands in for the
        reference's ``lax.scan``.
    """
    dev = resolve_device(device)
    strict_fp32(dev)
    params = tree_to(params, dev)
    sub_grus = tft_mod.sub_band_grus(params)
    wave = _wave_on(wave, dev)
    B, hop = wave.shape[0], cfg.hop
    n = wave.shape[1] // hop
    st = init_stream(params, cfg, B, device=dev)
    outs = []
    for i in range(n):
        st, y = stream_hop(params, cfg, st, wave[:, i * hop : (i + 1) * hop], quant=quant,
                           sub_grus=sub_grus)
        outs.append(y)
    return torch.cat(outs, dim=1) if outs else wave[:, :0].clone()


@torch.no_grad()
def enhance_offline(params: Any, cfg: tft_mod.TFTConfig, wave: Any, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """Offline reference for the streaming loop: framed STFT -> mask -> OLA.

    Frames the signal exactly as the hop loop sees it (zero history of
    ``n_fft - hop`` samples, window ending at sample ``(k+1)*hop``), runs
    ``apply_tft`` over the whole utterance at once, and synthesizes by
    weighted overlap-add with the squared-window normalizer, so
    ``enhance_streaming(x) == enhance_offline(x)`` for every hop, warm-up
    included, up to float error. The FFTs are float32, as in the reference.

    The overlap-add is a fixed sequence of shifted block sums (no scatter,
    no atomics), so it is deterministic on every device.

    Returns:
        (B, S') enhanced audio on ``device``, ``S' = (S // hop) * hop``.
    """
    dev = resolve_device(device)
    strict_fp32(dev)
    params = tree_to(params, dev)
    wave = _wave_on(wave, dev)
    B = wave.shape[0]
    n_fft, hop = cfg.n_fft, cfg.hop
    n = wave.shape[1] // hop
    if n == 0:
        return wave[:, :0].clone()
    w = hann(n_fft, wave.dtype, dev)
    x = F.pad(wave[:, : n * hop], (n_fft - hop, 0))
    frames = x.unfold(-1, n_fft, hop) * w  # (B, T, n_fft): frame t ends at (t+1)*hop
    spec = torch.fft.rfft(frames, dim=-1)  # (B, T, F)
    spec_ri = torch.stack([spec.real, spec.imag], dim=-1).transpose(1, 2)  # (B, F, T, 2)

    mask, _ = tft_mod.apply_tft(params, spec_ri, cfg)

    a, b = spec_ri[..., 0], spec_ri[..., 1]
    m = 2.0 * torch.tanh(mask)
    mc, md = m[..., 0], m[..., 1]
    est = torch.complex(a * mc - b * md, a * md + b * mc).transpose(1, 2)  # (B, T, F)
    y = torch.fft.irfft(est, n=n_fft, dim=-1) * w  # (B, T, n_fft)

    # overlap-add in hop-sized blocks: block k of the output gets block r of
    # frame k - r, for r = 0 .. R-1 (frames zero-padded to R whole blocks)
    R = -(-n_fft // hop)
    yb = F.pad(y, (0, R * hop - n_fft)).reshape(B, n, R, hop)
    wb = F.pad(w * w, (0, R * hop - n_fft)).reshape(R, hop)
    acc = torch.zeros((B, n, hop), dtype=y.dtype, device=dev)
    wsq = torch.zeros((n, hop), dtype=y.dtype, device=dev)
    for r in range(min(R, n)):
        acc[:, r:] += yb[:, : n - r, r]
        wsq[r:] += wb[r]
    out = acc / torch.clamp(wsq, min=1e-8)
    return out.reshape(B, n * hop)
