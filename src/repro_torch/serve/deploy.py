"""Deploy compilation and the fused per-hop step on the hand-written kernels.

Counterpart of ``repro/serve/deploy.py``. ``build_deploy_plan`` folds every
BatchNorm into its neighbour (encoder/decoder convs, the extra Q/K BNs, the
pre-norm BN1/BN2 into the QKV projections and GRU input transforms) and
optionally rounds the folded weights onto a ``core.quant`` grid.
``stream_hop_fused`` runs one hop through the folded graph with the three
hot spots on kernels:

- encoder/decoder dilated residual convs -> ``kernels.dilated_conv``
  (8 launches per hop),
- sub-band softmax-free attention -> ``kernels.linear_attention``
  (one launch per transformer block),
- ``att_in``/``att_out``/``mask_conv1``/``mask_conv2`` ->
  ``kernels.masked_mac`` (4 launches per hop).

What the reference leaves to XLA stays plain PyTorch here: the frame
convolutions (``F.conv1d``), the dense projections, the sub-pixel reshape,
the STFT, and the GRUs (the sub-band bi-GRU as one ``torch.nn.GRU`` call per
block instead of 2 x F' sequential cell steps). On CUDA, TF32 is switched off
for cuDNN and cuBLAS so that convolutions, matmuls and the GRU keep float32.
Pruning (``prune_keep``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.bridge import tree_to
from repro_torch.core.bn import fold_bn_into_conv2d, fold_bn_into_linear
from repro_torch.core.bn_transformer import fold_qk_bn
from repro_torch.core.quant import QuantSpec, quantize, quantize_tree
from repro_torch.kernels.dilated_conv import dilated_split_conv
from repro_torch.kernels.linear_attention import linear_attention_step
from repro_torch.kernels.masked_mac import masked_matmul
from repro_torch.kernels.runtime import DeviceLike, resolve_device, strict_fp32
from repro_torch.models import tftnn as tft_mod
from repro_torch.models.tftnn import _sub_cfg
from repro_torch.serve.streaming_se import StreamState, hop_analysis, hop_synthesis

Params = Dict[str, Any]

# weights served through the masked-MAC kernel (the paper's pruned matmuls)
MASKED_WEIGHTS = ("att_in", "att_out", "mask_conv1", "mask_conv2")
# frame convolutions served by F.conv1d, weights kept in the (kf, 1, cin, cout) layout
FRAME_CONVS = ("enc_in", "enc_down", "dec_up", "dec_out")


@dataclasses.dataclass(frozen=True)
class DeployPlan:
    """The compiled serving artifact: folded weights + number format.

    Attributes:
        cfg: the deployable TFTNN config the plan was compiled for.
        params: folded parameter tree in the reference plan's layout (no
            BatchNorm entries; dilated weights (k, cin, cout); 1x1 weights
            (cin, cout)), on ``device``.
        quant: activation/weight grid (weights already rounded in ``params``).
        device: where the plan's tensors live and the hop runs.
        conv_w: the ``FRAME_CONVS`` weights transposed once to PyTorch's
            (cout, cin, kf) layout for ``F.conv1d``.
        sub_grus: one bidirectional ``torch.nn.GRU`` per transformer block,
            holding that block's folded ``gru_f``/``gru_b``.
    """

    cfg: tft_mod.TFTConfig
    params: Params
    quant: Optional[QuantSpec]
    device: torch.device
    conv_w: Dict[str, torch.Tensor]
    sub_grus: Tuple[torch.nn.GRU, ...]


def _squeeze_kt(w: torch.Tensor) -> torch.Tensor:
    """(kf, kt=1, cin, cout) -> (kf, cin, cout) for the 1-D kernels."""
    if w.shape[1] != 1:
        raise ValueError(f"deploy path requires kt=1 convs, got kt={w.shape[1]}")
    return w[:, 0].contiguous()


def _fold_conv(conv: Params, bn: Params) -> Params:
    w, b = fold_bn_into_conv2d(conv["w"], conv.get("b"), bn)
    return {"w": w, "b": b}


def _fold_gru(gru: Params, bn_pre: Params) -> Params:
    """Pre-fold a BN into the GRU's input transform (x @ wi + bi)."""
    wi, bi = fold_bn_into_linear(gru["wi"], gru["bi"], bn_pre, pre=True)
    return {**gru, "wi": wi, "bi": bi}


def _fold_dilated(layers: List[Params]) -> List[Params]:
    out = []
    for layer in layers:
        w, b = fold_bn_into_conv2d(layer["conv"]["w"], layer["conv"].get("b"), layer["norm"])
        out.append({"w": _squeeze_kt(w), "b": b})
    return out


def _dense_pair(p: Params) -> Params:
    b = p.get("b")
    if b is None:
        b = torch.zeros((p["w"].shape[-1],), dtype=p["w"].dtype, device=p["w"].device)
    return {"w": p["w"], "b": b}


def validate_deployable(cfg: tft_mod.TFTConfig) -> None:
    """The deploy path compiles exactly the paper's deployment graph."""
    problems = []
    if cfg.norm != "bn":
        problems.append(f"norm={cfg.norm!r} (need 'bn' — LN does not fold)")
    if cfg.activation != "relu":
        problems.append(f"activation={cfg.activation!r} (need 'relu')")
    if not cfg.softmax_free:
        problems.append("softmax attention (need softmax-free, Eq. 1)")
    if cfg.mask_gtu:
        problems.append("GTU mask module (pruned away in TFTNN)")
    if cfg.dilated_block != "residual_split":
        problems.append(f"dilated_block={cfg.dilated_block!r} (need 'residual_split')")
    if not cfg.is_causal:
        problems.append("non-causal config (streaming deploy needs kt=1, "
                        "sub-band-only attention, uni-directional full-band GRU)")
    if problems:
        raise ValueError(f"config {cfg.name!r} is not deploy-compilable: " + "; ".join(problems))


def build_deploy_plan(
    params: Params,
    cfg: tft_mod.TFTConfig,
    *,
    quant: Optional[QuantSpec] = None,
    prune_keep: Optional[float] = None,
    prune_axis: Optional[int] = None,
    prune_granularity: Optional[str] = None,
    device: DeviceLike = None,
) -> DeployPlan:
    """Compile a TFTNN parameter tree (reference ``init_tft`` layout) into
    the deployment graph, on ``device`` (``cuda`` by default).

    Folding is exact algebra; with ``quant`` the folded weights are rounded
    onto its grid here, once. On CUDA this switches off TF32 in cuDNN and
    cuBLAS and makes cuDNN deterministic (``torch.backends``, process-wide),
    so the hop keeps float32 and a slot's output never depends on its
    neighbours.

    Raises:
        NotImplementedError: a pruning knob was given (not ported yet).
        ValueError: ``cfg`` is not the deployable TFTNN corner.
        RuntimeError: the device is CUDA and CUDA is not available.
    """
    for knob, value in (("prune_keep", prune_keep), ("prune_axis", prune_axis),
                        ("prune_granularity", prune_granularity)):
        if value is not None:
            raise NotImplementedError(f"build_deploy_plan: {knob} (pruning) is not ported yet")
    validate_deployable(cfg)
    dev = resolve_device(device)
    strict_fp32(dev)
    params = tree_to(params, dev)
    dp: Params = {
        "enc_in": _fold_conv(params["enc_in"], params["enc_in_norm"]),
        "enc_dilated": _fold_dilated(params["enc_dilated"]["layers"]),
        "enc_down": _fold_conv(params["enc_down"], params["enc_down_norm"]),
        "att_in": _dense_pair(params["att_in"]),
        "att_out": _dense_pair(params["att_out"]),
        "mask_conv1": {"w": params["mask_conv1"]["w"][0, 0], "b": params["mask_conv1"]["b"]},
        "mask_conv2": {"w": params["mask_conv2"]["w"][0, 0], "b": params["mask_conv2"]["b"]},
        "dec_dilated": _fold_dilated(params["dec_dilated"]["layers"]),
        "dec_up": _fold_conv(params["dec_up"], params["dec_up_norm"]),
        "dec_out": {"w": params["dec_out"]["w"], "b": params["dec_out"]["b"]},
    }
    blocks: List[Params] = []
    sub_cfg = _sub_cfg(cfg)
    for blk in params["blocks"]:
        sub = fold_qk_bn(blk["sub"], sub_cfg)  # the extra Q/K BNs (post)
        folded_sub: Params = {}
        for proj in ("wq", "wk", "wv"):  # pre-norm BN1 (pre)
            w, b = fold_bn_into_linear(sub[proj]["w"], sub[proj].get("b"), blk["sub"]["bn1"], pre=True)
            folded_sub[proj] = {"w": w, "b": b}
        folded_sub["wo"] = _dense_pair(sub["wo"])
        folded_sub["gru_f"] = _fold_gru(sub["gru_f"], blk["sub"]["bn2"])  # BN2 (pre)
        folded_sub["gru_b"] = _fold_gru(sub["gru_b"], blk["sub"]["bn2"])
        folded_sub["w_out"] = _dense_pair(sub["w_out"])
        full = {
            "gru_f": _fold_gru(blk["full"]["gru_f"], blk["full"]["bn2"]),
            "w_out": _dense_pair(blk["full"]["w_out"]),
        }
        blocks.append({"sub": folded_sub, "full": full})
    dp["blocks"] = blocks
    if quant is not None and quant.kind != "none":
        dp = quantize_tree(dp, quant)
    # the kernels take contiguous float32 weights
    for name in MASKED_WEIGHTS:
        dp[name] = {k: v.contiguous() for k, v in dp[name].items()}
    conv_w = {name: dp[name]["w"][:, 0].permute(2, 1, 0).contiguous() for name in FRAME_CONVS}
    sub_grus = tuple(nn.bigru_module(b["sub"]["gru_f"], b["sub"]["gru_b"]) for b in blocks)
    return DeployPlan(cfg=cfg, params=dp, quant=quant, device=dev, conv_w=conv_w, sub_grus=sub_grus)


# ---------------------------------------------------------------------------
# The fused forward (one spectrogram frame), kernels in the hot spots
# ---------------------------------------------------------------------------

def _conv_f(plan: DeployPlan, name: str, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv along F on (B, F, C) with a folded (kf,1,cin,cout)."""
    w = plan.conv_w[name]  # (cout, cin, kf)
    kf = w.shape[-1]
    pad = (kf - 1) // 2
    xt = x.transpose(1, 2)
    if kf - 1 - pad != pad:
        xt = F.pad(xt, (pad, kf - 1 - pad))
        pad = 0
    y = F.conv1d(xt, w, plan.params[name]["b"], stride=stride, padding=pad)
    return y.transpose(1, 2)


def _mm(plan: DeployPlan, name: str, x: torch.Tensor) -> torch.Tensor:
    """Masked-MAC matmul for one of the plan's pruned weights."""
    p = plan.params[name]
    return masked_matmul(x.contiguous(), p["w"], p["b"])


def _dilated_fused(plan: DeployPlan, layers: List[Params], x: torch.Tensor) -> torch.Tensor:
    """The dilated residual block as a chain of fused kernel convs."""
    out = x.contiguous()
    for lp, d in zip(layers, plan.cfg.dilation_rates):
        out = dilated_split_conv(out, lp["w"], lp["b"], dilation=d, swap_halves=True)
    return out


def _sub_stage_fused(plan: DeployPlan, sp: Params, gru: torch.nn.GRU, z: torch.Tensor) -> torch.Tensor:
    """Sub-band transformer stage on (B, Fp, d), all BNs pre-folded."""
    B, Fp, d = z.shape
    H = plan.cfg.num_heads
    hd = d // H

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(B, Fp, H, hd).transpose(1, 2).contiguous()

    q = heads(nn.dense(sp["wq"], z))
    k = heads(nn.dense(sp["wk"], z))
    v = heads(nn.dense(sp["wv"], z))
    kv0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=z.device)
    oh, _ = linear_attention_step(q, k, v, kv0)
    oh = oh / Fp  # Eq. 1's constant 1/L normalizer (L = sub-band length)
    att = nn.dense(sp["wo"], oh.transpose(1, 2).reshape(B, Fp, d))
    y = z + att
    g, _ = gru(y)  # BN2 folded into wi/bi
    return y + nn.dense(sp["w_out"], g)


def fused_stream_step(
    plan: DeployPlan, state: Dict[str, torch.Tensor], frame_ri: torch.Tensor
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One spectrogram frame through the folded graph. (B, F, 2) -> mask."""
    cfg = plan.cfg
    dp = plan.params
    B = frame_ri.shape[0]
    x = frame_ri[:, : cfg.freq_bins]  # (B, F, 2), nyquist cropped

    y = nn.relu(_conv_f(plan, "enc_in", x))
    y = _dilated_fused(plan, dp["enc_dilated"], y)
    enc = nn.relu(_conv_f(plan, "enc_down", y, stride=cfg.downsample))  # (B, Fp, C)

    z = _mm(plan, "att_in", enc)  # (B, Fp, d)
    Fp = z.shape[1]
    new_state = dict(state)
    for i, (blk, gru) in enumerate(zip(dp["blocks"], plan.sub_grus)):
        z = _sub_stage_fused(plan, blk["sub"], gru, z)
        zf = z.reshape(B * Fp, cfg.att_dim)
        h0 = state[f"block{i}"].reshape(B * Fp, cfg.gru_hidden)
        h, g = nn.gru_step(blk["full"]["gru_f"], h0, zf)  # BN2 folded into wi/bi
        new_state[f"block{i}"] = h.reshape(B, Fp, cfg.gru_hidden)
        z = (zf + nn.dense(blk["full"]["w_out"], g)).reshape(B, Fp, cfg.att_dim)
    tr = _mm(plan, "att_out", z)  # (B, Fp, C)

    m = nn.relu(_mm(plan, "mask_conv1", tr))
    m = _mm(plan, "mask_conv2", m)
    hfeat = enc * m

    hfeat = _dilated_fused(plan, dp["dec_dilated"], hfeat)
    hfeat = nn.relu(_conv_f(plan, "dec_up", hfeat))
    Bh, Fph, Cr = hfeat.shape
    r = cfg.downsample
    hfeat = hfeat.reshape(Bh, Fph * r, Cr // r)  # sub-pixel upsample along F
    mask = _conv_f(plan, "dec_out", hfeat)  # (B, F, 2)

    F_in = frame_ri.shape[1]
    if F_in > cfg.freq_bins:
        mask = torch.cat([mask, torch.zeros_like(frame_ri[:, cfg.freq_bins :])], dim=1)
    return new_state, mask


def stream_hop_fused(
    plan: DeployPlan, state: StreamState, hop_samples: torch.Tensor
) -> Tuple[StreamState, torch.Tensor]:
    """Push one hop of audio (B, hop) through the deployed graph; emit one hop.

    Pure in ``(state, hop_samples)``: returns a new ``StreamState`` and the
    (B, hop) enhanced audio. Same STFT analysis, activation-quantization
    points and weighted-OLA synthesis as the reference.
    """
    analysis, frame_ri = hop_analysis(state, hop_samples, plan.cfg, plan.quant)
    model_state, mask = fused_stream_step(plan, state.model, frame_ri)
    if plan.quant is not None:
        mask = quantize(mask, plan.quant)
    return hop_synthesis(state, analysis, frame_ri, mask, model_state, plan.cfg)
