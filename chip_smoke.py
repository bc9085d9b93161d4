#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device  - the card's name and power limit (nvidia-smi); TF32 off,
             cuDNN deterministic.
2. build   - nvcc builds every kernel from src/repro_torch/csrc, one
             compiler per source, in parallel.
3. parity  - each kernel against its plain PyTorch version on the same
             CUDA tensors, at the paths' shapes (capacity 8) and edge cases
             (all-zero frame, zero weight strips, odd L and M, non-zero
             carried state, L = 1; for FP10 2**20 values weighted toward
             tiny magnitudes, the subnormal grid and its ties, +-0, +-inf,
             NaN and values past saturation, equal value for value).
4. main    - SessionPool(init_tft(seed 0), tftnn_config(), capacity=8) on
             cuda, on both hops (backend "pallas": the deploy graph;
             backend "xla": the training graph), fp32 and FP10: 8 sessions,
             1 s of 8 kHz audio each in uneven chunks, against the same pool
             on the CPU; launch counters exactly per pool step (pallas:
             dilated conv 8, attention step 2, masked MAC 4; xla: non-causal
             attention 2; FP10 2 under FP10 on both); one session's audio
             bit-identical alone and among churning neighbours on both;
             enhance_streaming == enhance_offline on the card (8 x 1 s) and
             each against the CPU port.
5. times   - CUDA-event medians of each kernel's launches per hop step,
             beside its plain version, one library call where one exists
             and the card's bound; each pool's per-hop p50/p99 at capacity
             8 and 64 against the 16 ms hop budget; enhance_offline and
             enhance_streaming seconds per second of audio; a profiler
             window on each pool.

Prints one {"kernels": [...]} line, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
HOP_BUDGET_MS = 16.0
TOL = {"dilated_split_conv": 2e-5, "linear_attention_step": 1e-5, "masked_matmul": 1e-5,
       "fp10_quantize": 0.0, "linear_attention": 1e-5}
REPLACES = {
    "dilated_split_conv": "src/repro/kernels/dilated_conv/kernel.py:60",
    "linear_attention_step": "src/repro/kernels/linear_attention/kernel.py:138",
    "masked_matmul": "src/repro/kernels/masked_mac/kernel.py:47",
    "fp10_quantize": "src/repro/kernels/fp10/kernel.py:39",
    "linear_attention": "src/repro/kernels/linear_attention/kernel.py:179",
}
SOURCE = {
    "dilated_split_conv": "src/repro_torch/csrc/dilated_conv.cu",
    "linear_attention_step": "src/repro_torch/csrc/linear_attention.cu",
    "masked_matmul": "src/repro_torch/csrc/masked_mac.cu",
    "fp10_quantize": "src/repro_torch/csrc/fp10_quantize.cu",
    "linear_attention": "src/repro_torch/csrc/linear_attention.cu",
}
# the path each kernel serves, whose run gives its "launches" in the kernels line
PATH_OF = {"dilated_split_conv": "pallas_fp32", "linear_attention_step": "pallas_fp32",
           "masked_matmul": "pallas_fp32", "fp10_quantize": "xla_fp10", "linear_attention": "xla_fp10"}
FP10_MAX = (2.0 - 2.0**-4) * 2.0**15  # 63488, the largest s1/e5/m4 value


def per_step(backend: str, fp10: bool) -> dict:
    """Launches of each kernel in one pool step of the given hop."""
    deploy = backend == "pallas"
    return {"dilated_split_conv": 8 * deploy, "linear_attention_step": 2 * deploy,
            "masked_matmul": 4 * deploy, "fp10_quantize": 2 * fp10,
            "linear_attention": 2 * (not deploy)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 60, warmup: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3


def bound_by(nbytes: float, flops: float) -> str:
    return "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_FP32_FLOPS else "operations"


def main() -> int:
    report: dict = {}
    try:
        return run(report)
    finally:
        if report:  # what was measured, also when a phase failed
            OUT_DIR.mkdir(exist_ok=True)
            (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))


def run(report: dict) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.quant import FP10, quantize
    from repro_torch.kernels import _build
    from repro_torch.kernels.dilated_conv import dilated_split_conv, dilated_split_conv_ref
    from repro_torch.kernels.fp10 import fp10_quantize, fp10_quantize_ref
    from repro_torch.kernels.linear_attention import (
        linear_attention,
        linear_attention_ref,
        linear_attention_step,
        linear_attention_step_ref,
    )
    from repro_torch.kernels.masked_mac import masked_matmul, masked_matmul_ref
    from repro_torch.models import tftnn as tft
    from repro_torch.serve import SessionPool, StreamState, build_deploy_plan, init_stream
    from repro_torch.serve.deploy import fused_stream_step
    from repro_torch.serve.streaming_se import (
        enhance_offline,
        enhance_streaming,
        hop_analysis,
        hop_synthesis,
    )

    kernels = {"dilated_split_conv": dilated_split_conv,
               "linear_attention_step": linear_attention_step,
               "masked_matmul": masked_matmul,
               "fp10_quantize": fp10_quantize,
               "linear_attention": linear_attention}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    # -- 1. device ----------------------------------------------------------
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    report["device"] = {"nvidia_smi": smi, "kind": kind, "torch": torch.__version__}

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in build_s.items()})} "
          f"total {time.perf_counter() - t0:.2f}s", flush=True)
    report["build_seconds"] = build_s

    # -- 3. kernel parity on the card ----------------------------------------
    cfg = tft.tftnn_config()
    params = tft.init_tft(torch.Generator().manual_seed(0), cfg)
    plan = build_deploy_plan(params, cfg, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    B, C, Fr, Fp, H, hd = 8, cfg.channels, cfg.freq_bins, cfg.att_len, cfg.num_heads, cfg.att_dim // cfg.num_heads
    errs = {name: 0.0 for name in kernels}
    cases = []

    def check(name, case, got, want, scale=1.0):
        err = float((got - want).abs().max()) / scale if got.numel() else 0.0
        tol = TOL[name]
        ok = torch.allclose(got / scale, want / scale, atol=tol, rtol=tol)
        cases.append({"kernel": name, "case": case, "max_abs_err": err, "ok": bool(ok)})
        errs[name] = max(errs[name], err)
        if not ok:
            fail(f"{name} [{case}] disagrees with its plain version: max abs err {err:.3g} > {tol}")

    layers = [(plan.params["enc_dilated"], Fr), (plan.params["dec_dilated"], Fp)]
    for lps, F_ in layers:
        for lp, d in zip(lps, cfg.dilation_rates):
            x = rand(B, F_, C)
            x[3] = 0.0  # an all-zero frame: the zero-skip short cut
            for swap in (True, False):
                got = dilated_split_conv(x, lp["w"], lp["b"], dilation=d, swap_halves=swap)
                want = dilated_split_conv_ref(x, lp["w"], lp["b"], dilation=d, swap_halves=swap)
                check("dilated_split_conv", f"F={F_} d={d} swap={swap} zero-frame", got, want)
    x = rand(3, 37, 16)  # odd F, narrow C
    w, b = rand(5, 8, 8, scale=0.2), rand(8, scale=0.1)
    check("dilated_split_conv", "F=37 C=16 d=4", dilated_split_conv(x, w, b, dilation=4),
          dilated_split_conv_ref(x, w, b, dilation=4))

    for L, kv_scale, case in ((Fp, 0.0, "main (8,2,128,8) kv=0"), (Fp, 1.0, "kv!=0"), (37, 1.0, "odd L=37 kv!=0")):
        q, k, v = (rand(B, H, L, hd) for _ in range(3))
        kv = rand(B, H, hd, hd, scale=kv_scale)
        got, got_kv = linear_attention_step(q, k, v, kv)
        want, want_kv = linear_attention_step_ref(q, k, v, kv)
        check("linear_attention_step", case + " out/L", got, want, scale=L)
        check("linear_attention_step", case + " new_kv", got_kv, want_kv)

    for name in ("att_in", "att_out", "mask_conv1", "mask_conv2"):
        p = plan.params[name]
        x = rand(B * Fp, p["w"].shape[0])
        check("masked_matmul", f"{name} M={B * Fp}", masked_matmul(x, p["w"], p["b"]),
              masked_matmul_ref(x, p["w"], p["b"]))
    w = rand(20, 12)
    w[8:16] = 0.0  # a zero strip, skipped
    x, b = rand(1001, 20), rand(12)
    check("masked_matmul", "M=1001 K=20 zero strip", masked_matmul(x, w, b), masked_matmul_ref(x, w, b))

    # FP10: equal to the plain version value for value, NaN where NaN
    prng = np.random.default_rng(2)
    subgrid = np.arange(0, 64) * 2.0**-18  # the subnormal grid and the binades above it
    probes = np.concatenate([
        prng.standard_normal(2**20) * 10.0 ** prng.integers(-9, 6, 2**20),
        subgrid, subgrid + 2.0**-19, -(subgrid + 2.0**-19), np.ldexp(1.0, np.arange(-26, 17)),
        [0.0, -0.0, 2.0**-19, -(2.0**-19), np.inf, -np.inf, np.nan, FP10_MAX, 64000.0,
         65520.0, 1e6, -1e6, 3e38],
    ]).astype(np.float32)
    fp10_cases = [("probes", torch.from_numpy(probes).to(dev)),
                  ("frame (8, 257, 2)", rand(B, Fr + 1, 2, scale=40.0)),
                  ("mask (8, 257, 2)", rand(B, Fr + 1, 2))]
    for case, x in fp10_cases:
        got, want = fp10_quantize(x), fp10_quantize_ref(x)
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        same = bool(torch.equal(nan_g, nan_w)) and bool(torch.equal(got[~nan_g], want[~nan_w]))
        err = float((got[~nan_g] - want[~nan_w]).abs().max()) if same else float("inf")
        cases.append({"kernel": "fp10_quantize", "case": case, "max_abs_err": err, "ok": same,
                      "values": x.numel(), "nan": int(nan_g.sum())})
        if not same:
            fail(f"fp10_quantize [{case}] differs from its plain version")
    special = torch.tensor([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e6, 2.0**-19], device=dev)
    got = fp10_quantize(special).cpu().numpy()
    if not (np.isnan(got[0]) and list(got[1:]) == [FP10_MAX, -FP10_MAX, 0.0, 0.0, FP10_MAX, 0.0]):
        fail(f"fp10_quantize special values: {got.tolist()}")

    for case, shape in (("hop (8, 2, 128, 8)", (B, H, Fp, hd)),
                        ("offline (8*62, 2, 128, 8)", (B * 62, H, Fp, hd)),
                        ("odd L=37", (3, H, 37, hd)), ("L=1", (3, H, 1, hd))):
        q, k, v = (rand(*shape) for _ in range(3))
        check("linear_attention", case, linear_attention(q, k, v), linear_attention_ref(q, k, v))
    torch.cuda.synchronize()
    print(f"[parity] {len(cases)} cases ok; max abs err "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
          f"FP10 equal on {probes.size} probe values (NaN stays NaN)", flush=True)
    report["parity"] = cases

    # -- 4. main path ---------------------------------------------------------
    sr = 8000
    rng = np.random.default_rng(0)
    t = np.arange(sr) / sr
    audio = (0.5 * np.sin(2 * np.pi * rng.uniform(150, 400, (8, 1)) * t)
             + 0.3 * rng.standard_normal((8, sr))).astype(np.float32)
    chunk_rng = np.random.default_rng(1)
    chunks = [np.split(a, np.sort(chunk_rng.choice(np.arange(1, sr), 24, replace=False))) for a in audio]

    def serve(device, quant, backend):
        pool = SessionPool(params, cfg, capacity=8, quant=quant, backend=backend, device=device)
        sessions = [pool.attach() for _ in range(8)]
        outs = [[] for _ in range(8)]
        reset_counts()  # weight rounding at construction is not a pool step
        for r in range(25):
            for i, s in enumerate(sessions):
                if r < len(chunks[i]):
                    pool.feed(s, chunks[i][r])
            pool.pump()
            for i, s in enumerate(sessions):
                outs[i].append(pool.read(s))
        for i, s in enumerate(sessions):
            outs[i].append(pool.detach(s))
        return np.stack([np.concatenate(o) for o in outs]), len(pool.step_seconds), counts()

    def held_to_cpu(card, cpu):
        gap = np.abs(card - cpu)
        close = gap <= 1e-4 + 1e-4 * np.abs(cpu)
        far = (~close).reshape(card.shape[0], -1, cfg.hop).sum(axis=(0, 2))  # samples off, by hop
        return close, {"within_1e-4": float(close.mean()), "worst_gap": float(gap.max()),
                       "off_by_hop": {int(h): int(far[h]) for h in np.flatnonzero(far)}}

    main_launches = {}
    report["main"] = {}
    for backend in ("pallas", "xla"):
        for qname, quant in (("fp32", None), ("fp10", FP10)):
            path = f"{backend}_{qname}"
            card, steps, launches = serve(dev, quant, backend)
            main_launches[path] = launches
            want = per_step(backend, quant is not None)
            for name, n in launches.items():
                if n != want[name] * steps or (want[name] and n == 0):
                    fail(f"main path ({path}): {name} launched {n} times in {steps} steps, "
                         f"expected {want[name]} per step")
            if card.shape != (8, (sr // cfg.hop) * cfg.hop) or not np.isfinite(card).all():
                fail(f"main path ({path}): output shape {card.shape} or non-finite values")
            close, res = held_to_cpu(card, serve("cpu", quant, backend)[0])
            need = 1.0 if quant is None else 0.999
            res = {"steps": steps, "launches": launches, **res,
                   "rule": "all" if quant is None else ">= 99.9 %"}
            report["main"][path] = res
            print(f"[main {path}] {json.dumps(res)}", flush=True)
            if close.mean() < need:
                fail(f"main path ({path}): card vs CPU port within 1e-4 on only "
                     f"{close.mean():.5f} of samples")

    # report only: FP10 values that round to different grid points on the card
    # and on the CPU, hop by hop from the same (CPU) state
    plans = {d: build_deploy_plan(params, cfg, quant=FP10, device=d) for d in ("cpu", "cuda")}
    state = init_stream(None, cfg, 8, device="cpu")
    flips = {"frame_values": 0, "mask_values": 0, "values_per_kind": 0}
    with torch.no_grad():
        for h in range(sr // cfg.hop):
            hop = torch.from_numpy(audio[:, h * cfg.hop : (h + 1) * cfg.hop])
            got = {}
            for d, p in plans.items():
                s = StreamState(*(t.to(d) for t in (state.analysis, state.synthesis, state.wsum)),
                                {k: v.to(d) for k, v in state.model.items()})
                an, fr = hop_analysis(s, hop.to(d), cfg, FP10)
                ms, mask = fused_stream_step(p, s.model, fr)
                got[d] = (s, an, fr, ms, quantize(mask, FP10))
            (s, an, fr, ms, mq), (_, _, fr_g, _, mq_g) = got["cpu"], got["cuda"]
            flips["frame_values"] += int((fr != fr_g.cpu()).sum())
            flips["mask_values"] += int((mq != mq_g.cpu()).sum())
            flips["values_per_kind"] += fr.numel()
            state = hop_synthesis(s, an, fr, mq, ms, cfg)[0]
    report["main"]["fp10_flips"] = flips
    print(f"[main fp10] grid flips card vs CPU over {sr // cfg.hop} hops x 8 sessions: "
          f"{json.dumps(flips)}", flush=True)

    def churn(neighbours: bool, backend: str) -> np.ndarray:
        pool = SessionPool(params, cfg, capacity=8, backend=backend, device=dev)
        others = [pool.attach() for _ in range(6)] if neighbours else []
        me = pool.attach()
        out = []
        for step in range(20):
            if neighbours and step % 4 == 1:
                others.append(pool.attach())
            if neighbours and step % 4 == 3:
                pool.detach(others.pop(0))
            for j, o in enumerate(others):
                pool.feed(o, audio[(j + step) % 8][: cfg.hop + 13 * step])
            pool.feed(me, audio[0][step * cfg.hop : (step + 1) * cfg.hop])
            pool.pump()
            out.append(pool.read(me))
        return np.concatenate(out)

    for backend in ("pallas", "xla"):
        alone, crowded = churn(False, backend), churn(True, backend)
        if alone.size != 20 * cfg.hop or not np.array_equal(alone, crowded):
            fail(f"churn ({backend}): a session's audio differs alone vs among churning neighbours")
        print(f"[main] churn bit-identity ok on {backend} (20 hops, up to 7 neighbours)", flush=True)

    # the utterance drivers: streaming == offline on the card, each vs the CPU port
    amp = float(audio.std())
    reset_counts()
    ys = enhance_streaming(params, cfg, audio, device=dev).cpu().numpy()
    launches_s = counts()
    reset_counts()
    yo = enhance_offline(params, cfg, audio, device=dev).cpu().numpy()
    launches_o = counts()
    n_hops = sr // cfg.hop
    if launches_s != {**per_step("xla", False), "linear_attention": 2 * n_hops} or \
            launches_o != {**per_step("xla", False), "linear_attention": 2}:
        fail(f"enhance: launches streaming {launches_s}, offline {launches_o}")
    if ys.shape != (8, n_hops * cfg.hop) or yo.shape != ys.shape or not np.isfinite(ys).all():
        fail(f"enhance: shapes {ys.shape} {yo.shape} or non-finite values")
    invariant = np.abs(ys / amp - yo / amp) <= 1e-5 + 1e-4 * np.abs(yo / amp)
    enh = {"shape": list(ys.shape), "amp": amp, "streaming_vs_offline_ok": float(invariant.mean()),
           "worst_gap_over_amp": float(np.abs(ys - yo).max() / amp),
           "launches_streaming": launches_s, "launches_offline": launches_o}
    for name, card, fn in (("streaming", ys, enhance_streaming), ("offline", yo, enhance_offline)):
        close, res = held_to_cpu(card, fn(params, cfg, audio, device="cpu").numpy())
        enh[f"{name}_vs_cpu"] = res
        if close.mean() < 1.0:
            fail(f"enhance_{name}: card vs CPU port within 1e-4 on only {close.mean():.5f} of samples")
    report["main"]["enhance"] = enh
    print(f"[main] enhance on the card: {json.dumps(enh)}", flush=True)
    if invariant.mean() < 1.0:
        fail("enhance: streaming != offline on the card (atol 1e-5, rtol 1e-4 on audio / amplitude)")

    # -- 5. times -------------------------------------------------------------
    def conv_group():
        for (lps, F_), x in zip(layers, conv_inputs):
            for lp, d in zip(lps, cfg.dilation_rates):
                yield x, lp, d

    conv_inputs = [rand(B, Fr, C), rand(B, Fp, C)]
    la_inputs = [tuple(rand(B, H, Fp, hd) for _ in range(3)) + (torch.zeros(B, H, hd, hd, device=dev),)
                 for _ in range(cfg.num_transformer_blocks)]
    mm_inputs = [(rand(B * Fp, plan.params[n]["w"].shape[0]), plan.params[n])
                 for n in ("att_in", "att_out", "mask_conv1", "mask_conv2")]
    fp10_inputs = [rand(B, Fr + 1, 2, scale=40.0), rand(B, Fr + 1, 2)]  # frame, mask
    nc_inputs = [tuple(rand(B, H, Fp, hd) for _ in range(3)) for _ in range(cfg.num_transformer_blocks)]
    nc_offline = tuple(rand(B * (sr // cfg.hop), H, Fp, hd) for _ in range(3))

    def attention_work(groups):
        nbytes = flops = 0.0
        for q, _, _ in groups:
            bh, L, D = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
            nbytes += 4 * 4 * q.numel()  # q, k, v read, out written
            flops += 4 * bh * L * D * D + bh * L * D
        return nbytes, flops

    def two_calls(groups):
        """The same function as two PyTorch calls: bmm(q, bmm(k^T, v)) / L."""
        out = []
        for q, k, v in groups:
            bh, L, D = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
            q3, k3, v3 = (t.reshape(bh, L, D) for t in (q, k, v))
            out.append(torch.bmm(q3, torch.bmm(k3.mT, v3)) / L)
        return out

    def work(name):
        """(bytes, flops) the kernel's launches in one hop step need on these inputs."""
        nbytes = flops = 0.0
        if name == "dilated_split_conv":
            for x, lp, d in conv_group():
                k, half = lp["w"].shape[0], C // 2
                live = float((x.flatten(1) != 0).any(dim=1).sum())  # frames not skipped
                nbytes += 4 * (2 * x.numel() + lp["w"].numel() + lp["b"].numel())
                flops += 2 * live * x.shape[1] * half * half * k + 3 * x.shape[0] * x.shape[1] * half
        elif name == "fp10_quantize":
            for x in fp10_inputs:  # divide, round, multiply, 2 compares, sign per value
                nbytes += 8 * x.numel()
                flops += 6 * x.numel()
        elif name == "linear_attention":
            nbytes, flops = attention_work(nc_inputs)
        elif name == "linear_attention_step":
            for q, k, v, kv in la_inputs:
                bh, L, D = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
                nbytes += 4 * (4 * q.numel() + 2 * kv.numel())
                flops += 4 * bh * L * D * D + bh * D * D
        else:
            for x, p in mm_inputs:
                K, N = p["w"].shape
                live_rows = sum(min(K, s + 8) - s for s in range(0, K, 8) if bool((p["w"][s : s + 8] != 0).any()))
                nbytes += 4 * (x.numel() + p["w"].numel() + N + x.shape[0] * N)
                flops += 2 * x.shape[0] * N * live_rows + x.shape[0] * N
        return nbytes, flops

    runs = {
        "dilated_split_conv": (
            lambda: [dilated_split_conv(x, lp["w"], lp["b"], dilation=d, swap_halves=True) for x, lp, d in conv_group()],
            lambda: [dilated_split_conv_ref(x, lp["w"], lp["b"], dilation=d, swap_halves=True) for x, lp, d in conv_group()],
            None,
        ),
        "linear_attention_step": (
            lambda: [linear_attention_step(*a) for a in la_inputs],
            lambda: [linear_attention_step_ref(*a) for a in la_inputs],
            None,
        ),
        "masked_matmul": (
            lambda: [masked_matmul(x, p["w"], p["b"]) for x, p in mm_inputs],
            lambda: [masked_matmul_ref(x, p["w"], p["b"]) for x, p in mm_inputs],
            lambda: [torch.addmm(p["b"], x, p["w"]) for x, p in mm_inputs],
        ),
        # no single PyTorch call rounds onto a minifloat grid
        "fp10_quantize": (
            lambda: [fp10_quantize(x) for x in fp10_inputs],
            lambda: [fp10_quantize_ref(x) for x in fp10_inputs],
            None,
        ),
        # no single PyTorch call computes Q @ (K^T V) / L; two bmm calls below
        "linear_attention": (
            lambda: [linear_attention(*a) for a in nc_inputs],
            lambda: [linear_attention_ref(*a) for a in nc_inputs],
            None,
        ),
    }

    def kernel_plain_ms(kernel_fn, plain_fn):
        """kernel, plain, kernel, plain: the faster of two rounds each."""
        k1, p1, k2, p2 = (time_ms(f) for f in (kernel_fn, plain_fn, kernel_fn, plain_fn))
        return min(k1, k2), min(p1, p2)

    rows = []
    for name, (kernel_fn, plain_fn, library_fn) in runs.items():
        k_ms, p_ms = kernel_plain_ms(kernel_fn, plain_fn)
        lib_ms = time_ms(library_fn) if library_fn is not None else None
        nbytes, flops = work(name)
        path = PATH_OF[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": main_launches[path][name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(nbytes, flops),
            "bound_by": bound_by(nbytes, flops), "library_ms": lib_ms,
            "per": f"one hop step at capacity {B} ({path}): "
                   f"{per_step(path.split('_')[0], path.endswith('fp10'))[name]} launches",
        })
    la_row = rows[-1]
    la_row["two_call_ms"] = time_ms(lambda: two_calls(nc_inputs))
    k_ms, p_ms = kernel_plain_ms(lambda: linear_attention(*nc_offline),
                                 lambda: linear_attention_ref(*nc_offline))
    nbytes, flops = attention_work([nc_offline])
    la_row["offline"] = {
        "per": f"one block of enhance_offline over {B} x 1 s: 1 launch of {tuple(nc_offline[0].shape)}",
        "ms": k_ms, "plain_ms": p_ms, "two_call_ms": time_ms(lambda: two_calls([nc_offline])),
        "bound_ms": bound_ms(nbytes, flops), "bound_by": bound_by(nbytes, flops),
    }
    report["kernels"] = rows

    pool_times = {}
    long_audio = np.tile(audio, (8, 1))
    for backend in ("pallas", "xla"):
        for cap in (8, 64):
            pool = SessionPool(params, cfg, capacity=cap, backend=backend, device=dev)
            sessions = [pool.attach() for _ in range(cap)]
            for i, s in enumerate(sessions):
                pool.feed(s, long_audio[i % len(long_audio)])
            for _ in range(3):  # warm-up steps are not counted
                pool.step()
            pool.step_seconds.clear()
            pool.pump()
            pct = pool.latency_percentiles((50, 99))
            pool_times[f"{backend}_{cap}"] = {"steps": len(pool.step_seconds), "p50_ms": pct[50],
                                              "p99_ms": pct[99], "budget_ms": HOP_BUDGET_MS}
    print(f"[times] pool per-hop step {json.dumps(pool_times)}", flush=True)
    report["pool"] = pool_times

    enh_times = {}
    for name, fn in (("offline", enhance_offline), ("streaming", enhance_streaming)):
        fn(params, cfg, audio, device=dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, cfg, audio, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        enh_times[name] = {"seconds": wall, "audio_seconds": audio.size / sr,
                           "seconds_per_audio_second": wall / (audio.size / sr)}
    print(f"[times] enhance 8 x 1 s {json.dumps(enh_times)}", flush=True)
    report["enhance_times"] = enh_times

    # profiler windows: device time by kernel over 10 steps at capacity 8
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    report["profile"] = {}
    for path, backend, quant in (("pallas_fp32", "pallas", None), ("xla_fp10", "xla", FP10)):
        pool = SessionPool(params, cfg, capacity=8, quant=quant, backend=backend, device=dev)
        sessions = [pool.attach() for _ in range(8)]
        for i, s in enumerate(sessions):
            pool.feed(s, audio[i])
        for _ in range(3):
            pool.step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                pool.step()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.device_time_total)[:12]
        report["profile"][path] = {
            "steps": 10, "wall_ms_per_step": wall * 1e2,
            "device_ms_per_step": dev_us / 1e4 if dev_us else None,
            "device_busy_share": (dev_us / 1e6) / wall if dev_us else None,
            "device_launches_per_step": sum(e.count for e in events) / 10,
            "top": [{"name": e.key[:80], "calls": e.count, "device_ms": e.device_time_total / 1e3}
                    for e in top],
        }
        for row in rows:  # each kernel's device time per hop step, without host gaps
            mine = [e for e in events if f"{row['name']}_kernel" in e.key]
            if PATH_OF[row["name"]] == path:
                row["device_ms"] = sum(e.device_time_total for e in mine) / 1e4 if mine else None
        print(f"[profile {path}] wall {wall * 1e2:.3f} ms/step, device "
              f"{report['profile'][path]['device_ms_per_step']} ms/step", flush=True)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
