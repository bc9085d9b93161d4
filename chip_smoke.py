#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device  - the card's name and power limit (nvidia-smi); TF32 off,
             cuDNN deterministic.
2. build   - nvcc builds every kernel of the deployed hop from
             src/repro_torch/csrc, one compiler per source, in parallel.
3. parity  - each kernel against its plain PyTorch version on the same
             CUDA tensors, at the main path's shapes (capacity 8) and edge
             cases (all-zero frame, zero weight strips, odd L and M,
             non-zero carried state).
4. main    - SessionPool(init_tft(seed 0), tftnn_config(), capacity=8) on
             cuda, fp32 and FP10: 8 sessions, 1 s of 8 kHz audio each in
             uneven chunks, against the same pool on the CPU; launch
             counters exactly 8 / 2 / 4 per pool step; one session's audio
             bit-identical alone and among churning neighbours.
5. times   - CUDA-event medians of each kernel's launches per hop step,
             beside its plain version, one library call where one exists
             and the card's bound; the pool's per-hop p50/p99 at capacity
             8 and 64 against the 16 ms hop budget; a profiler window.

Prints one {"kernels": [...]} line, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Details go to results/chip_smoke.json.
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
OUT_DIR = ROOT / "results"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
HOP_BUDGET_MS = 16.0
TOL = {"dilated_split_conv": 2e-5, "linear_attention_step": 1e-5, "masked_matmul": 1e-5}
REPLACES = {
    "dilated_split_conv": "src/repro/kernels/dilated_conv/kernel.py:60",
    "linear_attention_step": "src/repro/kernels/linear_attention/kernel.py:138",
    "masked_matmul": "src/repro/kernels/masked_mac/kernel.py:47",
}
SOURCE = {
    "dilated_split_conv": "src/repro_torch/csrc/dilated_conv.cu",
    "linear_attention_step": "src/repro_torch/csrc/linear_attention.cu",
    "masked_matmul": "src/repro_torch/csrc/masked_mac.cu",
}
PER_STEP = {"dilated_split_conv": 8, "linear_attention_step": 2, "masked_matmul": 4}


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
    from repro_torch.kernels.linear_attention import linear_attention_step, linear_attention_step_ref
    from repro_torch.kernels.masked_mac import masked_matmul, masked_matmul_ref
    from repro_torch.models import tftnn as tft
    from repro_torch.serve import SessionPool, StreamState, build_deploy_plan, init_stream
    from repro_torch.serve.deploy import fused_stream_step
    from repro_torch.serve.streaming_se import hop_analysis, hop_synthesis

    kernels = {"dilated_split_conv": dilated_split_conv,
               "linear_attention_step": linear_attention_step,
               "masked_matmul": masked_matmul}

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
    torch.cuda.synchronize()
    print(f"[parity] {len(cases)} cases ok; max abs err "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    report["parity"] = cases

    # -- 4. main path ---------------------------------------------------------
    sr = 8000
    rng = np.random.default_rng(0)
    t = np.arange(sr) / sr
    audio = (0.5 * np.sin(2 * np.pi * rng.uniform(150, 400, (8, 1)) * t)
             + 0.3 * rng.standard_normal((8, sr))).astype(np.float32)
    chunk_rng = np.random.default_rng(1)
    chunks = [np.split(a, np.sort(chunk_rng.choice(np.arange(1, sr), 24, replace=False))) for a in audio]

    def serve(device, quant, count_launches=False):
        pool = SessionPool(params, cfg, capacity=8, quant=quant, device=device)
        sessions = [pool.attach() for _ in range(8)]
        outs = [[] for _ in range(8)]
        if count_launches:
            for k in kernels.values():
                k.launches = 0
        for r in range(25):
            for i, s in enumerate(sessions):
                if r < len(chunks[i]):
                    pool.feed(s, chunks[i][r])
            pool.pump()
            for i, s in enumerate(sessions):
                outs[i].append(pool.read(s))
        for i, s in enumerate(sessions):
            outs[i].append(pool.detach(s))
        launches = {n: k.launches for n, k in kernels.items()}
        return np.stack([np.concatenate(o) for o in outs]), len(pool.step_seconds), launches

    main_launches = None
    report["main"] = {}
    for qname, quant in (("fp32", None), ("fp10", FP10)):
        card, steps, launches = serve(dev, quant, count_launches=True)
        if main_launches is None:
            main_launches = launches
        for name, n in launches.items():
            if n != PER_STEP[name] * steps or n == 0:
                fail(f"main path ({qname}): {name} launched {n} times in {steps} steps, "
                     f"expected {PER_STEP[name]} per step")
        if card.shape != (8, (sr // cfg.hop) * cfg.hop) or not np.isfinite(card).all():
            fail(f"main path ({qname}): output shape {card.shape} or non-finite values")
        cpu, _, _ = serve("cpu", quant)
        gap = np.abs(card - cpu)
        close = gap <= 1e-4 + 1e-4 * np.abs(cpu)
        need = 1.0 if quant is None else 0.999
        res = {"steps": steps, "launches": launches, "within_1e-4": float(close.mean()),
               "worst_gap": float(gap.max()), "rule": "all" if quant is None else ">= 99.9 %"}
        far = (~close).reshape(8, -1, cfg.hop).sum(axis=(0, 2))  # samples off, by hop index
        res["off_by_hop"] = {int(h): int(far[h]) for h in np.flatnonzero(far)}
        report["main"][qname] = res
        print(f"[main {qname}] {json.dumps(res)}", flush=True)
        if close.mean() < need:
            fail(f"main path ({qname}): card vs CPU port within 1e-4 on only {close.mean():.5f} of samples")

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

    def churn(neighbours: bool) -> np.ndarray:
        pool = SessionPool(params, cfg, capacity=8, device=dev)
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

    alone, crowded = churn(False), churn(True)
    if alone.size != 20 * cfg.hop or not np.array_equal(alone, crowded):
        fail("churn: a session's audio differs alone vs among churning neighbours")
    print("[main] churn bit-identity ok (20 hops, up to 7 neighbours)", flush=True)

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

    def work(name):
        """(bytes, flops) the kernel's launches in one hop step need on these inputs."""
        nbytes = flops = 0.0
        if name == "dilated_split_conv":
            for x, lp, d in conv_group():
                k, half = lp["w"].shape[0], C // 2
                live = float((x.flatten(1) != 0).any(dim=1).sum())  # frames not skipped
                nbytes += 4 * (2 * x.numel() + lp["w"].numel() + lp["b"].numel())
                flops += 2 * live * x.shape[1] * half * half * k + 3 * x.shape[0] * x.shape[1] * half
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
    }
    rows = []
    for name, (kernel_fn, plain_fn, library_fn) in runs.items():
        # kernel, plain, kernel, plain: take the faster of two rounds each
        k_ms = min(time_ms(kernel_fn), time_ms(kernel_fn))
        p_ms = min(time_ms(plain_fn), time_ms(plain_fn))
        lib_ms = time_ms(library_fn) if library_fn is not None else None
        nbytes, flops = work(name)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": main_launches[name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(nbytes, flops),
            "bound_by": bound_by(nbytes, flops), "library_ms": lib_ms,
            "per": f"one hop step at capacity {B}: {PER_STEP[name]} launches",
        })
    report["kernels"] = rows

    pool_times = {}
    long_audio = np.tile(audio, (8, 1))
    for cap in (8, 64):
        pool = SessionPool(params, cfg, capacity=cap, device=dev)
        sessions = [pool.attach() for _ in range(cap)]
        for i, s in enumerate(sessions):
            pool.feed(s, long_audio[i % len(long_audio)])
        for _ in range(3):  # warm-up steps are not counted
            pool.step()
        pool.step_seconds.clear()
        pool.pump()
        pct = pool.latency_percentiles((50, 99))
        pool_times[cap] = {"steps": len(pool.step_seconds), "p50_ms": pct[50], "p99_ms": pct[99],
                           "budget_ms": HOP_BUDGET_MS}
    print(f"[times] pool per-hop step {json.dumps(pool_times)}", flush=True)
    report["pool"] = pool_times

    # profiler window: device time by kernel over 10 steps at capacity 8
    pool = SessionPool(params, cfg, capacity=8, device=dev)
    sessions = [pool.attach() for _ in range(8)]
    for i, s in enumerate(sessions):
        pool.feed(s, audio[i])
    for _ in range(3):
        pool.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            pool.step()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:12]
    report["profile"] = {
        "steps": 10, "wall_ms_per_step": wall * 1e2,
        "device_ms_per_step": dev_us / 1e4 if dev_us else None,
        "device_busy_share": (dev_us / 1e6) / wall if dev_us else None,
        "top": [{"name": e.key[:80], "calls": e.count, "device_ms": e.device_time_total / 1e3} for e in top],
    }
    for row in rows:  # each kernel's device time per hop step, without host gaps
        mine = [e for e in events if f"{row['name']}_kernel" in e.key]
        row["device_ms"] = sum(e.device_time_total for e in mine) / 1e4 if mine else None
    print(f"[profile] wall {wall * 1e2:.3f} ms/step, device "
          f"{report['profile']['device_ms_per_step']} ms/step", flush=True)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
