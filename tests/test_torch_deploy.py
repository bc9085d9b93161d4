"""The port's deploy path against the reference's, on the CPU.

Both packages get the same parameters (the reference's tree, converted
with ``repro_torch.bridge``) and the same audio (numpy, from a seed). On
the CPU the port's kernel wrappers run their plain versions; the reference
runs its Pallas kernels in interpret mode (``use_pallas=True``) or its
pure-jnp path (``use_pallas=False``).

Tolerances: folded plan leaves 1e-6; hop audio atol = rtol = 1e-4, the
reference's own fused-vs-training-graph tolerance (tests/test_deploy.py:96).
Under FP10 the reference is off the FP10 grid for a few tiny values
(ROADMAP C1), so FP10 is held to the rule stated on each FP10 test, never
to bit-identity.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as j_nn
from repro.audio.stft import hann as j_hann
from repro.core.quant import FP10 as J_FP10
from repro.core.quant import quantize as j_quantize
from repro.models import tftnn as j_tft
from repro.serve import deploy as j_deploy
from repro.serve.streaming_se import init_stream as j_init_stream
from repro.train.checkpoint import Checkpointer
from repro_torch import nn
from repro_torch.audio.stft import hann
from repro_torch.bridge import load_checkpoint, params_from_numpy
from repro_torch.core.quant import FP10, quantize
from repro_torch.models import tftnn as tft
from repro_torch.serve import deploy
from repro_torch.serve.streaming_se import init_stream
from test_deploy import tiny_cfg, trained_params


def port_cfg(jcfg) -> tft.TFTConfig:
    return tft.TFTConfig(**dataclasses.asdict(jcfg))


def to_port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def perturb_bn(jparams, seed):
    """Give every BatchNorm non-trivial statistics, drawn with numpy.

    Stands in for ``trained_params`` at full width, where a few train-mode
    forwards of the reference cost tens of seconds on the CPU.
    """
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and set(node) == {"scale", "bias", "mean", "var"}:
            f = node["scale"].shape
            return {
                "scale": jnp.asarray(rng.uniform(0.8, 1.2, f), jnp.float32),
                "bias": jnp.asarray(rng.normal(0.0, 0.1, f), jnp.float32),
                "mean": jnp.asarray(rng.normal(0.0, 0.1, f), jnp.float32),
                "var": jnp.asarray(rng.uniform(0.5, 1.5, f), jnp.float32),
            }
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(jparams)


def run_both(jcfg, jparams, wave, *, quant, use_pallas):
    """Drive the reference's and the port's ``stream_hop_fused`` hop by hop."""
    B, hops = wave.shape[0], wave.shape[1] // jcfg.hop
    jplan = j_deploy.build_deploy_plan(jparams, jcfg, quant=J_FP10 if quant else None,
                                       use_pallas=use_pallas)
    jstep = jax.jit(lambda s, h: j_deploy.stream_hop_fused(jplan, s, h))
    plan = deploy.build_deploy_plan(to_port(jparams), port_cfg(jcfg),
                                    quant=FP10 if quant else None, device="cpu")
    js = j_init_stream(jparams, jcfg, B)
    ts = init_stream(None, plan.cfg, B, device="cpu")
    jo, to = [], []
    for i in range(hops):
        h = wave[:, i * jcfg.hop : (i + 1) * jcfg.hop]
        js, y = jstep(js, jnp.asarray(h))
        ts, z = deploy.stream_hop_fused(plan, ts, torch.from_numpy(h))
        jo.append(np.asarray(y))
        to.append(z.numpy())
    return np.concatenate(jo, axis=1), np.concatenate(to, axis=1)


def assert_trees_close(port, ref, tol, path="params"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), f"{path}: keys {sorted(port)} vs {sorted(ref)}"
        for k in ref:
            assert_trees_close(port[k], ref[k], tol, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_trees_close(p, r, tol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=tol, err_msg=path)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_cfg()
    wave = (np.random.default_rng(7).standard_normal((2, 8 * jcfg.hop)) * 0.3).astype(np.float32)
    return jcfg, trained_params(jcfg), wave


def test_plan_matches_reference_leaf_by_leaf(tiny):
    jcfg, jparams, _ = tiny
    jplan = j_deploy.build_deploy_plan(jparams, jcfg, use_pallas=False)
    plan = deploy.build_deploy_plan(to_port(jparams), port_cfg(jcfg), device="cpu")
    assert_trees_close(plan.params, jplan.params, 1e-6)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_stream_hop_fused_matches_reference(tiny, use_pallas):
    jcfg, jparams, wave = tiny
    ref, out = run_both(jcfg, jparams, wave[:, : 4 * jcfg.hop], quant=False, use_pallas=use_pallas)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_stream_hop_fused_full_width():
    """The paper's model at full width (F=256, C=32): B=2, 3 hops."""
    jcfg = j_tft.tftnn_config()
    jparams = perturb_bn(j_tft.init_tft(jax.random.PRNGKey(3), jcfg), seed=3)
    wave = (np.random.default_rng(8).standard_normal((2, 3 * jcfg.hop)) * 0.3).astype(np.float32)
    ref, out = run_both(jcfg, jparams, wave, quant=False, use_pallas=True)
    assert out.shape == (2, 3 * jcfg.hop)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _on_grid(values: np.ndarray) -> np.ndarray:
    """True where a value is exactly an FP10 grid point (exact rounding is a no-op)."""
    values = np.array(values, np.float32)
    return quantize(torch.from_numpy(values), FP10).numpy() == values


def test_quantize_matches_reference_off_its_off_grid_values():
    """FP10 rule, part 1: the port rounds exactly onto the grid, and equals
    the reference bit for bit except (a) where the reference's own result
    is off the grid, and (b) at exact ties of half the smallest subnormal
    step (2**-19), which the reference rounds up and round-half-even
    rounds to 0."""
    rng = np.random.default_rng(11)
    probes = np.concatenate([
        rng.standard_normal(200_000) * 10.0 ** rng.integers(-7, 5, 200_000),
        np.ldexp(1.0, np.arange(-24, 17)),  # exact powers of two
        [0.0, -0.0, 2.0**-19, -(2.0**-19), 3 * 2.0**-19, 1e6, -1e6],
    ]).astype(np.float32)
    ours = quantize(torch.from_numpy(probes), FP10).numpy()
    ref = np.asarray(j_quantize(jnp.asarray(probes), J_FP10))
    assert _on_grid(ours).all()
    listed = ~_on_grid(ref) | (np.abs(probes) == 2.0**-19)
    differ = ours != ref
    assert not (differ & ~listed).any(), probes[differ & ~listed][:10]
    worst = float(np.max(np.abs(ours - ref)))
    print(f"FP10 quantize: {int(differ.sum())} of {probes.size} differ, worst gap {worst:.3g}")
    assert worst <= 2.0**-18  # at most one smallest-subnormal step


def test_fp10_hop_matches_reference(tiny):
    """FP10 rule, part 2: the FP10 hop agrees to atol = rtol = 1e-4 on at
    least 99.9 % of samples; the worst gap is printed. (Flipping one
    activation across an FP10 rounding boundary may move a sample by more.)"""
    jcfg, jparams, wave = tiny
    ref, out = run_both(jcfg, jparams, wave, quant=True, use_pallas=False)
    assert np.isfinite(out).all()
    close = np.abs(out - ref) <= 1e-4 + 1e-4 * np.abs(ref)
    worst = float(np.max(np.abs(out - ref)))
    print(f"FP10 hop: {close.mean():.5f} of {close.size} samples within 1e-4, worst gap {worst:.3g}")
    assert close.mean() >= 0.999


def test_frame_conv_stride2_matches_reference():
    """``enc_down``: stride 2 with padding (2, 2) over F=256 gives the same 128
    outputs through ``F.conv1d`` as the reference's WIO convolution."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 256, 32)).astype(np.float32)
    w = (rng.standard_normal((5, 1, 32, 32)) * 0.1).astype(np.float32)
    b = rng.standard_normal((32,)).astype(np.float32)
    wt = torch.from_numpy(w)[:, 0].permute(2, 1, 0).contiguous()
    plan = types.SimpleNamespace(conv_w={"enc_down": wt}, params={"enc_down": {"b": torch.from_numpy(b)}})
    out = deploy._conv_f(plan, "enc_down", torch.from_numpy(x), stride=2).numpy()
    ref = np.asarray(j_deploy._conv_f({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride=2))
    assert out.shape == ref.shape == (2, 128, 32)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_bigru_module_matches_plain_loop_and_reference():
    rng = np.random.default_rng(6)
    p_f, p_b = ({k: rng.uniform(-0.3, 0.3, s).astype(np.float32)
                 for k, s in (("wi", (16, 96)), ("wh", (32, 96)), ("bi", (96,)), ("bh", (96,)))}
                for _ in range(2))
    x = rng.standard_normal((3, 128, 16)).astype(np.float32)
    tp_f, tp_b = params_from_numpy(p_f), params_from_numpy(p_b)
    loop = nn.bigru(tp_f, tp_b, torch.from_numpy(x))
    module, _ = nn.bigru_module(tp_f, tp_b)(torch.from_numpy(x))
    ref = np.asarray(j_nn.bigru(jax.tree_util.tree_map(jnp.asarray, p_f),
                                jax.tree_util.tree_map(jnp.asarray, p_b), jnp.asarray(x)))
    np.testing.assert_allclose(loop.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(module.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_hann_matches_reference():
    np.testing.assert_allclose(hann(512).numpy(), np.asarray(j_hann(512)), atol=1e-7)


def test_load_checkpoint_reads_reference_checkpointer(tmp_path):
    jcfg = tiny_cfg()
    jparams = j_tft.init_tft(jax.random.PRNGKey(2), jcfg)
    Checkpointer(str(tmp_path), async_save=False).save(5, {"params": jparams})
    loaded = load_checkpoint(str(tmp_path))["params"]
    direct = to_port(jparams)
    flat_l, flat_d = [], []
    for tree, flat in ((loaded, flat_l), (direct, flat_d)):
        stack = [("", tree)]
        while stack:
            path, node = stack.pop()
            if isinstance(node, dict):
                stack.extend((f"{path}/{k}", v) for k, v in node.items())
            elif isinstance(node, list):
                stack.extend((f"{path}/{i}", v) for i, v in enumerate(node))
            else:
                flat.append((path, node))
    assert dict(flat_l).keys() == dict(flat_d).keys()
    for path, t in flat_l:
        torch.testing.assert_close(t, dict(flat_d)[path], atol=0.0, rtol=0.0)
    plan = deploy.build_deploy_plan(loaded, port_cfg(jcfg), device="cpu")
    assert plan.params["enc_dilated"][0]["w"].shape == (5, 4, 4)


def test_init_tft_has_reference_layout():
    cfg = tft.tftnn_config()
    params = tft.init_tft(torch.Generator().manual_seed(0), cfg)
    jparams = jax.eval_shape(lambda: j_tft.init_tft(jax.random.PRNGKey(0), j_tft.tftnn_config()))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    assert tft.param_count(params) == 65_362


def test_validate_rejects_nondeployable():
    with pytest.raises(ValueError, match="not deploy-compilable"):
        deploy.validate_deployable(tft.tstnn_config())
    with pytest.raises(NotImplementedError, match="TFTNN corner"):
        tft.init_tft(torch.Generator().manual_seed(0), tft.tstnn_config())


@pytest.mark.parametrize("knob", ["prune_keep", "prune_axis", "prune_granularity"])
def test_pruning_is_not_ported(knob):
    cfg = port_cfg(tiny_cfg())
    params = tft.init_tft(torch.Generator().manual_seed(0), cfg)
    value = {"prune_keep": 0.5, "prune_axis": 1, "prune_granularity": "unit"}[knob]
    with pytest.raises(NotImplementedError, match=knob):
        deploy.build_deploy_plan(params, cfg, device="cpu", **{knob: value})
