"""The port's training-graph ("xla") path against the reference's, on the CPU.

Both packages get the same parameters (the reference's tree, converted with
``repro_torch.bridge``, with non-trivial BatchNorm statistics) and the same
inputs (numpy, from fixed seeds). On the CPU the port's kernel wrappers run
their plain versions (FP10 rounding, non-causal linear attention); the
reference runs plain jnp, as its ``"xla"`` backend does.

Tolerances: attention and a transformer block 1e-5 (the reference's linear
attention tolerance, tests/test_kernels.py); the model's mask and hop audio
atol = rtol = 1e-4 (tests/test_deploy.py:96); utterances through
``enhance_streaming``/``enhance_offline`` atol 1e-5, rtol 1e-4 on
amplitude-normalized audio (tests/test_streaming_se.py:64-65). Under FP10
the reference is off the FP10 grid for a few tiny values (ROADMAP C1/C4),
so FP10 audio is held to at least 99.9 % of samples within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bn as j_bn
from repro.core import bn_transformer as j_bnt
from repro.core.quant import FP10 as J_FP10
from repro.core.softmax_free_attention import softmax_free_attention as j_sfa
from repro.models import tftnn as j_tft
from repro.serve import SessionPool as JSessionPool
from repro.serve import streaming_se as j_se
from repro_torch.core import bn, bn_transformer
from repro_torch.core.quant import FP10
from repro_torch.core.softmax_free_attention import softmax_free_attention
from repro_torch.kernels import KERNELS
from repro_torch.models import tftnn as tft
from repro_torch.serve import SessionPool
from repro_torch.serve import streaming_se as se
from test_deploy import tiny_cfg
from test_torch_deploy import perturb_bn, port_cfg, to_port
from test_torch_session_pool import drive


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# the reference's functions, jitted once per config (eager JAX dispatches op by op)
_j_init = jax.jit(j_tft.init_tft, static_argnums=1)
_j_apply_tft = jax.jit(lambda p, x, cfg: j_tft.apply_tft(p, x, cfg)[0], static_argnums=2)
_j_stream_step = jax.jit(j_tft.stream_step, static_argnums=3)
_j_enhance_streaming = jax.jit(j_se.enhance_streaming, static_argnums=1)
_j_enhance_offline = jax.jit(j_se.enhance_offline, static_argnums=1)


def _close_share(out, ref, tol=1e-4):
    return float((np.abs(out - ref) <= tol + tol * np.abs(ref)).mean())


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_cfg()
    jparams = perturb_bn(_j_init(jax.random.PRNGKey(1), jcfg), seed=1)
    return jcfg, jparams, port_cfg(jcfg), to_port(jparams)


def _bn_params(rng, f):
    return {"scale": rng.uniform(0.8, 1.2, f), "bias": rng.normal(0, 0.1, f),
            "mean": rng.normal(0, 0.1, f), "var": rng.uniform(0.5, 1.5, f)}


def test_batchnorm_apply_matches_reference():
    rng = np.random.default_rng(0)
    p = {k: v.astype(np.float32) for k, v in _bn_params(rng, 6).items()}
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    y, same = bn.BatchNorm(6).apply({k: _t(v) for k, v in p.items()}, _t(x))
    ref, _ = j_bn.BatchNorm(6).apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    assert same["var"] is not None
    with pytest.raises(NotImplementedError, match="train"):
        bn.BatchNorm(6).apply({k: _t(v) for k, v in p.items()}, _t(x), train=True)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("L", [128, 37])
def test_softmax_free_attention_matches_reference(with_stats, L):
    rng = np.random.default_rng(L + with_stats)
    q, k, v = (rng.standard_normal((2, 2, L, 8)).astype(np.float32) for _ in range(3))
    stats = None
    if with_stats:
        stats = {n: (rng.uniform(0.5, 1.5, 8) if n.endswith("scale") else rng.normal(0, 0.2, 8))
                 .astype(np.float32) for n in ("q_scale", "q_bias", "k_scale", "k_bias")}
    out = softmax_free_attention(_t(q), _t(k), _t(v),
                                 qk_stats=None if stats is None else {n: _t(a) for n, a in stats.items()})
    ref = j_sfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                qk_stats=None if stats is None else jax.tree_util.tree_map(jnp.asarray, stats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_apply_bn_transformer_matches_reference(tiny):
    """The sub-band block (attention + bi-GRU) of the full-width model's
    shape family: L = 128 along F', d = 16, 2 heads."""
    jcfg = j_tft.tftnn_config()
    jp = perturb_bn(_j_init(jax.random.PRNGKey(4), jcfg), seed=4)["blocks"][0]["sub"]
    x = np.random.default_rng(5).standard_normal((3, jcfg.att_len, jcfg.att_dim)).astype(np.float32)
    out, _ = bn_transformer.apply_bn_transformer(to_port(jp), _t(x), tft._sub_cfg(port_cfg(jcfg)))
    ref = jax.jit(lambda p, x: j_bnt.apply_bn_transformer(p, x, j_tft._sub_cfg(jcfg))[0])(jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_unported_branches_raise(tiny):
    _, _, cfg, params = tiny
    x = torch.zeros((1, cfg.att_len, cfg.att_dim))
    sub = params["blocks"][0]["sub"]
    for bad in ({"softmax_free": False}, {"causal": True}):
        tcfg = dataclasses.replace(tft._sub_cfg(cfg), **bad)
        with pytest.raises(NotImplementedError):
            bn_transformer.mha_softmax_free(sub, x, tcfg)
    with pytest.raises(NotImplementedError, match="train"):
        tft.apply_tft(params, torch.zeros((1, cfg.freq_bins, 2, 2)), cfg, train=True)


def test_apply_tft_matches_reference(tiny):
    jcfg, jparams, cfg, params = tiny
    spec = np.random.default_rng(6).standard_normal((2, jcfg.freq_bins + 1, 5, 2)).astype(np.float32)
    mask, _ = tft.apply_tft(params, _t(spec), cfg)
    ref = _j_apply_tft(jparams, jnp.asarray(spec), jcfg)
    assert mask.shape == spec.shape
    np.testing.assert_array_equal(mask[:, jcfg.freq_bins :].numpy(), 0.0)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_stream_step_matches_reference(tiny):
    """Four frames with the full-band GRU state carried from frame to frame."""
    jcfg, jparams, cfg, params = tiny
    frames = np.random.default_rng(7).standard_normal((4, 2, jcfg.freq_bins + 1, 2)).astype(np.float32)
    jstate = j_tft.init_stream_state(jparams, jcfg, 2)
    state = tft.init_stream_state(params, cfg, 2)
    grus = tft.sub_band_grus(params)
    for f in frames:
        jstate, ref = _j_stream_step(jparams, jstate, jnp.asarray(f), jcfg)
        state, mask = tft.stream_step(params, state, _t(f), cfg, sub_grus=grus)
        np.testing.assert_allclose(mask.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
        for name in state:
            np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), atol=1e-4, rtol=1e-4)


def _run_hops(jcfg, jparams, cfg, params, wave, quant):
    """Drive the reference's and the port's ``make_stream_hop(backend="xla")``."""
    B, hops = wave.shape[0], wave.shape[1] // jcfg.hop
    jstep = j_se.make_stream_hop(jparams, jcfg, quant=J_FP10 if quant else None, backend="xla",
                                 donate=False)
    step = se.make_stream_hop(params, cfg, quant=FP10 if quant else None, backend="xla", device="cpu")
    js, ts = j_se.init_stream(jparams, jcfg, B), se.init_stream(None, cfg, B, device="cpu")
    active = np.ones((B,), bool)
    jo, to = [], []
    for i in range(hops):
        h = wave[:, i * jcfg.hop : (i + 1) * jcfg.hop]
        js, y = jstep(js, jnp.asarray(h), jnp.asarray(active))
        ts, z = step(ts, _t(h), torch.from_numpy(active))
        jo.append(np.asarray(y))
        to.append(z.numpy())
    return np.concatenate(jo, axis=1), np.concatenate(to, axis=1)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "fp10"])
def test_xla_hop_matches_reference(tiny, quant):
    jcfg, jparams, cfg, params = tiny
    wave = (np.random.default_rng(8).standard_normal((2, 8 * jcfg.hop)) * 0.3).astype(np.float32)
    ref, out = _run_hops(jcfg, jparams, cfg, params, wave, quant)
    assert out.shape == ref.shape and np.isfinite(out).all()
    if quant:
        share = _close_share(out, ref)
        print(f"FP10 xla hop: {share:.5f} of samples within 1e-4, "
              f"worst gap {float(np.max(np.abs(out - ref))):.3g}")
        assert share >= 0.999
    else:
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_xla_hop_full_width():
    """The paper's model at full width (F=256, C=32, d=16): B=2, 8 hops."""
    jcfg = j_tft.tftnn_config()
    jparams = perturb_bn(_j_init(jax.random.PRNGKey(9), jcfg), seed=9)
    wave = (np.random.default_rng(9).standard_normal((2, 8 * jcfg.hop)) * 0.3).astype(np.float32)
    ref, out = _run_hops(jcfg, jparams, port_cfg(jcfg), to_port(jparams), wave, quant=False)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _utterance(seed, batch, hops, hop, log_amp):
    amp = 10.0**log_amp
    wave = amp * np.random.default_rng(seed).standard_normal((batch, hops * hop))
    return wave.astype(np.float32), amp


@pytest.mark.parametrize("seed,log_amp", [(0, 0.0), (1, -2.5), (2, 2.0)])
def test_enhance_matches_reference(tiny, seed, log_amp):
    """Two utterances of 9 hops at three scales (one shape: one compile of
    each reference function)."""
    jcfg, jparams, cfg, params = tiny
    wave, amp = _utterance(seed, 2, 9, jcfg.hop, log_amp)
    for j_fn, fn in ((_j_enhance_streaming, se.enhance_streaming),
                     (_j_enhance_offline, se.enhance_offline)):
        ref = np.asarray(j_fn(jparams, jcfg, jnp.asarray(wave)))
        out = fn(params, cfg, wave, device="cpu").numpy()
        assert out.shape == ref.shape == wave.shape
        np.testing.assert_allclose(out / amp, ref / amp, atol=1e-5, rtol=1e-4, err_msg=fn.__name__)


@pytest.mark.parametrize("seed,batch,hops,log_amp", [(3, 1, 1, 0.0), (4, 2, 6, -3.0), (5, 3, 24, 3.0), (6, 2, 11, 1.0)])
def test_streaming_equals_offline(tiny, seed, batch, hops, log_amp):
    """The port's own streaming invariant, as tests/test_streaming_se.py
    states it for the reference; a ragged tail is dropped by both."""
    _, _, cfg, params = tiny
    wave, amp = _utterance(seed, batch, hops, cfg.hop, log_amp)
    wave = np.concatenate([wave, np.ones((batch, cfg.hop // 2), np.float32)], axis=1)
    ys = se.enhance_streaming(params, cfg, wave, device="cpu").numpy()
    yo = se.enhance_offline(params, cfg, wave, device="cpu").numpy()
    assert ys.shape == yo.shape == (batch, hops * cfg.hop)
    np.testing.assert_allclose(ys / amp, yo / amp, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "fp10"])
def test_xla_pool_matches_reference_per_session(tiny, quant):
    jcfg, jparams, cfg, params = tiny
    audio = (np.random.default_rng(10).standard_normal((3, 6 * cfg.hop)) * 0.3).astype(np.float32)
    chunk_sizes = [(5, 16, 40), (27, 16, 3), (64, 32, 20), (0, 32, 33)]
    ref = drive(JSessionPool(jparams, jcfg, capacity=4, backend="xla",
                              quant=J_FP10 if quant else None), audio, chunk_sizes)
    ours = drive(SessionPool(params, cfg, capacity=4, backend="xla", device="cpu",
                              quant=FP10 if quant else None), audio, chunk_sizes)
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape and o.size > 0, i
        if quant:
            assert _close_share(o, r) >= 0.999, i
        else:
            np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4, err_msg=f"session {i}")


def test_xla_pool_bit_identical_under_churn(tiny):
    """A session's audio alone == among neighbours that attach, feed and
    detach around it, on the training-graph hop."""
    _, _, cfg, params = tiny
    rng = np.random.default_rng(11)
    mine = (rng.standard_normal(6 * cfg.hop) * 0.3).astype(np.float32)
    noise = (rng.standard_normal((8, 6 * cfg.hop)) * 0.5).astype(np.float32)

    def run(churn):
        pool = SessionPool(params, cfg, capacity=4, backend="xla", device="cpu")
        neighbours = [pool.attach()] if churn else []
        me = pool.attach()
        out = []
        for t in range(6):
            if churn and t in (1, 3):
                neighbours.append(pool.attach())
            if churn and t in (2, 4):
                pool.detach(neighbours.pop(0))
            for j, n in enumerate(neighbours):
                pool.feed(n, noise[j + t][: cfg.hop + 7 * t])
            pool.feed(me, mine[t * cfg.hop : (t + 1) * cfg.hop])
            pool.pump()
            out.append(pool.read(me))
        return np.concatenate(out)

    alone, crowded = run(False), run(True)
    assert alone.size == 6 * cfg.hop
    np.testing.assert_array_equal(alone, crowded)


def test_xla_path_on_cpu_launches_nothing(tiny):
    _, _, cfg, params = tiny
    before = [k.launches for k in KERNELS]
    se.enhance_streaming(params, cfg, np.zeros((1, 2 * cfg.hop), np.float32), quant=FP10, device="cpu")
    assert [k.launches for k in KERNELS] == before


def test_unknown_backend_raises(tiny):
    _, _, cfg, params = tiny
    with pytest.raises(ValueError, match="backend"):
        se.make_stream_hop(params, cfg, backend="tpu", device="cpu")
