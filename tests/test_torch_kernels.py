"""The port's kernel modules against the reference kernels, on the CPU.

On CPU tensors each port wrapper runs its plain PyTorch version; that is
held here against the reference's Pallas kernel (interpret mode, through its
``ops`` wrapper with ``use_pallas=True``) and against its ``ref.py``, on the
same numpy inputs. The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.

Tolerances are the reference's own: 2e-5 for the dilated conv
(tests/test_kernel_properties.py:90), 1e-5 for linear attention and the
masked matmul (tests/test_kernels.py, tests/test_deploy.py). FP10 rounding
is compared value for value: equal, except where the reference's own result
is off the FP10 grid (ROADMAP C1/C4), which is counted and bounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dilated_conv import dilated_split_conv as j_dilated
from repro.kernels.fp10.kernel import fp10_quantize_pallas as j_fp10_pallas
from repro.kernels.fp10.ref import fp10_quantize_ref as j_fp10_ref
from repro.kernels.linear_attention import linear_attention as j_la
from repro.kernels.linear_attention.ref import linear_attention_ref as j_la_ref
from repro.kernels.dilated_conv.ref import dilated_split_conv_ref as j_dilated_ref
from repro.kernels.linear_attention import linear_attention_step as j_la_step
from repro.kernels.linear_attention.ref import linear_attention_step_ref as j_la_step_ref
from repro.kernels.masked_mac import masked_matmul as j_masked
from repro.kernels.masked_mac.ref import masked_matmul_ref as j_masked_ref
from repro_torch.kernels import KERNELS
from repro_torch.kernels.dilated_conv import dilated_split_conv, dilated_split_conv_ref
from repro_torch.kernels.fp10 import fp10_quantize, fp10_quantize_ref
from repro_torch.kernels.linear_attention import linear_attention, linear_attention_ref, linear_attention_step
from repro_torch.kernels.masked_mac import masked_matmul
from repro_torch.kernels.runtime import use_plain


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _conv_inputs(seed, B, F, C, k=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, C)).astype(np.float32)
    w = (rng.standard_normal((k, C // 2, C // 2)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((C // 2,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("F,C", [(32, 8), (37, 32)])
def test_dilated_conv_matches_pallas_and_ref(dilation, swap, F, C):
    x, w, b = _conv_inputs(dilation * 10 + F, 3, F, C)
    x[1] = 0.0  # an all-zero frame takes the zero-skip short cut
    out = dilated_split_conv(_t(x), _t(w), _t(b), dilation=dilation, swap_halves=swap).numpy()
    pallas = np.asarray(j_dilated(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  dilation=dilation, swap_halves=swap, use_pallas=True))
    ref = np.asarray(j_dilated_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=dilation))
    if swap:
        ref = np.concatenate([ref[..., C // 2 :], ref[..., : C // 2]], axis=-1)
    np.testing.assert_allclose(out, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_dilated_conv_zero_frame_short_cut():
    """An all-zero frame gives relu(b) on the processed half, zeros elsewhere,
    even with an infinite weight (the skip never multiplies)."""
    x, w, b = _conv_inputs(3, 2, 16, 8)
    x[0] = 0.0
    w[0, 0, 0] = np.inf
    out = dilated_split_conv(_t(x), _t(w), _t(b), dilation=2, swap_halves=True).numpy()
    np.testing.assert_array_equal(out[0, :, :4], 0.0)
    np.testing.assert_array_equal(out[0, :, 4:], np.broadcast_to(np.maximum(b, 0.0), (16, 4)))
    assert not np.isfinite(out[1]).all()  # the live frame really multiplies by inf
    # with finite weights the short cut equals the computed path
    x, w, b = _conv_inputs(4, 2, 16, 8)
    x[0] = 0.0
    skip = dilated_split_conv_ref(_t(x), _t(w), _t(b), zero_skip=True)
    full = dilated_split_conv_ref(_t(x), _t(w), _t(b), zero_skip=False)
    torch.testing.assert_close(skip, full, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("L", [37, 128])
def test_linear_attention_step_matches_pallas_and_ref(L):
    """The output is compared as the hop consumes it, divided by L (Eq. 1's
    normalizer), as tests/test_deploy.py:146-154 compares the reference's."""
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal((2, 2, L, 8)).astype(np.float32) for _ in range(3))
    kv = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)  # a non-zero carried state
    out, new_kv = linear_attention_step(_t(q), _t(k), _t(v), _t(kv))
    jq, jk, jv, jkv = map(jnp.asarray, (q, k, v, kv))
    p_out, p_kv = j_la_step(jq, jk, jv, jkv, block_l=16, use_pallas=True)
    r_out, r_kv = j_la_step_ref(jq, jk, jv, jkv)
    for o, ref in ((out / L, p_out / L), (out / L, r_out / L), (new_kv, p_kv), (new_kv, r_kv)):
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("M,K,N", [(37, 20, 12), (256, 32, 16), (50, 16, 32)])
def test_masked_matmul_matches_pallas_and_ref(M, K, N):
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[8:16] = 0.0  # a whole block_k strip is pruned and skipped
    b = rng.standard_normal((N,)).astype(np.float32)
    out = masked_matmul(_t(x), _t(w), _t(b)).numpy()
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    pallas = np.asarray(j_masked(jx, jw, jb, block_k=8, use_pallas=True))
    ref = np.asarray(j_masked_ref(jx, jw, jb))
    np.testing.assert_allclose(out, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_masked_matmul_leading_axes():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 21, 24)).astype(np.float32)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    out = masked_matmul(_t(x), _t(w), _t(b))
    assert out.shape == (3, 21, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_masked_ref(*map(jnp.asarray, (x, w, b)))),
                               atol=1e-5, rtol=1e-5)


def test_cpu_path_launches_nothing():
    before = [k.launches for k in KERNELS]
    x, w, b = _conv_inputs(0, 1, 8, 4)
    dilated_split_conv(_t(x), _t(w), _t(b))
    masked_matmul(_t(x[0]), _t(np.ones((4, 2))), _t(np.zeros(2)))
    z = torch.zeros((1, 1, 4, 2))
    linear_attention_step(z, z, z, torch.zeros((1, 1, 2, 2)))
    linear_attention(z, z, z)
    fp10_quantize(z)
    assert [k.launches for k in KERNELS] == before


FP10_MAX = (2.0 - 2.0**-4) * 2.0**15  # 63488, the largest s1/e5/m4 value


def _fp10_probes(seed):
    """Values weighted toward tiny magnitudes, the subnormal grid and its
    ties, exact powers of two, and the special values."""
    rng = np.random.default_rng(seed)
    sub = np.arange(0, 64) * 2.0**-18  # the subnormal grid (step 2**-18)
    return np.concatenate([
        rng.standard_normal(100_000) * 10.0 ** rng.integers(-8, 6, 100_000),
        sub, sub + 2.0**-19, -(sub + 2.0**-19),  # every grid point and every tie
        np.ldexp(1.0, np.arange(-26, 17)),
        [0.0, -0.0, 2.0**-19, 3 * 2.0**-19, FP10_MAX, 64000.0, 1e6, -1e6,
         np.inf, -np.inf, np.nan, -np.nan],
    ]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_fp10_matches_pallas_and_ref(seed):
    """The plain version rounds exactly onto the grid and equals the
    reference's Pallas kernel (interpret mode) and ``ref.py`` except where
    the reference's own result is off the grid or at the 2**-19 tie, which
    the reference rounds up and round-half-even rounds to 0 (ROADMAP C1).
    Those are counted; each gap is at most one grid step of the value's
    binade. (On random values the worst gap is 3.81e-6, rule C4; at exact
    ties in the binades where ``jnp.exp2`` is inexact the reference rounds
    the tie the other way, a whole step, e.g. 2**-17 at 33 * 2**-18.)"""
    probes = _fp10_probes(seed)
    ours = fp10_quantize(_t(probes)).numpy()
    assert np.array_equal(fp10_quantize_ref(_t(probes)).numpy(), ours, equal_nan=True)
    on_grid = lambda a: np.isnan(a) | (fp10_quantize(_t(a)).numpy() == a)  # noqa: E731
    assert on_grid(ours).all()
    finite = np.isfinite(probes)
    for ref in (np.asarray(j_fp10_pallas(jnp.asarray(probes), interpret=True)),
                np.asarray(j_fp10_ref(jnp.asarray(probes)))):
        listed = ~on_grid(ref) | (np.abs(probes) == 2.0**-19)
        differ = finite & (ours != ref)
        assert not (differ & ~listed).any(), probes[differ & ~listed][:10]
        gap = np.abs(ours - ref)[finite]
        step = np.ldexp(1.0, np.maximum(np.frexp(np.abs(probes[finite]))[1] - 1, -14) - 4)
        print(f"FP10: {int(differ.sum())} of {probes.size} differ, all off the reference's grid; "
              f"worst gap {float(gap.max()):.3g}")
        assert (gap <= step).all(), probes[finite][gap > step][:10]
        # the special values: NaN stays NaN, +-inf saturate, +-0 give 0, the
        # grid's top saturates, all as the reference gives them
        special = ~finite | (probes == 0) | (np.abs(probes) >= FP10_MAX)
        np.testing.assert_array_equal(ours[special], ref[special])
    assert np.isnan(ours[np.isnan(probes)]).all()
    np.testing.assert_array_equal(ours[np.isinf(probes)], np.sign(probes[np.isinf(probes)]) * FP10_MAX)


def test_fp10_shapes_and_grid_checks():
    x = _t(np.random.default_rng(3).standard_normal((8, 257, 2)) * 40)
    out = fp10_quantize(x)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert fp10_quantize(torch.zeros((0, 3))).shape == (0, 3)
    torch.testing.assert_close(fp10_quantize(x.double()), out, atol=0.0, rtol=0.0)
    with pytest.raises(TypeError):
        fp10_quantize(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        fp10_quantize(x, exp_bits=9, man_bits=4)


@pytest.mark.parametrize("L", [128, 37, 200, 1])
def test_linear_attention_matches_pallas_and_ref(L):
    """Non-causal Q @ (K^T V) / L; the reference's Pallas wrapper pads L to
    a block multiple and renormalizes, the port's kernel takes any L."""
    rng = np.random.default_rng(100 + L)
    q, k, v = (rng.standard_normal((2, 2, L, 8)).astype(np.float32) for _ in range(3))
    out = linear_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_array_equal(out, linear_attention_ref(_t(q), _t(k), _t(v)).numpy())
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for ref in (j_la(jq, jk, jv, block_l=64, use_pallas=True), j_la_ref(jq, jk, jv)):
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_linear_attention_validates_inputs():
    z = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="L = 0"):
        linear_attention(*(torch.zeros((1, 2, 0, 8)),) * 3)
    with pytest.raises(ValueError):
        linear_attention(z, z, torch.zeros((1, 2, 5, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        linear_attention(z.transpose(2, 3), z.transpose(2, 3), z.transpose(2, 3))


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape"])
def test_wrappers_validate_inputs(bad):
    x, w, b = (_t(a) for a in _conv_inputs(1, 2, 8, 8))
    if bad == "dtype":
        x = x.double()
    elif bad == "contiguity":
        x = x.transpose(0, 1)
    else:
        w = w[:, :2]
    with pytest.raises((TypeError, ValueError)):
        dilated_split_conv(x, w, b)


def test_dispatch_rule_is_by_device_without_fallback():
    cpu = torch.zeros(2)
    assert use_plain(cpu, cpu)
    with pytest.raises(ValueError, match="unsupported device"):
        use_plain(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        use_plain(cpu, torch.zeros(2, device="meta"))
