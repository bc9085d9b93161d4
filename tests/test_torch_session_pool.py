"""The port's SessionPool against the reference's, on the CPU.

Both pools get the same parameters (the reference's tree, converted with
``repro_torch.bridge``) and the same audio, fed in the same uneven chunks.
The reference serves through ``backend="pallas"`` (Pallas kernels in
interpret mode); the port through its deploy graph with ``device="cpu"``
(the kernels' plain versions). Per-session audio agrees to atol = rtol =
1e-4, the reference's hop tolerance (tests/test_deploy.py:96).
"""

import numpy as np
import pytest
import torch

from repro.serve import SessionPool as JSessionPool
from repro_torch.launch.serve import main as launch_main
from repro_torch.models import tftnn as tft
from repro_torch.serve import PoolFullError, SessionError, SessionPool
from test_deploy import tiny_cfg, trained_params
from test_torch_deploy import port_cfg, to_port


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_cfg()
    jparams = trained_params(jcfg)
    return jcfg, jparams, port_cfg(jcfg), to_port(jparams)


def drive(pool, audio, chunk_sizes):
    """Feed each session its audio in the given chunk sizes, pumping after
    every round; returns each session's enhanced audio."""
    sessions = [pool.attach() for _ in audio]
    pos = [0] * len(audio)
    outs = [[] for _ in audio]
    for sizes in chunk_sizes:
        for i, (s, n) in enumerate(zip(sessions, sizes)):
            pool.feed(s, audio[i][pos[i] : pos[i] + n])
            pos[i] += n
        pool.pump()
        for i, s in enumerate(sessions):
            outs[i].append(pool.read(s))
    for i, s in enumerate(sessions):
        outs[i].append(pool.detach(s))
    return [np.concatenate(o) for o in outs]


def test_pool_matches_reference_per_session(setup):
    jcfg, jparams, cfg, params = setup
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((3, 6 * cfg.hop)) * 0.3).astype(np.float32)
    # uneven: dribbles, a whole-hop chunk, sub-hop remainders, a burst
    chunk_sizes = [(5, 16, 40), (27, 16, 3), (64, 32, 20), (0, 32, 33)]
    ref = drive(JSessionPool(jparams, jcfg, capacity=4, backend="pallas"), audio, chunk_sizes)
    ours = drive(SessionPool(params, cfg, capacity=4, device="cpu"), audio, chunk_sizes)
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape and o.size > 0, i
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4, err_msg=f"session {i}")


def test_session_audio_bit_identical_under_churn(setup):
    """A session's audio alone == next to neighbours that attach, feed and
    detach around it (slots are isolated inside the batched step)."""
    _, _, cfg, params = setup
    rng = np.random.default_rng(4)
    mine = (rng.standard_normal(6 * cfg.hop) * 0.3).astype(np.float32)
    noise = (rng.standard_normal((8, 6 * cfg.hop)) * 0.5).astype(np.float32)

    def run(churn):
        pool = SessionPool(params, cfg, capacity=4, device="cpu")
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


def test_pool_full_and_dead_handles_raise(setup):
    _, _, cfg, params = setup
    pool = SessionPool(params, cfg, capacity=2, device="cpu")
    a, _ = pool.attach(), pool.attach()
    with pytest.raises(PoolFullError, match="capacity=2"):
        pool.attach()
    pool.detach(a)
    with pytest.raises(SessionError):
        pool.feed(a, np.zeros(16, np.float32))
    assert pool.attach().slot == a.slot  # the freed slot is reused


def test_default_device_raises_without_cuda(setup, monkeypatch):
    _, _, cfg, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SessionPool(params, cfg, capacity=2)


@pytest.mark.parametrize("knob,value", [
    ("backend", "xla"), ("inflight", 2), ("hops_per_step", 4), ("ingest_ring", 8),
    ("max_unread_hops", 4), ("prune_keep", 0.5), ("finite_guard", True), ("donate", False),
])
def test_unported_knobs_raise(setup, knob, value):
    """Every knob not ported raises ``NotImplementedError`` naming it. The
    ``"xla"`` backend is ported (tests/test_torch_xla.py): it builds, and
    only a backend the reference does not know is refused."""
    _, _, cfg, params = setup
    if (knob, value) == ("backend", "xla"):
        assert SessionPool(params, cfg, capacity=2, device="cpu", backend="xla").backend == "xla"
        with pytest.raises(ValueError, match="backend"):
            SessionPool(params, cfg, capacity=2, device="cpu", backend="tpu")
        return
    with pytest.raises(NotImplementedError, match=knob):
        SessionPool(params, cfg, capacity=2, device="cpu", **{knob: value})


def test_launcher_serves_on_cpu(capsys):
    launch_main(["--task", "pool", "--reduced", "--batch", "2", "--samples", "400",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "SessionPool(capacity=2, active=2" in out and "3 hops" in out
    assert "backend=pallas" in out


def test_launcher_serves_xla_backend_on_cpu(capsys):
    launch_main(["--task", "pool", "--reduced", "--batch", "2", "--samples", "400",
                 "--device", "cpu", "--backend", "xla", "--quant"])
    out = capsys.readouterr().out
    assert "SessionPool(capacity=2, active=2" in out and "3 hops" in out
    assert "backend=xla" in out


def test_init_tft_is_reproducible_from_seed():
    cfg = tft.tftnn_config()
    a = tft.init_tft(torch.Generator().manual_seed(5), cfg)
    b = tft.init_tft(torch.Generator().manual_seed(5), cfg)
    torch.testing.assert_close(a["blocks"][1]["sub"]["wq"]["w"], b["blocks"][1]["sub"]["wq"]["w"],
                               atol=0.0, rtol=0.0)
