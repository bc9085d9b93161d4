"""Multi-session streaming enhancement server on the deployed hop.

Counterpart of ``repro/serve/session_server.py``: a fixed-capacity
``SessionPool`` multiplexes many client sessions onto one batched hop step
(``make_stream_hop``) whose state has one slot per session. Attach/detach
only flip a slot and zero its state, so churn never changes a shape; a
session's audio depends only on its own history, whatever its neighbours
do. Each session owns a ring buffer that takes chunks of any size;
``pump()`` drains whole hops across all sessions, one batched step each.

This port serves the deploy graph (``backend="pallas"``, on the card the
hand-written CUDA kernels) with one step in flight and one hop per session
per step. The reference's other knobs (``inflight=2``, ``hops_per_step``,
the ingestion ring, backpressure parking, pruning, durability, the finite
guard, fault injection, shared step caches) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.quant import QuantSpec
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import tftnn as tft_mod
from repro_torch.serve.streaming_se import StreamState, init_stream, make_stream_hop, reset_slots


class SessionError(RuntimeError):
    """A call references a session that is not live on this pool."""


class PoolFullError(SessionError):
    """``attach()`` on a pool whose every slot is occupied."""


@dataclasses.dataclass
class SessionStats:
    """Per-session serving accounting."""

    hops: int = 0  # hops actually enhanced
    samples_in: int = 0  # raw samples accepted by feed()
    samples_out: int = 0  # enhanced samples emitted
    proc_seconds: float = 0.0  # this session's share of batched step time

    def audio_seconds(self, sample_rate: int, hop: int) -> float:
        return self.hops * hop / sample_rate

    def rtf(self, sample_rate: int, hop: int) -> float:
        """Real-time factor: compute seconds per audio second (<1 = real time)."""
        audio = self.audio_seconds(sample_rate, hop)
        return self.proc_seconds / audio if audio > 0 else 0.0


@dataclasses.dataclass
class Session:
    """Client handle returned by ``SessionPool.attach``."""

    sid: int
    slot: int
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    detached: bool = False


@dataclasses.dataclass
class _Pending:
    """One in-flight batched step (between dispatch() and collect())."""

    out: torch.Tensor  # (B, hop)
    counts: np.ndarray  # (B,) int — hops consumed per slot by this step
    t0: float  # dispatch time (perf_counter)


class _RingBuffer:
    """Per-session ingestion buffer: accepts arbitrary-length float chunks,
    yields fixed hop-sized blocks."""

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []
        self._size = 0

    def push(self, samples: np.ndarray) -> None:
        if samples.size:
            self._chunks.append(samples)
            self._size += samples.size

    def __len__(self) -> int:
        return self._size

    def pop(self, n: int) -> np.ndarray:
        """Pop exactly n samples (caller checks len() first)."""
        out = np.empty((n,), np.float32)
        filled = 0
        while filled < n:
            head = self._chunks[0]
            take = min(n - filled, head.size)
            out[filled : filled + take] = head[:take]
            if take == head.size:
                self._chunks.pop(0)
            else:
                self._chunks[0] = head[take:]
            filled += take
        self._size -= n
        return out


class SessionPool:
    """Fixed-capacity multi-session streaming enhancement server.

    Typical client loop::

        pool = SessionPool(params, cfg, capacity=8)     # on cuda
        s = pool.attach()
        pool.feed(s, chunk)          # any chunk size, any time
        pool.pump()                  # run batched hop steps while audio waits
        audio = pool.read(s)         # enhanced samples ready so far
        pool.detach(s)

    Args:
        params: TFTNN parameter tree in the reference ``init_tft`` layout
            (``models.tftnn.init_tft``, or a reference tree through
            ``bridge.params_from_numpy`` / ``bridge.load_checkpoint``).
        cfg: model/front-end config; ``cfg.hop`` fixes the step granularity.
        capacity: number of slots, fixed for the pool's life.
        quant: optional ``core.quant`` grid (e.g. ``FP10``).
        sample_rate: audio sample rate for RTF accounting (paper: 8 kHz).
        device: where the state lives and the step runs; ``cuda`` unless
            the caller passes ``"cpu"``.
        backend, donate, prune_*, inflight, max_unread_hops, on_unparked,
        hops_per_step, step_fn, step_fns, ingest_ring, durability,
        finite_guard, faults: the reference's knobs. Only their defaults
        (``backend="pallas"``, ``donate=True``, ``inflight=1``,
        ``hops_per_step=1``, the rest unset) are ported; anything else
        raises ``NotImplementedError`` naming the knob.

    Raises:
        ValueError: ``capacity < 1``.
        NotImplementedError: an unported knob was set.
        RuntimeError: the device is CUDA and CUDA is not available.
    """

    def __init__(
        self,
        params: Any,
        cfg: tft_mod.TFTConfig,
        capacity: int,
        *,
        quant: Optional[QuantSpec] = None,
        sample_rate: int = 8000,
        donate: bool = True,
        device: DeviceLike = None,
        backend: str = "pallas",
        prune_keep: Optional[float] = None,
        prune_axis: Optional[int] = None,
        prune_granularity: Optional[str] = None,
        inflight: int = 1,
        max_unread_hops: Optional[int] = None,
        on_unparked=None,
        hops_per_step: int = 1,
        step_fn=None,
        step_fns: Optional[Dict[Any, Any]] = None,
        ingest_ring: Optional[int] = None,
        durability: Optional[Any] = None,
        finite_guard: bool = False,
        faults: Optional[Any] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        unported = {
            "donate=False": not donate,
            f"backend={backend!r}": backend != "pallas",
            "prune_keep": prune_keep is not None,
            "prune_axis": prune_axis is not None,
            "prune_granularity": prune_granularity is not None,
            f"inflight={inflight}": inflight != 1,
            "max_unread_hops": max_unread_hops is not None,
            "on_unparked": on_unparked is not None,
            f"hops_per_step={hops_per_step}": hops_per_step != 1,
            "step_fn": step_fn is not None,
            "step_fns": step_fns is not None,
            "ingest_ring": ingest_ring is not None,
            "durability": durability is not None,
            "finite_guard": finite_guard,
            "faults": faults is not None,
        }
        for knob, asked in unported.items():
            if asked:
                raise NotImplementedError(f"SessionPool: {knob} is not ported yet")
        self.cfg = cfg
        self.capacity = capacity
        self.sample_rate = sample_rate
        self.quant = quant
        self.device = resolve_device(device)
        self._step = make_stream_hop(params, cfg, quant=quant, device=self.device)
        self._state: StreamState = init_stream(params, cfg, capacity, device=self.device)
        self._slot_session: List[Optional[Session]] = [None] * capacity
        self._sessions: Dict[int, Session] = {}
        self._rings: List[_RingBuffer] = [_RingBuffer() for _ in range(capacity)]
        self._out: List[List[np.ndarray]] = [[] for _ in range(capacity)]
        self._sid_counter = itertools.count()
        self._hop_buf = np.zeros((capacity, cfg.hop), np.float32)
        self._pending: List[_Pending] = []
        self.step_seconds: List[float] = []  # pool-wide per-step latency

    # -- session lifecycle --------------------------------------------------

    @property
    def num_active(self) -> int:
        return len(self._sessions)

    def attach(self) -> Session:
        """Claim a free slot for a new stream (zeroed state, empty buffers).

        Raises:
            PoolFullError: every slot is occupied.
        """
        try:
            slot = self._slot_session.index(None)
        except ValueError:
            raise PoolFullError(
                f"pool is full (capacity={self.capacity}, active={self.num_active}); "
                f"detach a session first"
            ) from None
        mask = torch.zeros((self.capacity,), dtype=torch.bool)
        mask[slot] = True
        reset_slots(self._state, mask)
        sess = Session(sid=next(self._sid_counter), slot=slot)
        self._slot_session[slot] = sess
        self._sessions[sess.sid] = sess
        self._rings[slot] = _RingBuffer()
        self._out[slot] = []
        return sess

    def detach(self, sess: Session) -> np.ndarray:
        """Release the session's slot; returns its enhanced-but-unread audio.

        Queued-but-unprocessed input is dropped; the next occupant of the
        slot starts from zeroed state.

        Raises:
            SessionError: the handle is not live on this pool.
        """
        self._check(sess)
        tail = self.read(sess)
        sess.detached = True
        self._slot_session[sess.slot] = None
        del self._sessions[sess.sid]
        return tail

    def _check(self, sess: Session) -> None:
        if sess.detached or self._sessions.get(sess.sid) is not sess:
            raise SessionError(f"session {sess.sid} is not attached to this pool")

    # -- audio I/O ----------------------------------------------------------

    def feed(self, sess: Session, samples) -> None:
        """Queue raw audio (any array-like, any length) for a session.

        Raises:
            SessionError: the handle is not live on this pool.
        """
        self._check(sess)
        arr = np.array(samples, np.float32, copy=True).reshape(-1)
        self._rings[sess.slot].push(arr)
        sess.stats.samples_in += arr.size

    def read(self, sess: Session) -> np.ndarray:
        """Pop all enhanced audio produced for this session so far.

        Raises:
            SessionError: the handle is not live on this pool.
        """
        self._check(sess)
        self.collect()
        chunks = self._out[sess.slot]
        self._out[sess.slot] = []
        if not chunks:
            return np.zeros((0,), np.float32)
        out = np.concatenate(chunks)
        sess.stats.samples_out += out.size
        return out

    # -- the batched hop loop ----------------------------------------------

    def dispatch(self, max_hops: Optional[int] = None) -> int:
        """Launch ONE batched hop step over every session with a hop queued.

        The previous step, if any, is collected first. Returns the number of
        sessions stepped (0 = nothing ready, no compute enqueued).

        Raises:
            ValueError: ``max_hops`` other than None or 1.
        """
        if max_hops not in (None, 1):
            raise ValueError(f"max_hops must be 1 (hops_per_step=1), got {max_hops}")
        while self._pending:
            self._collect_one()
        hop = self.cfg.hop
        counts = np.zeros((self.capacity,), np.int32)
        for slot, sess in enumerate(self._slot_session):
            if sess is not None and len(self._rings[slot]) >= hop:
                self._hop_buf[slot] = self._rings[slot].pop(hop)
                counts[slot] = 1
        n_hops = int(counts.sum())
        if n_hops == 0:
            return 0
        t0 = time.perf_counter()
        hops = torch.tensor(self._hop_buf, device=self.device)
        active = torch.tensor(counts.astype(bool), device=self.device)
        self._state, out = self._step(self._state, hops, active)
        self._pending.append(_Pending(out=out, counts=counts, t0=t0))
        return n_hops

    def _collect_one(self) -> int:
        pending = self._pending.pop(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - pending.t0
        out = pending.out.cpu().numpy()
        self.step_seconds.append(dt)
        n_hops = int(pending.counts.sum())
        share = dt / n_hops
        for slot in np.flatnonzero(pending.counts):
            sess = self._slot_session[slot]
            if sess is None:  # detached while the step was in flight
                continue
            self._out[slot].append(out[slot])
            sess.stats.hops += 1
            sess.stats.proc_seconds += share
        return n_hops

    def collect(self) -> int:
        """Block on the in-flight step (if any) and distribute its output.

        Returns the number of hops delivered (0 = nothing was in flight).
        """
        total = 0
        while self._pending:
            total += self._collect_one()
        return total

    def step(self) -> int:
        """``dispatch()`` + ``collect()``; returns the hops stepped."""
        n = self.dispatch()
        if n:
            self.collect()
        return n

    def pump(self, scheduler=None) -> int:
        """Dispatch until no session has a full hop buffered; returns steps.

        Raises:
            NotImplementedError: a scheduler was given (not ported yet).
        """
        if scheduler is not None:
            raise NotImplementedError("SessionPool.pump: scheduler is not ported yet")
        steps = 0
        while self.dispatch():
            steps += 1
        self.collect()
        return steps

    # -- reporting ----------------------------------------------------------

    def latency_percentiles(self, qs=(50, 95, 99)) -> Dict[int, float]:
        """Pool-step wall-clock percentiles in milliseconds."""
        if not self.step_seconds:
            return {q: 0.0 for q in qs}
        arr = np.asarray(self.step_seconds) * 1e3
        return {q: float(np.percentile(arr, q)) for q in qs}

    def report(self) -> str:
        hop = self.cfg.hop
        lines = [
            f"SessionPool(capacity={self.capacity}, active={self.num_active}, "
            f"quant={self.quant or 'fp32'}, device={self.device})"
        ]
        pct = self.latency_percentiles()
        budget_ms = hop / self.sample_rate * 1e3
        lines.append(
            f"  step latency ms: p50={pct[50]:.2f} p95={pct[95]:.2f} "
            f"p99={pct[99]:.2f} (hop budget {budget_ms:.1f} ms)"
        )
        for sess in self._sessions.values():
            s = sess.stats
            lines.append(
                f"  session {sess.sid} slot {sess.slot}: {s.hops} hops, "
                f"rtf={s.rtf(self.sample_rate, hop):.3f}"
            )
        return "\n".join(lines)
