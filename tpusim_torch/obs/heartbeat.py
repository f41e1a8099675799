"""Heartbeat progress for long replays (the port's copy of
tpusim/obs/heartbeat.py's host half, and the ring the kernels tick into).

A 100k-node replay is one kernel launch that can run for minutes with no
host output. With `SimulatorConfig.heartbeat_every > 0` (or bench_scale
--heartbeat), the record forms of the replay kernels have thread 0 write
the processed-event count into a host-mapped pinned ring (RingTicker: a
buffer of cudaHostAlloc(cudaHostAllocMapped)) at each multiple of N, with
__threadfence_system(); a host thread drains the ring while the launch
runs and delivers every stride tick to `tick` (none is skipped however
fast the kernel runs: a tick the ring overwrote is recovered from the
stride, for ticks fall on its multiples). The plain versions tick from
their loop. No host callback runs inside a kernel.

The device side ships only the processed-event count; everything rate-
or time-shaped lives here on the host, so the heartbeat cannot change the
trajectory. Lines are rate-limited to one per MIN_INTERVAL_S of wall time,
but the driver always fires a final 100% tick (complete(): total wall +
mean ev/s) when the replay's result lands.
"""

from __future__ import annotations

import sys
import time

# module-level host state: one scan is in flight per process at a time
# (the driver replays serially); configure() re-arms it per dispatch
_STATE = {
    "total": 0,
    "label": "",
    "t0": 0.0,
    "last_emit": 0.0,
    "ticks": 0,
    "sink": None,  # test hook: callable(line) instead of stderr
    # run-level event window: `base` is added to the device's raw
    # processed count (fault segments restart their counter at 0 but sit
    # `base` events into the run); `resumed` is the count already inside
    # the raw number that THIS process never executed (a
    # checkpoint-resumed carry), subtracted from the rate so a resumed
    # run's ev/s and ETA describe real progress
    "base": 0,
    "resumed": 0,
    # run/job id the armed replay's ticks carry: listeners key per-job
    # progress off this tag
    "job": "",
    # worker id: which worker's replay is progressing
    "worker": "",
}

MIN_INTERVAL_S = 1.0

# progress listeners: called on EVERY tick (rate-limited ones included)
# with a dict
# {done, total, rate, eta, label, final}. Must be cheap and non-raising.
_LISTENERS = []


def add_listener(fn):
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def remove_listener(fn):
    if fn in _LISTENERS:
        _LISTENERS.remove(fn)


def _notify(done: int, total: int, rate: float, eta: float,
            final: bool = False):
    info = {
        "done": int(done), "total": int(total), "rate": float(rate),
        "eta": float(eta), "label": _STATE["label"], "final": bool(final),
        "job": _STATE["job"], "worker": _STATE["worker"],
    }
    for fn in list(_LISTENERS):
        try:
            fn(info)
        except Exception:  # a broken listener must never kill a replay
            pass


def configure(total_events: int, label: str = "scan", sink=None,
              base: int = 0, job: str = "", worker: str = ""):
    """Arm the heartbeat for the next scan: total event count for the ETA
    and a label for the line. Called by the driver right before each
    dispatch whose engine was built with a heartbeat. `base` = events of
    the RUN already replayed by earlier scans (the fault path's segment
    offset), so chunk/segment ticks report run-level progress. `job` tags
    every tick of this replay with a run/job id so listeners serving
    several jobs from one process can keep their progress streams apart;
    empty keeps the anonymous single-run behaviour. `worker`
    additionally tags the ticks with the serving worker's id."""
    _STATE.update(
        total=int(total_events), label=label, t0=time.perf_counter(),
        last_emit=0.0, ticks=0, sink=sink, base=int(base), resumed=0,
        job=str(job or ""), worker=str(worker or ""),
    )


def note_resume(done0: int):
    """Mark the armed scan as resumed from a checkpoint at `done0`
    processed events: the carry's counter already includes them, so the
    rate denominator must not credit this process with their work."""
    _STATE["resumed"] = int(done0)


def tick(done):
    """One stride tick: `done` processed events of the armed replay (from
    the ring's drain thread, or a plain replay's loop)."""
    now = time.perf_counter()
    _STATE["ticks"] += 1
    done = _STATE["base"] + int(done)
    total = _STATE["total"]
    dt = max(now - _STATE["t0"], 1e-9)
    fresh = max(done - _STATE["base"] - _STATE["resumed"], 0)
    rate = fresh / dt
    eta = (total - done) / rate if (total > done and rate > 0) else 0.0
    _notify(done, total, rate, eta)
    if now - _STATE["last_emit"] < MIN_INTERVAL_S:
        return
    _STATE["last_emit"] = now
    line = (
        f"[obs] {_STATE['label']}: {done}/{total or '?'} events "
        f"({rate:,.0f} ev/s, eta {eta:,.0f}s)"
    )
    sink = _STATE["sink"]
    if sink is not None:
        sink(line)
    else:
        print(line, file=sys.stderr, flush=True)


def tick_count() -> int:
    """Ticks received since the last configure() (test hook)."""
    return _STATE["ticks"]


def complete(true_total: int = 0):
    """Final 100% tick, emitted by the driver when the scan's result is
    ready: total wall and MEAN events/s over the whole scan, bypassing
    the rate limit — so a short run that finished inside MIN_INTERVAL_S
    (and therefore never printed a periodic tick) still reports one
    line. `true_total` is the PRE-padding event count: the heartbeat is
    armed with the bucket-padded stream size (what the scan body can
    count), but the pad EV_SKIPs are near-free, so reporting them would
    overstate both the total and the mean ev/s of a small run. Disarms
    the heartbeat afterwards; a second call (or a call with nothing
    armed) is a no-op."""
    total = _STATE["total"]
    if not total:
        return
    base = _STATE["base"]
    if true_total:
        # `true_total` is the SCAN's pre-padding event count, but the
        # armed total is run-level (base + this scan's padded events) —
        # clamp on the same clock, or a fault segment's final tick would
        # jump the /progress counter backwards to segment-local numbers
        total = min(total, base + int(true_total))
    now = time.perf_counter()
    dt = max(now - _STATE["t0"], 1e-9)
    # mean rate over the events THIS process actually executed in this
    # scan — the base/resumed discipline of tick()
    fresh = max(total - base - _STATE["resumed"], 0)
    line = (
        f"[obs] {_STATE['label']}: {total}/{total} events done in "
        f"{dt:,.1f}s ({fresh / dt:,.0f} ev/s mean)"
    )
    _STATE["ticks"] += 1
    _STATE["last_emit"] = now
    _STATE["total"] = 0  # disarm
    _notify(total, total, fresh / dt, 0.0, final=True)
    sink = _STATE["sink"]
    if sink is not None:
        sink(line)
    else:
        print(line, file=sys.stderr, flush=True)


def due(done: int, every: int) -> bool:
    """Whether `done` processed events sit on the heartbeat's stride (the
    plain replays' and the oracle's tick test; the kernels test the
    same)."""
    return every > 0 and done % every == 0


class RingTicker:
    """The host half of the kernels' heartbeat: a host-mapped pinned ring
    (tpusim_torch.kernels.MappedBuffer: word 0 the count of ticks
    written, then `slots` processed counts, slot (j mod slots) for tick
    j) and a thread that drains it while a launch runs, delivering each
    stride tick to `tick` in order. A drain that finds the ring lapped
    recovers the overwritten ticks from the stride: tick j of a launch
    that started at `start` processed events is the (j+1)-th multiple of
    `every` after it. `start()` arms it before the launch, `stop(event)`
    drains until the CUDA event has completed, then returns the ticks
    delivered."""

    def __init__(self, ring, every: int, start_count: int = 0):
        self.ring = ring
        self.every = int(every)
        self.base = int(start_count)
        self.seen = 0
        self.delivered = 0
        self._thread = None
        self._done = None

    def _expected(self, j: int) -> int:
        first = (self.base // self.every + 1) * self.every
        return first + j * self.every

    def drain(self) -> None:
        words = self.ring.words()
        head = int(words[0])
        slots = len(words) - 1
        while self.seen < head:
            j = self.seen
            value = int(words[1 + j % slots])
            if int(words[0]) - j > slots:  # lapped before or while read
                value = self._expected(j)
            tick(value)
            self.seen += 1
            self.delivered += 1

    def start(self) -> None:
        import threading

        self.ring.zero()
        self._done = threading.Event()

        def loop():
            while not self._done.wait(0.005):
                self.drain()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, event) -> int:
        """Drain until the CUDA `event` (recorded after the launch) has
        completed, join the thread, and return the ticks delivered. With
        no event (the launch was refused) the thread is only joined."""
        import time as _time

        try:
            while event is not None and not event.query():
                _time.sleep(0.002)
        finally:
            self._done.set()
            self._thread.join()
        if event is not None:
            self.drain()
        return self.delivered
