"""Multi-process runtime: bounded distributed init, barriers with
timeouts, and heartbeat-based rank-death detection.

Port of ``kfac_pytorch_tpu/runtime.py``.  The rest of the port runs on
whatever ``torch.distributed`` world the caller set up; this module is
the layer that brings that world up within a deadline and gives it a
rank-death story.  Without it, a SIGKILLed peer leaves the survivors
blocked in a gloo or NCCL collective until its timeout, or for ever.

Design center: nothing here may hang.

* :func:`initialize_distributed` — coordinator reachability probe,
  jittered exponential backoff around the init, and a hard deadline that
  raises :class:`RuntimeInitError` instead of blocking on a coordinator
  that never comes up.  Every clock, sleep, probe and initializer is
  injectable, with the JAX module's signatures, so the retry and deadline
  arithmetic unit-tests with fakes in milliseconds.
* :class:`DistributedRuntime` — owns the initialized world, a per-rank
  heartbeat file written by a daemon thread every
  ``heartbeat_interval_s``, and a monitor that detects a SIGKILLed peer
  within ``heartbeat_grace_s``.  An in-flight collective cannot be
  cancelled from Python, so on a peer's death the runtime records it
  (``rank_death.json``), runs the ``on_peer_death`` hooks (the flight
  recorder's dump) and ``os._exit(EXIT_RANK_DEATH)``: the supervisor sees
  a distinctive exit code, and the on-disk state is the last committed
  elastic generation (the manifest is written last).  Recovery is the
  elastic resize: restart at the surviving world size and
  ``elastic.restore_streaming`` the last committed generation.  Gloo
  may also raise ("connection closed by peer") from a collective whose
  peer died, before the heartbeat lapses; a caller that wants the
  runtime's exit code catches that error and waits for the monitor
  (``heartbeat_grace_s`` plus an interval) before re-raising.
* :meth:`DistributedRuntime.barrier` — a named barrier with a timeout,
  raising :class:`BarrierTimeoutError` (or :class:`RankDeathError` when
  the heartbeats already name a dead peer) instead of deadlocking.
* :func:`commit_point` — the hook the engine calls at every
  cross-process commit point (the elastic manifest write and stamp, the
  watchdog rollback, the consistency host sync).  A strict no-op unless a
  runtime is :func:`install`-ed and the world spans more than one
  process, so single-process engines are bit for bit unaffected.

Where the port departs from the JAX module, by design:

* **Init.** The default initializer creates the rendezvous
  ``torch.distributed.TCPStore`` itself (rank 0 hosts it) and passes it
  to ``init_process_group(backend, store=..., world_size, rank,
  timeout=...)``, the backend from
  :func:`~kfac_pytorch_tpu_torch.parallel.mesh.default_backend`.  Each
  attempt gets the remaining budget as its store timeout (the wait for
  the master to come up, or for every worker to connect), so the deadline
  bounds the in-call wait as JAX's ``initialization_timeout`` does.  The
  teardown between attempts is ``destroy_process_group`` when a group
  exists.
* **Barrier.** It runs on that store (``store.add`` of the tag's arrival
  counter, then ``store.wait`` on a done key, with a timeout), on the
  worker thread JAX uses.  It is not ``dist.barrier``: on NCCL that
  launches a kernel that cannot time out cleanly, and
  ``monitored_barrier`` is gloo-only.
* **No collectives.** The runtime issues no collective on the training
  process group, so it adds no row to the cost ledger
  (:mod:`~kfac_pytorch_tpu_torch.observe.costs`).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import random
import socket
import threading
import time
from typing import Any, Callable

from kfac_pytorch_tpu_torch import tracing

__all__ = [
    'EXIT_RANK_DEATH',
    'BarrierTimeoutError',
    'DistributedRuntime',
    'Heartbeat',
    'RankDeathError',
    'RuntimeConfig',
    'RuntimeInitError',
    'active',
    'commit_point',
    'initialize_distributed',
    'install',
    'probe_coordinator',
]

#: Process exit code used when a rank aborts because a peer died.  The
#: supervisor tells "I detected a dead peer and aborted cleanly" from a
#: crash or a hang-kill by it.
EXIT_RANK_DEATH = 87


class RuntimeInitError(RuntimeError):
    """The distributed init failed within the deadline."""


class BarrierTimeoutError(RuntimeError):
    """A named barrier did not complete within its timeout."""


class RankDeathError(RuntimeError):
    """A peer rank's heartbeat lapsed (it is presumed SIGKILLed)."""

    def __init__(self, message: str, dead_ranks: tuple[int, ...] = ()):
        super().__init__(message)
        self.dead_ranks = tuple(dead_ranks)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Configuration for one rank of a multi-process world.

    All timeouts are hard bounds: no call blocks past its deadline.
    ``coordinator`` is ``host:port`` of rank 0's rendezvous store.
    """

    coordinator: str
    num_processes: int
    process_id: int
    #: Hard ceiling on the whole init sequence (probe + retries).
    init_deadline_s: float = 60.0
    #: Per-attempt TCP reachability probe timeout.
    probe_timeout_s: float = 1.0
    #: Exponential backoff: base * 2**attempt, capped, jittered.
    backoff_base_s: float = 0.25
    backoff_max_s: float = 4.0
    #: Uniform jitter fraction applied to each backoff sleep.
    backoff_jitter: float = 0.5
    #: Default timeout for :meth:`DistributedRuntime.barrier`.
    barrier_timeout_s: float = 60.0
    #: Directory for per-rank heartbeat files (None disables the
    #: heartbeat threads: barriers then only time out, never detect
    #: death).
    heartbeat_dir: str | None = None
    heartbeat_interval_s: float = 0.25
    #: A peer whose newest beat is older than this is dead.
    heartbeat_grace_s: float = 3.0
    #: On detected peer death: record + hooks + os._exit.  Disable for
    #: unit tests that only want the detection signal.
    abort_on_death: bool = True

    def __post_init__(self) -> None:
        if self.num_processes < 1:
            raise ValueError(
                f'num_processes must be >= 1, got {self.num_processes}',
            )
        if not (0 <= self.process_id < self.num_processes):
            raise ValueError(
                f'process_id {self.process_id} outside '
                f'[0, {self.num_processes})',
            )
        for field in (
            'init_deadline_s', 'probe_timeout_s', 'backoff_base_s',
            'backoff_max_s', 'barrier_timeout_s',
            'heartbeat_interval_s', 'heartbeat_grace_s',
        ):
            if getattr(self, field) <= 0:
                raise ValueError(f'{field} must be > 0')


def probe_coordinator(
    address: str,
    timeout_s: float,
    *,
    connect: Callable[..., Any] = socket.create_connection,
) -> bool:
    """TCP-connect probe: is anything listening at ``host:port``?

    Never raises and never blocks past ``timeout_s``: an unreachable
    coordinator is the expected state while rank 0 is still coming up,
    and the retry loop owns the policy.
    """
    host, _, port = address.rpartition(':')
    try:
        conn = connect((host, int(port)), timeout=timeout_s)
    except (OSError, ValueError):
        return False
    try:
        conn.close()
    except OSError:
        pass
    return True


def _default_initialize(
    *,
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    initialization_timeout: int,
) -> Any:
    """Create the rendezvous store and the default process group.

    Rank 0 hosts a ``TCPStore`` at ``coordinator_address`` and waits for
    every worker to connect; the others connect to it.  Both waits, and
    the group's own timeout, are ``initialization_timeout`` seconds, the
    remaining init budget.  Returns the store (the barriers run on it).
    """
    import torch.distributed as dist

    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    host, _, port = coordinator_address.rpartition(':')
    timeout = datetime.timedelta(seconds=initialization_timeout)
    store = dist.TCPStore(
        host, int(port), num_processes, process_id == 0, timeout=timeout,
    )
    dist.init_process_group(
        default_backend(num_processes), store=store,
        world_size=num_processes, rank=process_id, timeout=timeout,
    )
    return store


def _teardown() -> None:
    """Best-effort teardown of a half-made world before a retry."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — nothing to tear down
        pass


def initialize_distributed(
    config: RuntimeConfig,
    *,
    initialize: Callable[..., Any] | None = None,
    probe: Callable[[str, float], bool] = probe_coordinator,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    uniform: Callable[[float, float], float] = random.uniform,
) -> int:
    """Bounded, retried distributed init.

    Returns the number of attempts that were made (>= 1).  Raises
    :class:`RuntimeInitError`, never hangs, if the world is not up by
    ``config.init_deadline_s``: the deadline bounds probe time, backoff
    sleeps and the in-call wait (the remaining budget is passed as
    ``initialization_timeout``, which the default initializer gives the
    store and the group as their timeouts).

    Non-zero ranks probe the coordinator socket before each attempt, so a
    coordinator that never comes up costs cheap TCP probes instead of
    full init timeouts; rank 0 hosts the coordinator and skips the probe.
    ``initialize`` is called with ``coordinator_address``,
    ``num_processes``, ``process_id`` and ``initialization_timeout``
    (default: :func:`_default_initialize`).
    """
    if initialize is None:
        initialize = _default_initialize
    start = clock()
    deadline = start + config.init_deadline_s
    attempts = 0
    last_reason: str = 'no attempts made'

    def _fail() -> RuntimeInitError:
        return RuntimeInitError(
            f'rank {config.process_id}: the distributed init did '
            f'not complete within {config.init_deadline_s:.1f}s '
            f'({attempts} attempt(s); coordinator '
            f'{config.coordinator}; last: {last_reason})',
        )

    def _backoff() -> None:
        delay = min(
            config.backoff_base_s * (2.0 ** (attempts - 1)),
            config.backoff_max_s,
        )
        delay *= 1.0 + uniform(0.0, config.backoff_jitter)
        remaining = deadline - clock()
        if remaining <= 0:
            raise _fail()
        sleep(min(delay, remaining))

    while True:
        now = clock()
        if now >= deadline:
            raise _fail()
        if config.process_id != 0 and not probe(
            config.coordinator,
            min(config.probe_timeout_s, deadline - now),
        ):
            attempts += 1
            last_reason = 'coordinator unreachable (TCP probe failed)'
            tracing.count_event('runtime_init_probe_failed')
            _backoff()
            continue
        remaining = deadline - clock()
        if remaining <= 0:
            raise _fail()
        attempts += 1
        try:
            initialize(
                coordinator_address=config.coordinator,
                num_processes=config.num_processes,
                process_id=config.process_id,
                initialization_timeout=max(1, int(remaining)),
            )
            tracing.count_event('runtime_init_ok')
            return attempts
        except Exception as exc:  # noqa: BLE001 — classified below
            last_reason = f'{type(exc).__name__}: {exc}'
            tracing.count_event('runtime_init_attempt_failed')
            _teardown()
            if clock() >= deadline:
                raise _fail() from exc
            _backoff()


# ----------------------------------------------------------------------
# heartbeats
# ----------------------------------------------------------------------


def _heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f'hb-{rank:05d}')


class Heartbeat:
    """Per-rank liveness files with bounded-staleness death detection.

    Each rank overwrites ``hb-<rank>`` with a monotonic timestamp (temp
    write + ``os.replace``, so readers never see a torn write).
    ``time.monotonic`` is ``CLOCK_MONOTONIC`` on Linux, one clock per
    host, comparable across the localhost processes of one machine; the
    file format is the JAX module's.

    A peer is dead when its newest beat is older than ``grace_s``, or
    when it never produced a beat within ``grace_s`` of this monitor
    starting (a rank that dies before its first beat must not be
    invisible for ever).
    """

    def __init__(
        self,
        directory: str,
        rank: int,
        num_ranks: int,
        *,
        interval_s: float = 0.25,
        grace_s: float = 3.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.directory = directory
        self.rank = rank
        self.num_ranks = num_ranks
        self.interval_s = interval_s
        self.grace_s = grace_s
        self._clock = clock
        self._started_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- writing ---------------------------------------------------------

    def beat(self) -> None:
        """Write one beat (atomically) for this rank."""
        path = _heartbeat_path(self.directory, self.rank)
        tmp = f'{path}.tmp-{os.getpid()}'
        with open(tmp, 'w') as fh:
            fh.write(f'{self._clock()!r}\n')
        os.replace(tmp, path)

    def start(self) -> None:
        """Begin beating from a daemon thread; marks the monitor epoch."""
        self._started_at = self._clock()
        self.beat()
        if self._thread is not None:
            return

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.beat()
                except OSError:
                    # A wedged heartbeat filesystem must not kill the
                    # training thread; peers will see this rank as dead,
                    # which is the correct failure direction.
                    pass

        self._thread = threading.Thread(
            target=_run, name=f'kfac-heartbeat-{self.rank}', daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1.0)
            self._thread = None

    # -- reading ---------------------------------------------------------

    def last_beat(self, rank: int) -> float | None:
        """The peer's newest beat timestamp, or None if never seen."""
        try:
            with open(_heartbeat_path(self.directory, rank)) as fh:
                return float(fh.read().strip())
        except (OSError, ValueError):
            return None

    def dead_ranks(self, now: float | None = None) -> tuple[int, ...]:
        """Ranks (excluding self) whose heartbeat has lapsed."""
        if now is None:
            now = self._clock()
        epoch = self._started_at
        dead = []
        for rank in range(self.num_ranks):
            if rank == self.rank:
                continue
            beat = self.last_beat(rank)
            if beat is None:
                if epoch is not None and now - epoch > self.grace_s:
                    dead.append(rank)
                continue
            if now - beat > self.grace_s:
                dead.append(rank)
        return tuple(dead)


# ----------------------------------------------------------------------
# the runtime
# ----------------------------------------------------------------------


class DistributedRuntime:
    """One rank's view of a multi-process world, with bounded waits.

    Lifecycle::

        rt = DistributedRuntime(RuntimeConfig(...))
        rt.initialize()          # bounded, retried init of the world
        install(rt)              # engine commit points barrier via rt
        ...training...
        rt.barrier('epoch')      # explicit named barrier
        rt.shutdown()

    Peer-death policy: the monitor thread scans the heartbeats every
    ``heartbeat_interval_s``.  On a lapse it writes
    ``<heartbeat_dir>/rank_death.json`` (dead ranks and the detection
    latency bound), runs every registered ``on_peer_death`` hook and,
    with ``abort_on_death``, ``os._exit(EXIT_RANK_DEATH)``.  An in-flight
    collective cannot be cancelled, so aborting cleanly means never
    losing committed on-disk state and never hanging: the manifest-last
    elastic commit and this bounded detector give both.
    """

    def __init__(
        self,
        config: RuntimeConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.config = config
        self._clock = clock
        self._sleep = sleep
        self.heartbeat: Heartbeat | None = None
        if config.heartbeat_dir is not None:
            self.heartbeat = Heartbeat(
                config.heartbeat_dir,
                config.process_id,
                config.num_processes,
                interval_s=config.heartbeat_interval_s,
                grace_s=config.heartbeat_grace_s,
                clock=clock,
            )
        self._death_hooks: list[Callable[[tuple[int, ...]], None]] = []
        self._monitor_stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._death_announced = False
        self.init_attempts: int | None = None
        #: The rendezvous store the barriers run on (set by
        #: :meth:`initialize` when the initializer returns one).
        self.store: Any = None
        # Per tag, the barriers entered so far: every rank enters the
        # barriers of one tag in the same order, so the count names the
        # same barrier on every rank.
        self._barrier_counts: dict[str, int] = {}

    # -- init ------------------------------------------------------------

    def initialize(
        self, *, initialize: Callable[..., Any] | None = None,
    ) -> int:
        """Bounded init + heartbeat/monitor startup.  Returns attempts.
        The initializer's return value (the default's store) becomes
        :attr:`store`."""
        init = _default_initialize if initialize is None else initialize
        box: dict[str, Any] = {}

        def capture(**kwargs: Any) -> None:
            box['store'] = init(**kwargs)

        self.init_attempts = initialize_distributed(
            self.config,
            initialize=capture,
            clock=self._clock,
            sleep=self._sleep,
        )
        self.store = box.get('store')
        if self.heartbeat is not None:
            self.heartbeat.start()
            self._start_monitor()
        return self.init_attempts

    def on_peer_death(
        self, hook: Callable[[tuple[int, ...]], None],
    ) -> None:
        """Register a hook run (once) when a peer death is detected."""
        self._death_hooks.append(hook)

    def dead_ranks(self) -> tuple[int, ...]:
        if self.heartbeat is None:
            return ()
        return self.heartbeat.dead_ranks()

    def _start_monitor(self) -> None:
        if self._monitor is not None:
            return

        def _run() -> None:
            interval = self.config.heartbeat_interval_s
            while not self._monitor_stop.wait(interval):
                dead = self.dead_ranks()
                if dead:
                    self._announce_death(dead)
                    return

        self._monitor = threading.Thread(
            target=_run,
            name=f'kfac-rank-monitor-{self.config.process_id}',
            daemon=True,
        )
        self._monitor.start()

    def _announce_death(self, dead: tuple[int, ...]) -> None:
        """Record + hooks + (optionally) abort.  Runs at most once."""
        if self._death_announced:
            return
        self._death_announced = True
        tracing.count_event('runtime_rank_death_detected')
        record = {
            'schema': 'kfac-rank-death',
            'rank': self.config.process_id,
            'dead_ranks': list(dead),
            # Upper bound on detection latency: grace + one poll.
            'detection_bound_s': (
                self.config.heartbeat_grace_s
                + self.config.heartbeat_interval_s
            ),
        }
        if self.config.heartbeat_dir is not None:
            path = os.path.join(
                self.config.heartbeat_dir, 'rank_death.json',
            )
            tmp = f'{path}.tmp-{os.getpid()}'
            try:
                with open(tmp, 'w') as fh:
                    json.dump(record, fh, indent=1, sort_keys=True)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
            except OSError:
                pass
        for hook in self._death_hooks:
            try:
                hook(dead)
            except Exception:  # noqa: BLE001 — abort anyway
                pass
        if self.config.abort_on_death:
            os._exit(EXIT_RANK_DEATH)

    # -- barriers --------------------------------------------------------

    def _store_sync(self, name: str) -> None:
        """The default barrier body: this rank's arrival added to the
        tag's counter on the store; the last to arrive sets the done key,
        which every rank waits for (the wait times out after the
        store's timeout at the latest; the caller's timeout is enforced
        by :meth:`barrier`)."""
        if self.store is None:
            raise RuntimeError(
                'no rendezvous store: initialize() the runtime (or pass '
                'sync= to barrier())',
            )
        if self.store.add(f'{name}/arrived', 1) == self.config.num_processes:
            self.store.set(f'{name}/done', '1')
        self.store.wait([f'{name}/done'])

    def barrier(
        self,
        tag: str,
        *,
        timeout_s: float | None = None,
        sync: Callable[[str], None] | None = None,
    ) -> None:
        """Named cross-process barrier with a hard timeout.

        Single-process worlds return at once.  If the heartbeats already
        name a dead peer, raises :class:`RankDeathError` *before* entering
        the barrier (entering would hang).  The sync runs on a daemon
        worker thread so this thread can enforce the timeout: on expiry
        raises :class:`BarrierTimeoutError` (the worker is abandoned; the
        caller is expected to abort the process, the only clean exit from
        a half-entered collective).  ``sync`` (default: the store barrier)
        is called with ``'kfac_runtime:<tag>/<n>'``, ``n`` counting the
        barriers of this tag.
        """
        if self.config.num_processes <= 1:
            return
        dead = self.dead_ranks()
        if dead:
            raise RankDeathError(
                f'barrier {tag!r}: peer rank(s) {list(dead)} are dead',
                dead,
            )
        if sync is None:
            sync = self._store_sync
        if timeout_s is None:
            timeout_s = self.config.barrier_timeout_s
        n = self._barrier_counts.get(tag, 0)
        self._barrier_counts[tag] = n + 1

        done = threading.Event()
        failure: list[BaseException] = []

        def _run() -> None:
            try:
                sync(f'kfac_runtime:{tag}/{n}')
            except BaseException as exc:  # noqa: BLE001 — re-raised
                failure.append(exc)
            finally:
                done.set()

        worker = threading.Thread(
            target=_run, name=f'kfac-barrier-{tag}', daemon=True,
        )
        worker.start()
        deadline = self._clock() + timeout_s
        poll = min(0.05, timeout_s / 4)
        while not done.is_set():
            if self._clock() >= deadline:
                dead = self.dead_ranks()
                if dead:
                    raise RankDeathError(
                        f'barrier {tag!r}: timed out after '
                        f'{timeout_s:.1f}s with dead peer(s) '
                        f'{list(dead)}',
                        dead,
                    )
                raise BarrierTimeoutError(
                    f'barrier {tag!r} timed out after {timeout_s:.1f}s',
                )
            done.wait(poll)
        if failure:
            raise failure[0]

    # -- teardown --------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the heartbeat and monitor threads (leaves the process
        group up, as the JAX runtime leaves ``jax.distributed`` up)."""
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(
                timeout=2 * self.config.heartbeat_interval_s + 1.0,
            )
            self._monitor = None
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if active() is self:
            install(None)


# ----------------------------------------------------------------------
# engine commit-point hook
# ----------------------------------------------------------------------

_active_runtime: DistributedRuntime | None = None


def install(runtime: DistributedRuntime | None) -> None:
    """Install (or clear, with None) the process-global runtime."""
    global _active_runtime
    _active_runtime = runtime


def active() -> DistributedRuntime | None:
    return _active_runtime


def commit_point(name: str, *, timeout_s: float | None = None) -> None:
    """Barrier-with-timeout at an engine commit point.

    Called by the engine at every cross-process commit: the elastic
    manifest write and stamp, the watchdog rollback, the consistency host
    sync.  A strict no-op unless a :class:`DistributedRuntime` is
    installed and the world spans several processes: single-process
    engines pay nothing and change nothing.
    """
    rt = _active_runtime
    if rt is None or rt.config.num_processes <= 1:
        return
    tracing.count_event('runtime_commit_point')
    rt.barrier(name, timeout_s=timeout_s)  # spmd: collective-safe(forwarding shim: every commit_point call site spells a literal registered tag)
