"""Host-side synchronization primitives (reference ``source/os/`` layer; copy
of ``mvslam_tpu.utils.sync``).

The reference wraps pthread for its render threads: a recursive
priority-inheritance ``Mutex`` + RAII ``Lock`` (``os/mutex.hpp:9-51``,
``os/mutex.cpp:6-43``) and a CLOCK_MONOTONIC condvar ``Event`` with
``trigger_all`` broadcast and timed waits (``os/event.hpp:9-27``,
``os/event.cpp:8-64``). The device pipeline needs none of this, but the
host runtime around it — render threads, async dispatch queues — keeps the
same primitives, mapped onto Python ``threading`` (whose locks are
monotonic-clock based on Linux).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class Mutex:
    """Recursive mutex (reference ``os/mutex.cpp:29`` chooses recursive)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()

    def lock(self) -> None:
        self._lock.acquire()

    def unlock(self) -> None:
        self._lock.release()

    # context-manager protocol = the reference's RAII ``Lock``
    def __enter__(self) -> "Mutex":
        self.lock()
        return self

    def __exit__(self, *exc) -> None:
        self.unlock()


@contextmanager
def Lock(mutex: Mutex):
    """RAII lock over a :class:`Mutex` (reference ``os/mutex.hpp:32-51``)."""
    mutex.lock()
    try:
        yield mutex
    finally:
        mutex.unlock()


class Event:
    """Broadcast condition event (reference ``os/event.cpp:8-64``).

    ``wait`` blocks until triggered; ``wait_timeout`` returns False on
    timeout; ``trigger_all`` wakes every waiter (pthread broadcast).
    Each trigger is consumed by the wait that observes it (the reference
    resets its flag on wake).
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._generation = 0

    def trigger_all(self) -> None:
        with self._cond:
            self._generation += 1
            self._cond.notify_all()

    def wait(self) -> None:
        with self._cond:
            gen = self._generation
            while self._generation == gen:
                self._cond.wait()

    def wait_timeout(self, timeout_ms: float) -> bool:
        deadline_gen_seen = False
        with self._cond:
            gen = self._generation
            deadline_gen_seen = self._cond.wait_for(
                lambda: self._generation != gen, timeout=timeout_ms / 1000.0
            )
        return bool(deadline_gen_seen)
