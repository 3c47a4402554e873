"""Preemption-safe training: catch SIGTERM, checkpoint, resume (the port's
own copy of the JAX package's ``training/preemption.py``).

Batch schedulers preempt a job with SIGTERM and a grace window. Here the
signal sets a flag that the Trainer polls at step boundaries, the only safe
interruption points; the Trainer then saves a ``model_preempt`` checkpoint
to a *stable* path (the regular run directories are timestamped) and
returns. The next launch of the same (dataset, seed) auto-resumes from it
and deletes it on a clean finish. The handler is per process.
"""

from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Installs handlers for ``signals`` that set a flag instead of killing
    the process; chains to any previously-installed handler. ``install()``
    must run on the main thread (CPython restriction); polling ``triggered``
    is thread-safe and costs one Event check."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous = {}
        self._installed = False

    def install(self) -> "PreemptionGuard":
        if not self._installed:
            for s in self._signals:
                self._previous[s] = signal.getsignal(s)
                signal.signal(s, self._on_signal)
            self._installed = True
        return self

    def _on_signal(self, signum, frame):
        self._event.set()
        prev = self._previous.get(signum)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self):
        """Programmatic preemption (tests, cooperative shutdown)."""
        self._event.set()

    def restore(self):
        if self._installed:
            for s, prev in self._previous.items():
                signal.signal(s, prev)
            self._previous.clear()
            self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.restore()
        return False
