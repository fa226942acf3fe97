"""Preemption-safe training: catch SIGTERM, checkpoint, exit cleanly.

Counterpart of ``pointcloud_orientation_tpu/train/reliability.py``, pure
Python. :class:`PreemptionGuard` turns a termination signal into a flag
that :meth:`.trainer.Trainer.fit` and the lockstep protocols
(``train/ensemble.py``, ``train/multiseed.py``) poll at epoch or block
boundaries: the run saves a checkpoint (weights, BatchNorm statistics and
optimizer state) and returns normally, so that a relaunch resumes where it
stopped and reproduces the uninterrupted run bit for bit.

A second signal restores the previous handler's behaviour: a process wedged
in a call still dies on the second SIGTERM.
"""

from __future__ import annotations

import signal
from typing import Iterable, Optional


class PreemptionGuard:
    """Context manager: translate termination signals into a flag to poll.

    Usage::

        with PreemptionGuard() as guard:
            trainer.fit(checkpoint_dir=ckpt, preemption_guard=guard)

    The first caught signal sets :attr:`requested` and re-installs the
    previous handler (a second signal takes the previous behaviour, usually
    death). Handlers are always restored on exit. Outside the main thread
    no handler can be installed; the guard then works through
    :meth:`request` alone.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self.requested = False
        self.signum: Optional[int] = None

    def _handle(self, signum, frame):
        self.requested = True
        self.signum = signum
        self._restore()  # one-shot: a second signal reaches the previous handler

    def _restore(self):
        for signum, prev in self._previous.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):  # not the main thread, or a bad signal number
                pass
        self._previous = {}

    def request(self):
        """Set the flag from code (tests, an external watchdog)."""
        self.requested = True

    def __enter__(self) -> "PreemptionGuard":
        for signum in self._signals:
            try:
                self._previous[signum] = signal.signal(signum, self._handle)
            except ValueError:
                # handlers install only in the main thread: the guard then
                # works through request() alone instead of failing the run
                pass
        return self

    def __exit__(self, *exc):
        self._restore()
        return False
