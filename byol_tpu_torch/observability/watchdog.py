"""Progress watchdog (counterpart of byol_tpu/observability/watchdog.py).

A wedged card, a lost NCCL peer or a stuck host copy shows up on the host
as a readback that never returns.  The watchdog arms a deadline around
each such window (the epoch's synchronise and metric readback, eval, the
checkpoint write): if no progress is reported within ``timeout_s``, every
thread's stack is dumped, so the operator sees where the run hangs, and
with ``exit=True`` the process dies nonzero for the scheduler to requeue.

Built on ``faulthandler.dump_traceback_later``: it fires even while the
main thread is blocked inside a CUDA call, and dumps the blocked frame.
"""
from __future__ import annotations

import faulthandler
import sys
from typing import Optional, TextIO


class Watchdog:
    """``pet()`` before each potentially blocking region; if the next
    ``pet()`` or ``stop()`` does not arrive within ``timeout_s``, all thread
    stacks go to ``file`` (stderr by default) and, with ``exit=True``, the
    process exits nonzero.  ``timeout_s <= 0`` disables it."""

    def __init__(self, timeout_s: float, *, exit: bool = True,
                 file: Optional[TextIO] = None) -> None:
        self.timeout_s = float(timeout_s)
        self.exit = exit
        self.file = file if file is not None else sys.stderr
        self._armed = False

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def pet(self) -> None:
        """Report liveness; (re)arms the deadline."""
        if not self.enabled:
            return
        faulthandler.dump_traceback_later(
            self.timeout_s, repeat=False, file=self.file, exit=self.exit)
        self._armed = True

    def stop(self) -> None:
        """Disarm (end of training / controlled shutdown)."""
        if self._armed:
            faulthandler.cancel_dump_traceback_later()
            self._armed = False

    def __enter__(self) -> "Watchdog":
        self.pet()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
