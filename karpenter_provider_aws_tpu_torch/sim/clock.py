"""The clock seam of the mesh group's regroup timers (the reference's
``sim/clock.py``, only ``monotonic_of`` and the ``Clock`` protocol it
accepts)."""

from __future__ import annotations

import time
from typing import Callable


class Clock:
    """A clock: ``monotonic()`` interval time, ``time()`` wall time. A
    subclass (a simulated clock) overrides both."""

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()


def monotonic_of(clock) -> Callable[[], float]:
    """The read-only coercion: None -> time.monotonic, a Clock -> its
    bound monotonic, a bare ``() -> float`` callable -> itself."""
    if clock is None:
        return time.monotonic
    if isinstance(clock, Clock):
        return clock.monotonic
    if callable(clock):
        return clock
    raise TypeError(f"not a clock: {clock!r}")
