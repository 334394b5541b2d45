"""Live training progress display (``holocron_tpu/trainer/_progress.py``).

The reference drives fastprogress master/child bars around its epoch loop
(reference trainer/core.py:299-306). This is a zero-dependency analog: one
``\\r``-refreshed line showing step, it/s, the (lagged) loss and an ETA.

Silent by default when stderr is not a TTY, so CI and batch logs stay clean;
``HOLOCRON_PROGRESS=1`` forces it on (e.g. piped notebooks), ``=0`` forces it off.
Rendering is rate-limited to ~10 Hz so the display never competes with the
dispatch loop (a render is a single write).
"""

import os
import sys
import time
from typing import Optional, TextIO

__all__ = ["ProgressBar"]


class ProgressBar:
    def __init__(
        self,
        total: Optional[int] = None,
        desc: str = "",
        refresh_hz: float = 10.0,
        stream: Optional[TextIO] = None,
    ) -> None:
        self.stream = stream if stream is not None else sys.stderr
        force = os.environ.get("HOLOCRON_PROGRESS")
        isatty = getattr(self.stream, "isatty", lambda: False)()
        self.enabled = force == "1" or (force != "0" and isatty)
        self.total = total
        self.desc = desc
        self.n = 0
        self.loss: Optional[float] = None
        self._t0 = time.perf_counter()
        self._last_render = 0.0
        self._interval = 1.0 / refresh_hz
        self._closed = False

    def update(self, n: int = 1, loss: Optional[float] = None) -> None:
        self.n += n
        if loss is not None:
            self.loss = loss
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last_render >= self._interval:
            self._last_render = now
            self._render(now)

    def _line(self, now: float) -> str:
        elapsed = max(now - self._t0, 1e-9)
        rate = self.n / elapsed
        parts = [self.desc] if self.desc else []
        if self.total:
            frac = min(self.n / self.total, 1.0)
            width = 20
            filled = int(frac * width)
            bar = "#" * filled + "-" * (width - filled)
            parts.append(f"[{bar}] {self.n}/{self.total}")
            if rate > 0 and self.n < self.total:
                parts.append(f"eta {self._fmt_s((self.total - self.n) / rate)}")
        else:
            parts.append(f"step {self.n}")
        parts.append(f"{rate:.1f} it/s")
        if self.loss is not None:
            parts.append(f"loss {self.loss:.4f}")
        return " | ".join(parts)

    @staticmethod
    def _fmt_s(seconds: float) -> str:
        seconds = int(seconds)
        if seconds >= 3600:
            return f"{seconds // 3600}h{(seconds % 3600) // 60:02d}m"
        if seconds >= 60:
            return f"{seconds // 60}m{seconds % 60:02d}s"
        return f"{seconds}s"

    def _render(self, now: float) -> None:
        self.stream.write("\r\x1b[K" + self._line(now))
        self.stream.flush()

    def close(self, final: bool = True) -> None:
        """Renders the final state and moves to a fresh line (once)."""
        if self._closed or not self.enabled:
            self._closed = True
            return
        self._closed = True
        if final:
            self._render(time.perf_counter())
            self.stream.write("\n")
            self.stream.flush()
