"""Structured logging — the `tracing` subsystem equivalent.

The reference uses the `tracing` crate with a fmt subscriber at DEBUG under
`--log` (src/cli/runner.rs:269-273) and a GUI ring-buffer layer holding the
last 1000 events (src/gui/logging.rs:26-91). Equivalents here:

  * `init_logging(debug=...)` — console subscriber;
  * `RingBufferHandler` — bounded in-memory event buffer with the same
    LogEntry fields (level, timestamp, message, target), drainable by UIs;
  * `export_log(path)` — .sarpolog-style export (src/gui/models.rs:125-206).
"""
# A copy of sarpro_tpu/utils/logging.py, so that the port imports nothing of
# the JAX package; tests/test_torch_host_copies.py holds the two equal. Both
# log under "sarpro", so a ring of either package sees both packages' events.
from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import threading
from pathlib import Path

RING_CAPACITY = 1000  # reference: src/gui/logging.rs ring size


@dataclasses.dataclass
class LogEntry:
    level: str
    timestamp: str
    message: str
    target: str


class RingBufferHandler(logging.Handler):
    """Keeps the last RING_CAPACITY log events (reference: gui/logging.rs:26-91)."""

    def __init__(self, capacity: int = RING_CAPACITY):
        super().__init__()
        self._buf: collections.deque[LogEntry] = collections.deque(maxlen=capacity)
        self._lock2 = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        entry = LogEntry(
            level=record.levelname,
            timestamp=datetime.datetime.fromtimestamp(record.created).strftime(
                "%H:%M:%S.%f"
            )[:-3],
            message=record.getMessage(),
            target=record.name,
        )
        with self._lock2:
            self._buf.append(entry)

    def drain(self) -> list[LogEntry]:
        with self._lock2:
            out = list(self._buf)
            self._buf.clear()
        return out

    def snapshot(self) -> list[LogEntry]:
        with self._lock2:
            return list(self._buf)

    def export_log(self, path) -> None:
        """Write events as a .sarpolog-style text file
        (reference: gui/models.rs:125-206)."""
        lines = [
            f"[{e.timestamp}] {e.level:<5} {e.target}: {e.message}"
            for e in self.snapshot()
        ]
        Path(path).write_text("\n".join(lines) + "\n")


_ring: RingBufferHandler | None = None


def get_ring_handler() -> RingBufferHandler:
    global _ring
    if _ring is None:
        _ring = RingBufferHandler()
        logging.getLogger("sarpro").addHandler(_ring)
    return _ring


def init_logging(debug: bool = False) -> None:
    level = logging.DEBUG if debug else logging.INFO
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    logging.getLogger("sarpro").setLevel(level)
