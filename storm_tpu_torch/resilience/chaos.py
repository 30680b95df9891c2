"""The process-wide fault injector, trimmed from
``storm_tpu/resilience/chaos.py`` to its engine knob: a one-shot engine
hang. Armed, the next ``engine_hang_next`` dispatched batches hold their
results ``engine_hang_ms`` before they report ready, so the fetch ring's
watchdog (``BatchConfig.watchdog_ms``) has a stuck batch to catch without
wedging a real program on the card. The wire, frame-corruption and
controller knobs belong to the distributed runtime, which the port does
not have yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

_KNOBS = ("engine_hang_ms", "engine_hang_next")


class ChaosInjector:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.engine_hang_ms = 0.0
        self.engine_hang_next = 0  # one-shot budget
        self.counts: Dict[str, int] = {}

    def configure(self, **knobs: Any) -> Dict[str, Any]:
        """Set any subset of the knobs; an unknown name raises (an
        injection must not be silently ignored for a typo)."""
        with self._lock:
            for name, value in knobs.items():
                if name not in _KNOBS:
                    raise ValueError(f"unknown chaos knob {name!r}")
                cur = getattr(self, name)
                setattr(self, name, type(cur)(value) if value is not None else cur)
            return {k: getattr(self, k) for k in _KNOBS}

    def engine_hang_s(self) -> float:
        """Hold for the NEXT dispatched batch (0 = no injection); consumes
        one unit of the one-shot budget per call."""
        with self._lock:
            if self.engine_hang_next <= 0 or self.engine_hang_ms <= 0:
                return 0.0
            self.engine_hang_next -= 1
            self.counts["engine_hang"] = self.counts.get("engine_hang", 0) + 1
            return self.engine_hang_ms / 1e3


_INJECTOR = ChaosInjector()


def get_injector() -> ChaosInjector:
    return _INJECTOR
