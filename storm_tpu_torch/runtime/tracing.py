"""Stage timing, trimmed from ``storm_tpu/runtime/tracing.py`` to
:func:`span`: a stage's wall time into the ``<name>_ms`` histogram of a
component. The reference's per-record traces, flight recorder and device
traces are not ported yet.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from storm_tpu_torch.runtime.metrics import MetricsRegistry


@contextlib.contextmanager
def span(metrics: Optional[MetricsRegistry], component: str, name: str) -> Iterator[None]:
    """Time a stage into the ``<name>_ms`` histogram of ``component``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if metrics is not None:
            metrics.histogram(component, f"{name}_ms").observe(
                (time.perf_counter() - t0) * 1e3)
