"""Trace-driven fleet load generation & the scenario scorecard, the
counterpart of ``storm_tpu/loadgen``.

- :mod:`storm_tpu_torch.loadgen.trace` — seeded deterministic workload
  traces (heavy-tailed tenants, diurnal waves, flash crowds, decode
  session waves; save/load/replay), byte-identical to storm_tpu's.
- :mod:`storm_tpu_torch.loadgen.scorecard` — per-cell targets, scoring,
  and the CLI table renderer.
- :mod:`storm_tpu_torch.loadgen.fleet` — the scenario x pattern matrix
  (``python -m storm_tpu_torch.loadgen.fleet``).
"""

from storm_tpu_torch.loadgen.trace import (Trace, TraceEvent, TraceSpec,
                                           generate, load_trace, replay)
from storm_tpu_torch.loadgen.scorecard import (CellTargets, render_table,
                                               score_cell)

__all__ = ["Trace", "TraceEvent", "TraceSpec", "generate", "load_trace",
           "replay", "CellTargets", "render_table", "score_cell"]
