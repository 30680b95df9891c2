"""What the served path costs, copied from ``storm_tpu/obs/`` in part:

- :mod:`storm_tpu_torch.obs.profile`: :class:`ProfileStore`, per-(engine,
  bucket) stage-cost curves and the cold-build cost per shape, fed by the
  engine layer's profile sink;
- :mod:`storm_tpu_torch.obs.copyledger`: :class:`CopyLedger`, the bytes
  and copies of each hop of the record path.

storm_tpu's ``Observatory`` (the SLO burn tracker, capacity and
bottleneck attribution, the regression sentinel's control loop) is not
ported yet.
"""

from __future__ import annotations

from storm_tpu_torch.obs import copyledger
from storm_tpu_torch.obs.copyledger import CopyLedger, copy_ledger
from storm_tpu_torch.obs.profile import (
    ProfileStore,
    ensure_installed,
    profile_store,
    set_enabled,
)

__all__ = [
    "CopyLedger",
    "ProfileStore",
    "copy_ledger",
    "copyledger",
    "ensure_installed",
    "profile_store",
    "set_enabled",
]
