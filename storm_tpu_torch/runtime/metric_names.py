"""The port's metric-name registry: GENERATED, do not edit by hand.

Regenerate after adding or renaming a metric::

    python -m storm_tpu_torch.runtime.metric_registry

Literal names of every ``counter``/``gauge``/``histogram`` call in
``storm_tpu_torch/`` land in ``METRIC_NAMES``; f-string names give a
wildcard pattern in ``METRIC_PATTERNS``. ``runtime/metrics.py`` warns once
for a name that matches neither.
"""

from __future__ import annotations

import fnmatch

METRIC_NAMES = frozenset({
    'ack_rate',
    'acked',
    'batch_fill',
    'batch_size',
    'batch_wait_ms',
    'burn_rate',
    'burn_rate_slow',
    'busy_frac',
    'capacity',
    'cascade_budget_capped',
    'cascade_escalations',
    'cascade_shed_pinned',
    'checkpoints',
    'coalesced_sources',
    'copies_amplification',
    'dead_lettered',
    'delivered',
    'device_ms',
    'dispatch_wait_ms',
    'dropped_stale',
    'e2e_latency_ms',
    'emitted',
    'engine_quarantined',
    'errors',
    'escalation_rate',
    'execute_ms',
    'execute_rate',
    'executed',
    'executor_restarts',
    'failed',
    'flush_frac',
    'inbox_depth',
    'ingest_lag_ms',
    'instances_inferred',
    'produce_ms',
    'profile_regressions',
    'shed_decisions',
    'shed_degraded',
    'shed_level',
    'shed_rejected',
    'slo_breaches',
    'spout_records_behind',
    'tree_acked',
    'tree_failed',
    'tripped',
    'txn_aborts',
    'txn_commits',
    'txn_offsets_deferred',
    'wait_frac',
    'watchdog_trips',
})

METRIC_PATTERNS = (
    '*_ms',
    'admitted_*',
    'admitted_lane_*',
    'bottleneck_score_*',
    'cascade_accepted_tier*',
    'cascade_decided_lane_*',
    'cascade_escalated_lane_*',
    'copies_bytes_per_rec_*',
    'copies_per_rec_*',
    'e2e_latency_ms_*',
    'edge_depth_*',
    'edge_growth_*',
    'fair_rows_*_*',
    'fair_starved_*_*',
    'queue_depth_*',
    'queue_oldest_ms_*',
    'ring_capacity_*',
    'ring_inflight_*',
    'shed_*',
    'shed_lane_*',
    'staging_in_use_*',
    'throttled_*',
    'throttled_lane_*',
    'tier*_device_ms',
)


def is_known(name: str) -> bool:
    if name in METRIC_NAMES:
        return True
    return any(fnmatch.fnmatchcase(name, p) for p in METRIC_PATTERNS)
