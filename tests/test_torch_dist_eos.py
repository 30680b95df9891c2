"""Exactly-once across the port's worker processes on the CPU (after
``tests/test_dist.py``'s offsets-in-transaction and worker-kill tests):
the spout under the ``txn`` policy on w0, lenet5 float32 inference on w1,
the ``TransactionalBrokerSink``s on w2, over the port's Kafka stub and its
wire broker's ``KafkaTxn``. Tuple origins cross both hops, and the sink
commits the consumed offsets inside each producer transaction.

- A clean run: a ``read_committed`` read of the output holds each of 12
  seeded digits records exactly once, every prediction within 1e-5 of
  storm_tpu's engine forward of its record, and the group's offsets stand
  at the input log's end.
- The inference worker SIGKILLed mid-stream, the heartbeat monitor
  replacing it: after the replays, the ``read_committed`` read still
  holds each input exactly once (a replay may abort a transaction, never
  commit a record twice), the offsets at the log's end.

Worker processes get one intra-op thread each and bind port 0; every
cluster and stub is shut down in a ``finally``.
"""

import json
import time

import numpy as np

from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import OffsetsConfig, SinkConfig
from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from storm_tpu_torch.dist import DistCluster
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_dist import (PLACEMENT, WORKER_ENV, _dist_config, _ref_groups,
                                   _storm_tpu_forward)

GROUP = "dist-eos"
N = 12
TOL = 1e-5


def _eos_config(bootstrap: str, timeout_s: float):
    cfg = _dist_config(bootstrap, timeout_s=timeout_s)
    cfg.broker.message_format = "v2"
    cfg.offsets = OffsetsConfig(policy="txn", group_id=GROUP, max_behind=None)
    cfg.sink = SinkConfig(mode="transactional", txn_batch=4, txn_ms=30.0, offsets_group=GROUP)
    cfg.topology.inference_parallelism = 1
    return cfg


def _committed_rows(bootstrap: str) -> np.ndarray:
    rc = KafkaWireBroker(bootstrap, message_format="v2", isolation="read_committed")
    try:
        vals = []
        for p in range(2):
            off = 0
            while True:
                batch = rc.fetch("output", p, off, max_records=500)
                if not batch:
                    break
                vals += [r.value for r in batch]
                off = batch[-1].offset + 1
    finally:
        rc.close()
    if not vals:
        return np.zeros((0, 10), np.float32)
    return np.concatenate([decode_predictions(v).data for v in vals])


def _audit(rows: np.ndarray, ref: np.ndarray) -> None:
    """Each input exactly once: every row within TOL of one forward, and
    each group of indistinguishable forwards answered as often as it has
    records."""
    assert len(rows) == len(ref), f"read_committed holds {len(rows)} rows for {len(ref)} inputs"
    err = np.abs(rows[:, None] - ref[None]).max(-1)
    assert err.min(1).max() < TOL
    groups = _ref_groups(ref, TOL)
    assert (np.bincount(groups[err.argmin(1)], minlength=len(ref))
            == np.bincount(groups, minlength=len(ref))).all()


def _run(kill: bool) -> None:
    from storm_tpu_torch.data import load_digits_nhwc

    xs = load_digits_nhwc((32, 32, 1))[2][:N]
    ref = _storm_tpu_forward(xs)
    stub = KafkaStubBroker(partitions=2)
    stub.log_transactional = True  # records land at once, EndTxn writes a marker
    bootstrap = f"127.0.0.1:{stub.port}"
    producer = KafkaWireBroker(bootstrap, message_format="v2")
    cluster = None

    def produce(lo, hi):
        for i in range(lo, hi):
            producer.produce("input", json.dumps({"instances": xs[i:i + 1].tolist()}).encode(),
                             partition=i % 2)

    def wait_rows(n, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline and len(_committed_rows(bootstrap)) < n:
            time.sleep(0.2)

    try:
        cluster = DistCluster(3, device="cpu", env=WORKER_ENV, worker_threads=1)
        # Trees stranded in a killed worker replay after the message timeout.
        cluster.submit("eos", _eos_config(bootstrap, timeout_s=8.0 if kill else 30.0),
                       placement=PLACEMENT)
        if kill:
            cluster.start_monitor(interval_s=0.5, misses=2)
            produce(0, N // 2)
            wait_rows(2, 90)
            assert len(_committed_rows(bootstrap)) >= 2
            old = cluster.procs[1].pid
            cluster.procs[1].kill()
            produce(N // 2, N)
            wait_rows(N, 180)
            cluster.stop_monitor()
            assert cluster.procs[1].pid != old, "the inference worker was not replaced"
            assert any(e["kind"] == "dist_worker_recovered" for e in cluster.flight.tail(200))
        else:
            produce(0, N)
            wait_rows(N, 90)
        assert cluster.drain(timeout_s=60)
        _audit(_committed_rows(bootstrap), ref)
        committed = {p: producer.committed(GROUP, "input", p) for p in (0, 1)}
        assert committed == {p: producer.latest_offset("input", p) for p in (0, 1)} \
            == {0: N // 2, 1: N // 2}, committed
        snap = cluster.metrics()
        assert snap["kafka-bolt"]["txn_commits"] >= 1
        if not kill:
            assert snap["kafka-spout"].get("tree_failed", 0) == 0
            assert snap["kafka-spout"]["tree_acked"] >= 1
        cluster.kill()
    finally:
        producer.close()
        if cluster is not None:
            cluster.shutdown()
        stub.close()


def test_exactly_once_across_workers_clean_run(abstract_init):
    _run(kill=False)


def test_exactly_once_across_a_killed_inference_worker(abstract_init):
    _run(kill=True)
