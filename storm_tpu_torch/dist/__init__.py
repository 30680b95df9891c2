"""The distributed runtime, ported from ``storm_tpu/dist``: worker
processes and the tuple transport between them.

The reference scales across 8 Storm worker *processes*, with Netty moving
tuples between them and ZooKeeper/Nimbus coordinating. This package is
that half:

- :mod:`.worker`: a worker process hosting the executors of its assigned
  components; the inboxes of components on other workers are proxies, so
  the single-process ``OutputCollector`` routes unchanged across them;
- :mod:`.transport`: the tuple, ack and control envelopes over the
  standard library's TCP (storm_tpu uses gRPC; the payloads are the same
  bytes), with :mod:`.wire` the binary frames and :mod:`.shm` the
  shared-memory lane between workers on one host;
- :mod:`.controller`: the Nimbus-equivalent :class:`DistCluster`: spawns
  or attaches workers, ships config and placement, starts in two phases
  (bolts everywhere, then spouts), merges metrics, drains, kills and
  recovers dead workers;
- ack routing: every tuple id carries its origin worker in the top 8 bits
  (``runtime/tuples.py:set_worker_tag``), so XOR acks flow straight back
  to the owner of the root's ledger entry;
- :mod:`.ring`: the consistent-hash ring that routes decode sessions
  stickily.

Each worker owns its own CUDA context: on one card several workers share
it, each with its own engines and CUDA graphs.
"""

from storm_tpu_torch.dist.controller import DistCluster

__all__ = ["DistCluster"]
