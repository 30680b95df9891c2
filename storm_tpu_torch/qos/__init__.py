"""Admission control and QoS under overload, copied from ``storm_tpu/qos``:

- :mod:`storm_tpu_torch.qos.admission`: tenant/lane classification from
  the broker key (``tenant:lane``) and per-tenant token buckets at the
  spout edge;
- :mod:`storm_tpu_torch.qos.lanes`: earliest-deadline-first batch
  formation for the inference operator;
- :mod:`storm_tpu_torch.qos.shedding`: the hysteresis load-shed
  controller, which publishes its level as the gauge
  ``("qos", "shed_level")`` for the spout and the operator to read.

Wired by :class:`storm_tpu_torch.config.QosConfig`. The shed controller
records each decision as a ``shed_decision`` flight event, and takes the
observatory's SLO burn tracker as an extra hot signal
(``shedder.burn = observatory.burn``). ``QosConfig.degrade_model`` serves
shed lanes on a cheaper model through the operator's cascade.
"""

from storm_tpu_torch.qos.admission import AdmissionController, TokenBucket
from storm_tpu_torch.qos.lanes import LaneBatcher
from storm_tpu_torch.qos.shedding import LoadShedController, ShedPolicy

__all__ = ["AdmissionController", "LaneBatcher", "LoadShedController", "ShedPolicy",
           "TokenBucket"]
