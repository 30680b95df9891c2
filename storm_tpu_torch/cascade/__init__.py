"""The confidence-gated model cascade, copied from ``storm_tpu/cascade``.

``policy`` holds :class:`CascadeConfig` and the uncertainty math
(import-light: ``Config`` embeds it); ``router`` holds the runtime that
drives one shared engine per tier through the operator's dispatch path.
The router is loaded lazily, so importing ``storm_tpu_torch.config``
never pulls the engine stack in.
"""

from storm_tpu_torch.cascade.policy import (  # noqa: F401
    CONFIDENCE_METRICS, CascadeConfig, fit_temperature, uncertainty)

__all__ = ["CONFIDENCE_METRICS", "CascadeConfig", "CascadeRouter",
           "Escalated", "fit_temperature", "uncertainty"]


def __getattr__(name):
    if name in ("CascadeRouter", "Escalated"):
        from storm_tpu_torch.cascade import router

        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
