"""Fault injection for the engine, the part of ``storm_tpu/resilience``
that the port's engine reads."""

from storm_tpu_torch.resilience.chaos import ChaosInjector, get_injector

__all__ = ["ChaosInjector", "get_injector"]
