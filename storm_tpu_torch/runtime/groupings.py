"""Stream groupings, copied from ``storm_tpu/runtime/groupings.py`` for
the one the served topology uses: how an emitted tuple picks a downstream
executor instance."""

from __future__ import annotations

import random
from typing import Sequence

from storm_tpu_torch.runtime.tuples import Tuple


class Grouping:
    """Chooses target instance indices among ``n`` downstream executors."""

    def prepare(self, n: int) -> None:
        self.n = n

    def choose(self, t: Tuple) -> Sequence[int]:
        raise NotImplementedError


class ShuffleGrouping(Grouping):
    """Round-robin from a random start: uniform load, no key affinity."""

    def prepare(self, n: int) -> None:
        self.n = n
        self._i = random.randrange(n) if n else 0

    def choose(self, t: Tuple) -> Sequence[int]:
        self._i = (self._i + 1) % self.n
        return (self._i,)
