"""The runtime chaos monkey, copied from ``storm_tpu/runtime/chaos.py``:
fault injection for supervision and replay tests.

- :meth:`ChaosMonkey.crash_bolt` and :meth:`ChaosMonkey.crash_spout` kill
  a live executor's task the way a framework bug would: the injected
  :class:`ChaosCrash` derives from ``BaseException``, so the executor's
  ``except Exception`` (which turns a user error into a failed tuple)
  does not catch it. The task dies, and the supervisor's sweep must find
  and replace it.
- The tuples in flight on the crashed executor come back through the ack
  ledger's timeout and the spout's replay.
- :meth:`ChaosMonkey.run` kills a random executor at an interval.

It reaches into live executors; no serving path imports it. The engine's
fault injector (:mod:`storm_tpu_torch.resilience.chaos`) is another
thing.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional


class ChaosCrash(BaseException):
    """Injected executor death. BaseException on purpose: user-code errors
    (Exception) are caught and turn into tuple failures; this must not be."""


class ChaosMonkey:
    def __init__(self, runtime, seed: int = 0) -> None:
        self.rt = runtime
        self.rng = random.Random(seed)
        self.kills = 0

    # ---- targeted injection --------------------------------------------------

    def crash_bolt(self, component_id: str, index: int = 0) -> None:
        """Kill bolt executor ``component_id[index]`` on its next tuple."""
        e = self.rt.bolt_execs[component_id][index]

        async def boom(_t):
            raise ChaosCrash(f"chaos: {component_id}[{index}]")

        e.bolt.execute = boom
        self.kills += 1
        self._flight("bolt", component_id, index)

    def crash_spout(self, component_id: str, index: int = 0) -> None:
        """Kill spout executor ``component_id[index]`` on its next pull."""
        e = self.rt.spout_execs[component_id][index]

        async def boom():
            raise ChaosCrash(f"chaos: {component_id}[{index}]")

        e.spout.next_tuple = boom
        self.kills += 1
        self._flight("spout", component_id, index)

    def _flight(self, kind: str, component_id: str, index: int) -> None:
        """Each injection lands in the flight recorder as a
        ``chaos_injection`` event, beside the restarts and replays it
        causes."""
        flight = getattr(self.rt, "flight", None)
        if flight is not None:
            flight.event("chaos_injection", target=kind,
                         component=component_id, task=index,
                         kills=self.kills)

    def crash_random(self) -> str:
        """Kill one uniformly-random executor; returns its id."""
        targets = [
            ("bolt", cid, i)
            for cid, execs in self.rt.bolt_execs.items()
            for i in range(len(execs))
        ] + [
            ("spout", cid, i)
            for cid, execs in self.rt.spout_execs.items()
            for i in range(len(execs))
        ]
        kind, cid, i = self.rng.choice(targets)
        if kind == "bolt":
            self.crash_bolt(cid, i)
        else:
            self.crash_spout(cid, i)
        return f"{cid}[{i}]"

    # ---- soak loop -----------------------------------------------------------

    async def run(
        self,
        duration_s: float,
        interval_s: float = 0.5,
        components: Optional[list] = None,
    ) -> int:
        """Kill a random executor every ``interval_s`` for ``duration_s``.
        Restricts targets to ``components`` when given. Returns kill count."""
        end = asyncio.get_event_loop().time() + duration_s
        while asyncio.get_event_loop().time() < end:
            await asyncio.sleep(interval_s)
            if components:
                cid = self.rng.choice(components)
                if cid in self.rt.bolt_execs:
                    self.crash_bolt(
                        cid, self.rng.randrange(len(self.rt.bolt_execs[cid]))
                    )
                else:
                    self.crash_spout(
                        cid, self.rng.randrange(len(self.rt.spout_execs[cid]))
                    )
            else:
                self.crash_random()
        return self.kills
