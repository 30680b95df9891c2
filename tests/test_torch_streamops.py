"""The port's stream operators (``storm_tpu_torch/runtime/window.py``,
``join.py``, ``event_time.py``) against storm_tpu's on the CPU: the same
inputs through each package's bolt give the same windows, acks, fails,
joined rows and event-time panes, late tuples included.

Windows and event time are driven standalone, through a recording
collector; joins run on each package's ``AsyncLocalCluster``.
"""

from __future__ import annotations

import asyncio
from types import SimpleNamespace

import pytest

import storm_tpu.config as jax_config
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.event_time as jax_event_time
import storm_tpu.runtime.join as jax_join
import storm_tpu.runtime.tuples as jax_tuples
import storm_tpu.runtime.window as jax_window
import storm_tpu_torch.config as port_config
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.event_time as port_event_time
import storm_tpu_torch.runtime.join as port_join
import storm_tpu_torch.runtime.tuples as port_tuples
import storm_tpu_torch.runtime.window as port_window

IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, runtime=jax_runtime,
                                 cluster=jax_cluster, event_time=jax_event_time,
                                 join=jax_join, tuples=jax_tuples, window=jax_window),
    "port": SimpleNamespace(name="port", config=port_config, runtime=port_runtime,
                            cluster=port_cluster, event_time=port_event_time,
                            join=port_join, tuples=port_tuples, window=port_window),
}


class _Collector:
    """Records acks, fails, errors and emits by the message of each tuple."""

    def __init__(self):
        self.acked, self.failed, self.errors, self.emitted = [], [], [], []

    def set_output_fields(self, fields):
        pass

    def ack(self, t):
        self.acked.append(t.values[0])

    def fail(self, t):
        self.failed.append(t.values[0])

    def report_error(self, e):
        self.errors.append(str(e))

    async def emit(self, values, stream="default", anchors=None, **kw):
        self.emitted.append((stream, list(values), sorted(a.values[0] for a in anchors or ())))
        return 1


def _tup(impl, msg, ts=None, src="s"):
    if ts is None:
        return impl.tuples.Tuple(values=[msg], fields=("message",), source_component=src)
    return impl.tuples.Tuple(values=[msg, ts], fields=("message", "ts"), source_component=src)


def _both(fn):
    """Run ``fn(impl)`` (a coroutine function) in each package; return the
    two results after checking they are equal."""
    got = {name: asyncio.run(asyncio.wait_for(fn(impl), 30)) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    return got["port"]


# ---- count and time windows -----------------------------------------------------


def _window_bolt(impl, fail_first=False, **kw):
    class Collect(impl.window.WindowedBolt):
        def __init__(self, **k):
            super().__init__(**k)
            self.windows = []
            self.boom = fail_first

        async def execute_window(self, tuples):
            if self.boom:
                self.boom = False
                raise RuntimeError("window boom")
            self.windows.append([t.get("message") for t in tuples])

    bolt = Collect(**kw)
    bolt.collector = _Collector()
    return bolt


@pytest.mark.parametrize("kw,n,want", [
    ({"window_count": 4}, 10, [["m0", "m1", "m2", "m3"], ["m4", "m5", "m6", "m7"], ["m8", "m9"]]),
    ({"window_count": 4, "slide_count": 2}, 6,
     [["m0", "m1"], ["m0", "m1", "m2", "m3"], ["m2", "m3", "m4", "m5"], ["m4", "m5"]]),
    ({"window_count": 3, "slide_count": 1}, 4,
     [["m0"], ["m0", "m1"], ["m0", "m1", "m2"], ["m1", "m2", "m3"], ["m2", "m3"]]),
])
def test_count_windows_alike(kw, n, want):
    """Tumbling and sliding count windows, the final partial window on
    flush, every tuple acked once at expiry, in the same order."""
    async def go(impl):
        bolt = _window_bolt(impl, **kw)
        acked_at = []
        for i in range(n):
            await bolt.execute(_tup(impl, f"m{i}"))
            acked_at.append(len(bolt.collector.acked))
        await bolt.flush()
        return bolt.windows, bolt.collector.acked, acked_at

    windows, acked, acked_at = _both(go)
    assert windows == want and sorted(acked) == sorted(f"m{i}" for i in range(n))


def test_window_failure_fails_the_buffer_alike():
    async def go(impl):
        bolt = _window_bolt(impl, fail_first=True, window_count=2)
        for i in range(5):
            await bolt.execute(_tup(impl, f"f{i}"))
        await bolt.flush()
        c = bolt.collector
        return bolt.windows, c.acked, c.failed, c.errors

    windows, acked, failed, errors = _both(go)
    assert failed == ["f0", "f1"] and acked == ["f2", "f3", "f4"] and errors == ["window boom"]
    assert windows == [["f2", "f3"], ["f4"]]


def test_time_windows_and_stalls_alike():
    """Time windows fire on ticks; a tuple the previous fire never saw
    rides a late window even past window_s, and a tuple aged past every
    future window is expiry-acked on an empty one."""
    async def go(impl):
        bolt = _window_bolt(impl, window_s=10.0, slide_s=5.0)
        assert bolt.tick_interval_s == 5.0
        await bolt.execute(_tup(impl, "x"))
        await bolt.tick()  # fires ["x"], keeps it (age < window - slide)
        kept = list(bolt.collector.acked)
        bolt._buf = type(bolt._buf)((t, ts - 60.0) for t, ts in bolt._buf)
        bolt._last_fire -= 30.0
        await bolt.tick()  # empty window; the trim acks "x"
        for m in ("y0", "y1"):
            await bolt.execute(_tup(impl, m))
        bolt._buf = type(bolt._buf)((t, ts - 100.0) for t, ts in bolt._buf)
        bolt._last_fire -= 200.0
        await bolt.tick()  # a late tick: the stalled tuples still window
        return bolt.windows, kept, bolt.collector.acked

    windows, kept, acked = _both(go)
    assert windows == [["x"], ["y0", "y1"]] and kept == [] and acked == ["x", "y0", "y1"]


def test_window_validation_alike():
    for impl in IMPLS.values():
        for kw in ({}, {"window_count": 4, "window_s": 1.0}, {"window_count": 4, "slide_count": 5},
                   {"window_s": 1.0, "slide_s": 2.0}):
            with pytest.raises(ValueError):
                impl.window.WindowedBolt(**kw)
        b = impl.window.TumblingWindowBolt(count=8)
        assert b.window_count == b.slide_count == 8
        assert impl.window.TumblingWindowBolt(duration_s=1.5).slide_s == 1.5


# ---- event time -------------------------------------------------------------------


def _event_bolt(impl, fail_window=None, **kw):
    class Panes(impl.event_time.EventTimeWindowBolt):
        def __init__(self, **k):
            super().__init__(**k)
            self.panes = []

        async def execute_window(self, tuples, start, end):
            if fail_window is not None and start == fail_window:
                raise RuntimeError(f"pane {start} boom")
            self.panes.append((start, end, [t.get("message") for t in tuples]))

    bolt = Panes(**kw)
    bolt.collector = _Collector()
    return bolt


@pytest.mark.parametrize("kw,events,late", [
    # tumbling, out of order within the lag (d), then behind it (e)
    ({"window_s": 10.0, "lag_s": 2.0},
     [("a", 1.0), ("b", 4.0), ("c", 12.5), ("d", 11.0), ("e", 9.5), ("f", 25.0)], ["e"]),
    # sliding: each tuple in two panes, acked at its last one
    ({"window_s": 10.0, "slide_s": 5.0, "lag_s": 0.0},
     [("a", 1.0), ("b", 6.0), ("c", 11.0), ("d", 16.0), ("e", 30.0)], []),
    # strictly behind the watermark is late; a tie with it is not
    ({"window_s": 5.0, "lag_s": 1.0},
     [("a", 1.0), ("b", 8.0), ("late", 2.0), ("c", 8.0), ("tie", 7.0), ("d", 20.0)], ["late"]),
    # float boundaries: 0.1 slides must not split one window in two
    ({"window_s": 0.3, "slide_s": 0.1, "lag_s": 0.0},
     [("a", 11.6), ("b", 11.7), ("c", 11.8), ("d", 12.5)], []),
])
def test_event_time_panes_alike(kw, events, late):
    """The same panes (start, end, members in event-time order), the same
    late-stream emits, acks and watermark, through the final flush."""
    async def go(impl):
        bolt = _event_bolt(impl, **kw)
        marks = []
        for msg, ts in events:
            await bolt.execute(_tup(impl, msg, ts))
            marks.append((bolt.watermark, len(bolt.collector.acked)))
        await bolt.flush()
        c = bolt.collector
        return bolt.panes, c.emitted, c.acked, marks

    panes, emitted, acked, marks = _both(go)
    assert sorted(acked) == sorted(m for m, _ in events)
    by_ts = dict(events)
    assert [e for e in emitted if e[0] == "late"] == [
        ("late", [[m, by_ts[m]], by_ts[m]], [m]) for m in late]
    in_panes = {m for p in panes for m in p[2]}
    assert in_panes == {m for m, _ in events} - set(late)
    for start, end, members in panes:
        assert end - start == pytest.approx(kw["window_s"])


def test_event_time_failure_idle_advance_and_refusals_alike():
    """A failing pane fails only its tuples; an idle stream's lag collapses
    on a tick; a tuple without its timestamp raises; bad knobs refuse."""
    async def go(impl):
        bolt = _event_bolt(impl, fail_window=0.0, window_s=10.0, lag_s=0.0)
        for msg, ts in (("a", 1.0), ("b", 2.0), ("c", 15.0), ("d", 31.0)):
            await bolt.execute(_tup(impl, msg, ts))
        idle = _event_bolt(impl, window_s=10.0, lag_s=100.0, idle_advance_s=0.01)
        await idle.execute(_tup(impl, "x", 3.0))
        await idle.execute(_tup(impl, "y", 12.0))
        await asyncio.sleep(0.03)
        await idle.tick()
        with pytest.raises(ValueError, match="lacks event-time field"):
            await bolt.execute(_tup(impl, "nots"))
        c = bolt.collector
        return (bolt.panes, c.failed, c.acked, c.errors, idle.panes, idle.watermark,
                idle.tick_interval_s)

    panes, failed, acked, errors, idle_panes, wm, tick = _both(go)
    assert failed == ["a", "b"] and acked == ["c"] and errors == ["pane 0.0 boom"]
    assert idle_panes == [(0.0, 10.0, ["x"])] and wm == 12.0 and tick == 0.005
    for impl in IMPLS.values():
        with pytest.raises(ValueError):
            impl.event_time.EventTimeWindowBolt(window_s=1.0, slide_s=2.0)
        with pytest.raises(ValueError):
            impl.event_time.EventTimeWindowBolt(window_s=1.0, lag_s=-1.0)


# ---- joins, on a running cluster ----------------------------------------------------


def _join_classes(impl):
    rt = impl.runtime

    class RowSpout(rt.Spout):
        def __init__(self, fields, rows):
            self.fields, self.rows = tuple(fields), [tuple(r) for r in rows]

        def clone(self):
            return RowSpout(self.fields, self.rows)

        def declare_output_fields(self):
            return {"default": self.fields}

        def open(self, context, collector):
            super().open(context, collector)
            self.queue = list(self.rows)
            self.acked, self.failed = [], []

        async def next_tuple(self):
            if not self.queue:
                return False
            row = self.queue.pop(0)
            await self.collector.emit(rt.Values(list(row)), msg_id=row)
            return True

        def ack(self, msg_id):
            self.acked.append(msg_id)

        def fail(self, msg_id):
            self.failed.append(msg_id)

    class Collect(rt.Bolt):
        rows = []

        async def execute(self, t):
            Collect.rows.append(tuple(t.values))
            self.collector.ack(t)

    return RowSpout, Collect


async def _run_join(impl, orders, payments, how, select):
    RowSpout, Collect = _join_classes(impl)
    want = len(orders) + len(payments)
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("orders", RowSpout(("user", "amount"), orders), 1)
    tb.set_spout("payments", RowSpout(("user", "method"), payments), 1)
    tb.set_bolt("join", impl.join.JoinBolt(on="user", streams=["orders", "payments"],
                                           select=list(select), how=how, window_count=want), 1) \
        .fields_grouping("orders", "user").fields_grouping("payments", "user")
    tb.set_bolt("collect", Collect(), 1).shuffle_grouping("join")
    cfg = impl.config.Config()
    cfg.topology.message_timeout_s = 300.0
    cluster = impl.cluster.AsyncLocalCluster()
    rt = await cluster.submit("join", cfg, tb.build())
    try:
        o = rt.spout_execs["orders"][0].spout
        p = rt.spout_execs["payments"][0].spout
        for _ in range(1500):
            if len(o.acked) + len(p.acked) >= want:
                break
            await asyncio.sleep(0.02)
        await rt.kill(wait_secs=10)
        return (sorted(Collect.rows, key=repr), sorted(o.acked, key=repr),
                sorted(p.acked, key=repr), o.failed + p.failed)
    finally:
        await cluster.shutdown()


@pytest.mark.parametrize("orders,payments,how,select,want", [
    ([("alice", 30), ("bob", 99), ("carol", 7)], [("alice", "card"), ("carol", "cash")],
     "inner", ("user", "orders.amount", "payments.method"),
     [("alice", 30, "card"), ("carol", 7, "cash")]),
    ([("alice", 30), ("bob", 99), (None, 42)], [("alice", "card")],
     "left", ("user", "orders.amount", "payments.method"),
     [("alice", 30, "card"), ("bob", 99, None), (None, 42, None)]),
    ([("alice", 1), ("alice", 2)], [("alice", "card"), ("alice", "cash")],
     "inner", ("user", "amount", "method"),
     [("alice", 1, "card"), ("alice", 1, "cash"), ("alice", 2, "card"), ("alice", 2, "cash")]),
])
def test_joins_alike(orders, payments, how, select, want):
    """Inner and left joins, per-key cartesian products and bare-field
    selection: the same rows from both packages, every input acked."""
    got = {name: asyncio.run(asyncio.wait_for(_run_join(impl, orders, payments, how, select), 60))
           for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    rows, o_acked, p_acked, failed = got["port"]
    assert rows == sorted(want, key=repr) and not failed
    assert len(o_acked) == len(orders) and len(p_acked) == len(payments)


def test_join_refusals_alike():
    for impl in IMPLS.values():
        J = impl.join.JoinBolt
        for kw, msg in (({"streams": ["only"], "select": ["k"]}, "two streams"),
                        ({"streams": ["a", "b"], "select": ["k"], "how": "outer"}, "inner|left"),
                        ({"streams": ["a", "b"], "select": ["a.x", "c.y"]}, "unknown stream"),
                        ({"streams": ["a", "a"], "select": ["k"]}, "duplicate stream")):
            with pytest.raises(ValueError, match=msg):
                J(on="k", window_count=4, **kw)
        b = J(on="k", streams=["a", "b"], select=["k", "a.x"], window_count=4)
        assert b.declare_output_fields() == {"default": ("k", "a_x")}
