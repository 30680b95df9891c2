"""The port's controller journal (``storm_tpu_torch/dist/journal.py``)
against storm_tpu's, on the CPU, with no process spawned.

- each case of ``tests/test_journal.py`` runs on both packages, side by
  side, with the same outcome;
- one seeded event sequence, journaled by each package, gives the same
  bytes (log and snapshot) and the same fold, and each package loads the
  other's journal and snapshot to that fold;
- the torn tail, the corrupt middle record, the tampered CRC and the
  unknown kind behave alike across the packages' journals;
- ``DistCluster.reconcile_parallelism`` agrees with storm_tpu's;
- ROADMAP C18: storm_tpu's journal of a mesh of 11 workers or more fails
  its own CRC on reload (int keys sort as numbers when stamped, as text
  when read back); the port's loads, and storm_tpu reads the port's.
"""

import json
import os

import numpy as np
import pytest

import storm_tpu.dist.journal as jax_journal
import storm_tpu_torch.dist.journal as port_journal

PACKAGES = {"storm_tpu": jax_journal, "port": port_journal}


@pytest.fixture(params=sorted(PACKAGES))
def jm(request):
    return PACKAGES[request.param]


def _seed(jm, d, snapshot_every=64):
    j = jm.ControllerJournal(str(d), snapshot_every=snapshot_every)
    j.append("workers", peers={0: "127.0.0.1:1", 1: "127.0.0.1:2"}, pids={0: 11, 1: 22})
    j.append("submit", name="topo", config={"k": 1}, builder="standard",
             placement={"spout": 0, "sink": 1})
    j.append("rebalance", component="infer", parallelism=4)
    j.append("activation", activated=False)
    return j


def _lines(d) -> list:
    with open(os.path.join(str(d), jm_file()), "rb") as f:
        return f.read().splitlines(keepends=True)


def jm_file() -> str:
    assert jax_journal.JOURNAL_FILE == port_journal.JOURNAL_FILE
    return port_journal.JOURNAL_FILE


# ---- tests/test_journal.py's cases, on each package ------------------------------


def test_roundtrip_fold(jm, tmp_path):
    _seed(jm, tmp_path).close()
    st = jm.ControllerJournal(str(tmp_path)).load()
    assert st.peers == {0: "127.0.0.1:1", 1: "127.0.0.1:2"}
    assert st.pids == {0: 11, 1: 22}
    assert st.recipe["name"] == "topo"
    assert st.placement == {"spout": 0, "sink": 1}
    assert st.rebalances == {"infer": 4}
    assert st.activated is False
    assert st.replayed == 4


def test_kill_resets_fold(jm, tmp_path):
    j = _seed(jm, tmp_path)
    j.append("kill")
    j.close()
    st = jm.ControllerJournal(str(tmp_path)).load()
    assert st.recipe is None and st.rebalances == {}


def test_torn_tail_tolerated(jm, tmp_path):
    _seed(jm, tmp_path).close()
    with open(os.path.join(str(tmp_path), jm_file()), "ab") as f:
        f.write(b'{"seq": 5, "kind": "rebalance", "da')  # a torn record
    j2 = jm.ControllerJournal(str(tmp_path))
    st = j2.load()
    assert st.replayed == 4
    assert j2.append("activation", activated=True) == 5
    j2.close()
    st2 = jm.ControllerJournal(str(tmp_path)).load()
    assert st2.activated is True and st2.replayed == 5


def test_corrupt_mid_log_raises(jm, tmp_path):
    _seed(jm, tmp_path).close()
    lines = _lines(tmp_path)
    assert len(lines) == 4
    lines[1] = lines[1][:10] + b"X" + lines[1][11:]
    with open(os.path.join(str(tmp_path), jm_file()), "wb") as f:
        f.writelines(lines)
    with pytest.raises(jm.JournalCorrupt):
        jm.ControllerJournal(str(tmp_path)).load()


def test_crc_rejects_tamper(jm, tmp_path):
    _seed(jm, tmp_path).close()
    lines = _lines(tmp_path)
    rec = json.loads(lines[-1])
    rec["data"]["activated"] = True  # the payload changed, the old crc kept
    lines[-1] = json.dumps(rec).encode() + b"\n"
    with open(os.path.join(str(tmp_path), jm_file()), "wb") as f:
        f.writelines(lines)
    st = jm.ControllerJournal(str(tmp_path)).load()
    assert st.replayed == 3 and st.activated is True  # the tail dropped


def test_snapshot_compaction_roundtrip(jm, tmp_path):
    j = jm.ControllerJournal(str(tmp_path), snapshot_every=4)
    j.append("workers", peers={0: "127.0.0.1:1"}, pids={0: 9})
    j.append("submit", name="t", config={}, builder="standard", placement={})
    for n in (2, 3, 4, 5, 6):
        j.append("rebalance", component="infer", parallelism=n)
        j.maybe_snapshot()
    assert j.stats()["snapshots"] >= 1
    assert os.path.exists(os.path.join(str(tmp_path), jm.SNAPSHOT_FILE))
    assert j.stats()["since_snapshot"] < 7
    j.close()
    st = jm.ControllerJournal(str(tmp_path)).load()
    assert st.rebalances == {"infer": 6}
    assert st.peers == {0: "127.0.0.1:1"}


def test_unknown_kind_ignored(jm):
    st = jm.ControlPlaneState()
    st.apply("hologram", {"x": 1})
    assert st.recipe is None


@pytest.mark.parametrize("pkg", ["storm_tpu", "port"])
def test_reconcile_parallelism(pkg):
    if pkg == "port":
        from storm_tpu_torch.dist.controller import DistCluster
    else:
        from storm_tpu.dist.controller import DistCluster
    rebalances = {"infer": 4, "sink": 2}
    placement = {"infer": 1, "sink": 2}
    reports = {1: {"parallelism": {"infer": 2}}, 2: {"parallelism": {"sink": 2}}}
    assert DistCluster.reconcile_parallelism(rebalances, placement, reports) == {"infer": 4}
    assert DistCluster.reconcile_parallelism({"infer": 4}, {"infer": 1}, {}) == {}


def test_reconcile_parallelism_agrees_on_seeded_cases():
    from storm_tpu.dist.controller import DistCluster as JaxCluster
    from storm_tpu_torch.dist.controller import DistCluster

    rng = np.random.RandomState(15)
    comps = ["spout", "infer", "sink", "dlq"]
    for _ in range(200):
        rebalances = {c: int(rng.randint(1, 5)) for c in comps if rng.rand() < 0.7}
        placement = {c: int(rng.randint(0, 3)) for c in comps if rng.rand() < 0.9}
        reports = {w: {"parallelism": {c: int(rng.randint(1, 5)) for c in comps
                                       if rng.rand() < 0.8}}
                   for w in range(3) if rng.rand() < 0.8}
        assert DistCluster.reconcile_parallelism(rebalances, placement, reports) == \
            JaxCluster.reconcile_parallelism(rebalances, placement, reports)


# ---- one seeded sequence through both packages -----------------------------------


def _events(seed: int, n: int = 40, workers: int = 4) -> list:
    """A seeded sequence of control-plane transitions (unknown kinds among
    them), worker indices below 10."""
    rng = np.random.RandomState(seed)
    comps = ["kafka-spout", "inference-bolt", "kafka-bolt", "dlq-bolt"]
    out = [("workers", {"peers": {i: f"127.0.0.1:{5000 + i}" for i in range(workers)},
                        "pids": {i: 100 + i for i in range(workers)}})]
    for _ in range(n):
        k = rng.randint(8)
        if k == 0:
            out.append(("submit", {"name": f"t{rng.randint(99)}",
                                   "config": {"batch": {"max_batch": int(rng.randint(1, 64)),
                                                        "buckets": [8, 32]}},
                                   "builder": "standard",
                                   "placement": {c: int(rng.randint(workers)) for c in comps}}))
        elif k == 1:
            out.append(("rebalance", {"component": comps[rng.randint(4)],
                                      "parallelism": int(rng.randint(1, 9))}))
        elif k == 2:
            out.append(("swap_model", {"component": "inference-bolt",
                                       "overrides": {"name": "lenet5",
                                                     "dtype": ["float32", "bfloat16"][rng.randint(2)]}}))
        elif k == 3:
            i = int(rng.randint(workers))
            out.append(("peer_update", {"idx": i, "addr": f"127.0.0.1:{6000 + rng.randint(999)}",
                                        "pid": int(rng.randint(1000, 9999))}))
        elif k == 4:
            out.append(("activation", {"activated": bool(rng.randint(2))}))
        elif k == 5:
            out.append(("kill", {}))
        elif k == 6:
            out.append(("hologram", {"x": int(rng.randint(9))}))
        else:
            out.append(("rebalance", {"component": "inference-bolt",
                                      "parallelism": int(rng.randint(1, 9))}))
    return out


def _journal_seq(jm, d, events, snapshot_every=0):
    j = jm.ControllerJournal(str(d), snapshot_every=snapshot_every)
    for kind, data in events:
        j.append(kind, **data)
        j.maybe_snapshot()
    stats = j.stats()
    j.close()
    return stats


def _read(d, name) -> bytes:
    path = os.path.join(str(d), name)
    return open(path, "rb").read() if os.path.exists(path) else b""


@pytest.mark.parametrize("snapshot_every", [0, 7])
def test_seeded_sequence_same_bytes_and_fold(tmp_path, snapshot_every):
    events = _events(15)
    dirs = {p: tmp_path / p for p in PACKAGES}
    stats = {p: _journal_seq(m, dirs[p], events, snapshot_every) for p, m in PACKAGES.items()}
    assert stats["port"] == stats["storm_tpu"]
    for name in (jax_journal.JOURNAL_FILE, jax_journal.SNAPSHOT_FILE):
        assert _read(dirs["port"], name) == _read(dirs["storm_tpu"], name), name
    if snapshot_every:
        assert _read(dirs["port"], jax_journal.SNAPSHOT_FILE)
    folds = {}
    for reader, m in PACKAGES.items():
        for writer in PACKAGES:
            st = m.ControllerJournal(str(dirs[writer])).load()
            folds[(reader, writer)] = (st.to_dict(), st.replayed)
    assert len({json.dumps(v, sort_keys=True) for v in folds.values()}) == 1, folds
    assert folds[("port", "port")][0]["seq"] == len(events)


def test_each_loads_the_others_damage_alike(tmp_path):
    """The other package's journal, torn at its tail, tampered in its last
    record, or corrupt in its middle: both loaders answer the same."""
    events = _events(16, n=12)
    for writer, wm in PACKAGES.items():
        base = tmp_path / writer
        _journal_seq(wm, base, events)
        lines = _lines(base)
        cases = {
            "torn": lines + [b'{"seq": 99, "kind": "rebal'],
            "tamper": lines[:-1] + [lines[-1].replace(b'"seq":', b'"seq": ', 1)
                                    .replace(b'"crc":', b'"crc":1', 1)],
            "middle": lines[:3] + [lines[3][:12] + b"#" + lines[3][13:]] + lines[4:],
        }
        for name, body in cases.items():
            d = tmp_path / f"{writer}-{name}"
            d.mkdir()
            with open(os.path.join(str(d), jm_file()), "wb") as f:
                f.writelines(body)
            got = {}
            for reader, m in PACKAGES.items():
                try:
                    st = m.ControllerJournal(str(d)).load()
                    got[reader] = ("ok", st.replayed, json.dumps(st.to_dict(), sort_keys=True))
                except m.JournalCorrupt as e:
                    got[reader] = ("corrupt", type(e).__name__)
            assert got["port"] == got["storm_tpu"], (writer, name, got)
            want = "corrupt" if name == "middle" else "ok"
            assert got["port"][0] == want, (writer, name, got)


def test_c18_wide_mesh_journal(tmp_path):
    """ROADMAP C18: a journal naming workers 0..11. storm_tpu's own fails
    its CRC on reload; the port's folds, in both packages."""
    peers = {i: f"127.0.0.1:{7000 + i}" for i in range(12)}
    pids = {i: 200 + i for i in range(12)}
    dirs = {p: tmp_path / p for p in PACKAGES}
    for p, m in PACKAGES.items():
        j = m.ControllerJournal(str(dirs[p]))
        j.append("workers", peers=peers, pids=pids)
        j.append("activation", activated=False)
        j.close()
    with pytest.raises(jax_journal.JournalCorrupt):
        jax_journal.ControllerJournal(str(dirs["storm_tpu"])).load()
    for m in PACKAGES.values():
        st = m.ControllerJournal(str(dirs["port"])).load()
        assert st.peers == peers and st.pids == pids and st.activated is False
    # the snapshot too: storm_tpu stamps its int-keyed fold
    j = port_journal.ControllerJournal(str(dirs["port"]))
    j.load()
    j.snapshot()
    j.close()
    for m in PACKAGES.values():
        assert m.ControllerJournal(str(dirs["port"])).load().peers == peers


def test_state_round_trips_through_dict():
    events = _events(17)
    sts = {}
    for p, m in PACKAGES.items():
        st = m.ControlPlaneState()
        for kind, data in events:
            st.apply(kind, json.loads(json.dumps(data)))
        again = m.ControlPlaneState.from_dict(json.loads(json.dumps(st.to_dict())))
        assert again.to_dict() == st.to_dict()
        sts[p] = st.to_dict()
    assert sts["port"] == sts["storm_tpu"]
    assert port_journal.KINDS == jax_journal.KINDS


def test_snapshot_every_validated():
    for m in PACKAGES.values():
        with pytest.raises(ValueError):
            m.ControllerJournal("/nonexistent-never-created", snapshot_every=-1)
