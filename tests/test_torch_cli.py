"""The port's command line and config loading (``storm_tpu_torch/main.py``,
``config.py``) against storm_tpu's on the CPU: ``Config.load`` of TOML and
JSON, ``apply_overrides`` and ``[[pipelines]]`` equal to storm_tpu's
``Config`` field by field; ``build_multi_model_topology``'s shape; ``ctl``
and the read subcommands against twin daemons, one per package; ``plan``
and ``info``; and ``python -m storm_tpu_torch.main`` running ``serve`` and
``run`` as a user would, on the CPU."""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.main as jax_main
import storm_tpu_torch.config as port_config
import storm_tpu_torch.main as port_main
from tests.test_torch_ui import IMPLS, _with_ui

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"storm_tpu": jax_main, "port": port_main}

TOML = """
[topology]
inference_parallelism = 3
spout_chunk = 8
spout_scheme = "raw"

[model]
name = "lenet5"
dtype = "float32"
num_classes = 10
input_shape = [28, 28, 1]
weights = "int8_fused"

[batch]
max_batch = 32
buckets = [8, 32]
max_wait_ms = 7.5
continuous = true

[offsets]
policy = "earliest"

[sink]
mode = "sync"
acks = 1

[broker]
input_topic = "in-x"

[control]
journal_dir = "/tmp/j"

[qos]
enabled = true

[obs]
enabled = true
interval_s = 0.5

[plan]
enabled = true
rate_rows_s = 600.0
slo_p99_ms = 250.0
hot_steps = 3

[chaos]
enabled = true
kill_worker_s = 5.0
kill_controller_s = 9.0

[[pipelines]]
name = "mnist"
input_topic = "a"
model = { name = "lenet5", input_shape = [28, 28, 1], num_classes = 10 }
batch = { max_batch = 8, buckets = [8] }

[[pipelines]]
name = "cifar"
model = { name = "resnet20", input_shape = [32, 32, 3], num_classes = 10 }
inference_parallelism = 2
"""


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _load_both(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return port_config.Config.load(p), jax_config.Config.load(p)


def test_load_toml_equals_storm_tpu(tmp_path):
    got, want = _load_both(tmp_path, "cfg.toml", TOML)
    assert _as_dict(got) == _as_dict(want)
    assert got.pipelines[1].model.input_shape == (32, 32, 3)
    assert got.chaos.kill_worker_s == 5.0 and got.plan.hot_steps == 3
    assert got.topology._scheme_pinned


def test_compile_cache_dir_loads_alike(tmp_path):
    """ROADMAP C27: a file that sets ``model.compile_cache_dir`` (and a
    pipeline's) loads in both packages to equal configs, nothing popped."""
    text = TOML.replace('weights = "int8_fused"\n',
                        'weights = "int8_fused"\ncompile_cache_dir = "/tmp/x"\n', 1)
    text = text.replace('num_classes = 10 }\ninference_parallelism',
                        'num_classes = 10, compile_cache_dir = "/tmp/y" }\n'
                        'inference_parallelism', 1)
    got, want = _load_both(tmp_path, "cfg.toml", text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.compile_cache_dir == "/tmp/x"
    assert got.pipelines[1].model.compile_cache_dir == "/tmp/y"


def test_compile_cache_latch(tmp_path, caplog):
    """``enable_compile_cache`` latches as storm_tpu's does: the first
    directory wins, a second is warned about and kept out, and the
    kernels' libraries are built and looked for under the latched one.
    ``shared_engine`` keys on the field. The latch is undone afterwards,
    as ``tests/test_infer.py`` undoes storm_tpu's."""
    import logging

    from storm_tpu_torch.infer import engine as eng_mod
    from storm_tpu_torch.ops import _build

    first, second = tmp_path / "first", tmp_path / "second"
    saved = eng_mod._COMPILE_CACHE_DIR, _build._LIBRARY_DIR
    eng_mod._COMPILE_CACHE_DIR, _build._LIBRARY_DIR = None, None
    default = {name: k.library_path() for name, k in _build.KERNELS.items()}
    batch = port_config.BatchConfig(max_batch=4, buckets=(4,))
    engines = []
    try:
        cfg = port_config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                      input_shape=(28, 28, 1), compile_cache_dir=str(first))
        engines.append(eng_mod.shared_engine(cfg, batch, device="cpu"))
        assert eng_mod._COMPILE_CACHE_DIR == str(first)
        assert _build.library_dir() == first
        for name, k in _build.KERNELS.items():
            assert k.library_path() == first / default[name].name
        with caplog.at_level(logging.WARNING, logger=eng_mod.__name__):
            engines.append(eng_mod.shared_engine(
                dataclasses.replace(cfg, compile_cache_dir=str(second)), batch, device="cpu"))
            eng_mod.enable_compile_cache(str(first))
        warned = [r.getMessage() for r in caplog.records if r.name == eng_mod.__name__]
        assert len(warned) == 1 and str(second) in warned[0] and str(first) in warned[0]
        assert _build.library_dir() == first and eng_mod._COMPILE_CACHE_DIR == str(first)
        assert engines[0] is not engines[1]  # the field is part of the engine's identity
        assert not second.exists()
    finally:
        for e in engines:
            eng_mod.unload_engine(e)
        eng_mod._COMPILE_CACHE_DIR, _build._LIBRARY_DIR = saved
    assert {n: k.library_path() for n, k in _build.KERNELS.items()} == default


def test_load_json_equals_storm_tpu(tmp_path):
    import tomllib

    got, want = _load_both(tmp_path, "cfg.json", json.dumps(tomllib.loads(TOML)))
    assert _as_dict(got) == _as_dict(want)


@pytest.mark.parametrize("overrides", [
    ["model.name=resnet20", "batch.max_batch=128", "batch.buckets=[8, 128]"],
    ["topology.spout_scheme=raw", "offsets.max_behind=null", "plan.enabled=true",
     "sink.acks=0", "chaos.kill_worker_s=2.5", "qos.lanes=[\"high\", \"low\"]",
     "qos.lane_deadline_ms=[50, 500]", "qos.default_lane=low"],
])
def test_apply_overrides_equals_storm_tpu(overrides):
    got, want = port_config.Config(), jax_config.Config()
    got.model.name = want.model.name = "lenet5"
    got.model.num_classes, got.model.input_shape = 10, (28, 28, 1)
    got.apply_overrides(overrides)
    want.apply_overrides(overrides)
    assert _as_dict(got) == _as_dict(want)


@pytest.mark.parametrize("bad,exc", [(["model.nope=1"], KeyError), (["nope.x=1"], KeyError),
                                     (["batch.max_batch"], ValueError),
                                     (["plan.headroom=0"], ValueError)])
def test_bad_overrides_refused_alike(bad, exc):
    for cfg in (port_config.Config(), jax_config.Config()):
        with pytest.raises(exc):
            cfg.apply_overrides(bad)


def test_multi_model_topology_shape_matches_storm_tpu():
    import storm_tpu.connectors as jc
    import storm_tpu_torch.connectors as pc

    def pipelines(cfg):
        return [cfg.PipelineConfig(name="mnist", model=cfg.ModelConfig(
                    name="lenet5", dtype="float32", input_shape=(28, 28, 1)),
                    inference_parallelism=2),
                cfg.PipelineConfig(name="cifar", model=cfg.ModelConfig(
                    name="resnet20", dtype="float32", input_shape=(32, 32, 3)),
                    spout_scheme="raw", sink_parallelism=2)]

    def shape(topo):
        return {cid: (s.is_spout, s.parallelism,
                      sorted((sub.source, sub.stream, type(sub.grouping).__name__)
                             for sub in s.inputs)) for cid, s in topo.specs.items()}

    pcfg, jcfg = port_config.Config(), jax_config.Config()
    pcfg.pipelines, jcfg.pipelines = pipelines(port_config), pipelines(jax_config)
    got = port_main.build_multi_model_topology(pcfg, pc.MemoryBroker(), device="cpu")
    want = jax_main.build_multi_model_topology(jcfg, jc.MemoryBroker())
    assert shape(got) == shape(want)
    assert {"mnist-spout", "mnist-inference", "mnist-sink", "mnist-dlq"} <= set(got.specs)
    with pytest.raises(ValueError):
        port_main.build_multi_model_topology(port_config.Config(), pc.MemoryBroker())


def _cli(main_mod, *argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main_mod.main(list(argv))
    return rc, buf.getvalue()


def _keys(out: str):
    try:
        d = json.loads(out)
    except ValueError:
        return "text"
    return sorted(d) if isinstance(d, dict) else type(d).__name__


def test_ctl_against_twin_daemons(run, tmp_path):
    async def body(name, ui, cluster):
        url = f"http://127.0.0.1:{ui.port}"
        m = MAINS[name]
        loop = asyncio.get_running_loop()
        await asyncio.sleep(0.3)
        seq = [("list",), ("status", "demo"), ("metrics", "demo"), ("graph", "demo"),
               ("errors", "demo"), ("component", "demo", "echo"),
               ("rebalance", "demo", "echo", "3"), ("deactivate", "demo"),
               ("activate", "demo"), ("drain", "demo"), ("activate", "demo"),
               ("seek", "demo", "spout", "sideways"), ("logs", "demo"),
               ("profile", "demo", str(tmp_path / name), "--seconds", "0.2"),
               ("status", "nope"), ("kill", "demo")]
        out = []
        for argv in seq:
            rc, text = await loop.run_in_executor(
                None, _cli, m, "ctl", "--url", url, "--token", "tok", *argv)
            out.append((argv[0], rc, _keys(text)))
        rc, _ = await loop.run_in_executor(None, _cli, m, "ctl", "--url", url, "rebalance",
                                           "demo", "echo", "2")
        if ui._profile_task is not None:
            await asyncio.wait_for(ui._profile_task, timeout=60)
        return out, rc

    got = {n: run(_with_ui(impl, lambda ui, c, n=n: body(n, ui, c), token="tok"), timeout=120)
           for n, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    out, rc_no_token = got["port"]
    assert [r for _, r, _ in out] == [0] * 11 + [2, 1, 0, 1, 0] and rc_no_token == 1


def test_read_subcommands_against_twin_daemons(run):
    async def body(name, ui, cluster):
        url = f"http://127.0.0.1:{ui.port}"
        m = MAINS[name]
        loop = asyncio.get_running_loop()
        await asyncio.sleep(0.3)
        out = []
        for argv in (("traces", "demo"), ("traces", "demo", "--flight", "-n", "3"),
                     ("traces", "demo", "--json"), ("profile", "demo"),
                     ("profile", "demo", "--json"), ("bottleneck", "demo"),
                     ("copies", "demo", "--json"), ("plan", "demo"),
                     ("plan", "demo", "--json"), ("traces", "nope")):
            rc, text = await loop.run_in_executor(None, _cli, m, *argv, "--url", url)
            out.append((argv, rc, _keys(text) if "--json" in argv else None))
        return out

    got = {n: run(_with_ui(impl, lambda ui, c, n=n: body(n, ui, c)), timeout=120)
           for n, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    # bottleneck: no observatory attached (404 -> 1); an unknown topology
    assert [rc for _, rc, _ in got["port"]] == [0] * 5 + [1] + [0] * 3 + [1]


@pytest.mark.parametrize("extra", [[], ["--json"]])
def test_scorecard_file_output_equals_storm_tpu(extra, tmp_path):
    """``scorecard --file``: the same table (or JSON) as storm_tpu's for
    its recorded r16 matrix and for a partial one still in progress."""
    with open(os.path.join(ROOT, "SCORECARD_r16.json")) as f:
        card = json.load(f)
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({"seed": 16, "cells": card["cells"][:3],
                                   "in_progress": True}))
    for path in (os.path.join(ROOT, "SCORECARD_r16.json"), str(partial)):
        got = _cli(port_main, "scorecard", "--file", path, *extra)
        assert got == _cli(jax_main, "scorecard", "--file", path, *extra)
        assert got[0] == 0
        if not extra:
            assert "cells pass · seed 16" in got[1]
    assert _cli(port_main, "scorecard") == _cli(jax_main, "scorecard") == (2, "")


def test_scorecard_live_route_equals_storm_tpu(run):
    """``scorecard <topology>`` against twin daemons: 1 while no matrix is
    attached, then the table of the attached one, as storm_tpu's; 2 for
    an unreachable UI."""
    with open(os.path.join(ROOT, "SCORECARD_r16.json")) as f:
        cells = json.load(f)["cells"][4:7]

    async def body(name, ui, cluster):
        url = f"http://127.0.0.1:{ui.port}"
        m = MAINS[name]
        loop = asyncio.get_running_loop()
        before = await loop.run_in_executor(None, _cli, m, "scorecard", "demo", "--url", url)
        cluster.runtime("demo").scorecard = {"seed": 23, "cells": cells, "in_progress": True}
        out = [before]
        for extra in ([], ["--token", "tok"], ["--json"]):
            out.append(await loop.run_in_executor(None, _cli, m, "scorecard", "demo",
                                                  "--url", url, *extra))
        return out

    got = {n: run(_with_ui(impl, lambda ui, c, n=n: body(n, ui, c), token="tok"), timeout=120)
           for n, impl in IMPLS.items()}
    assert [rc for rc, _ in got["port"]] == [rc for rc, _ in got["storm_tpu"]] == [1, 0, 0, 0]
    assert got["port"][1:3] == got["storm_tpu"][1:3]
    assert got["port"][1][1].endswith("(matrix still running: cells land as they are scored)\n")
    assert json.loads(got["port"][3][1]) == json.loads(got["storm_tpu"][3][1])
    assert json.loads(got["port"][3][1])["topology"] == "demo"
    unreachable = ("scorecard", "demo", "--url", "http://127.0.0.1:9")
    assert _cli(port_main, *unreachable)[0] == _cli(jax_main, *unreachable)[0] == 2


@pytest.mark.parametrize("argv", [["--rate", "600", "--slo-ms", "250"],
                                  ["--rate", "600", "--slo-ms", "250", "--engine", "resnet20"],
                                  ["--rate", "500000", "--slo-ms", "20"], ["--rate", "600"]])
def test_offline_plan_output_equals_storm_tpu(argv):
    args = ["plan", "--baseline", os.path.join(ROOT, "PROFILE_r11.json"), *argv]
    rc, text = _cli(port_main, *args)
    jrc, jtext = _cli(jax_main, *args)
    apply_line = "apply with: python -m storm_tpu_torch.main run ... "
    assert (rc, text.replace(apply_line, "apply with: storm-tpu run ... ")) == (jrc, jtext)
    if rc == 0:
        assert apply_line in text
    rc, text = _cli(port_main, *args, "--json")
    jrc, jtext = _cli(jax_main, *args, "--json")
    assert rc == jrc and (rc == 2 or json.loads(text) == json.loads(jtext))


def test_info_keys_match_storm_tpu():
    rc, text = _cli(port_main, "info")
    jrc, jtext = _cli(jax_main, "info")
    got, want = json.loads(text), json.loads(jtext)
    assert rc == jrc == 0 and sorted(got) == sorted(want)
    assert set(want["models"]) <= set(got["models"]) and got["devices"]


def _spawn(*argv):
    return subprocess.Popen([sys.executable, "-m", "storm_tpu_torch.main", *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_serve_subcommand_answers_and_stops_cleanly():
    from storm_tpu_torch.serve.client import InferenceClient

    proc = _spawn("serve", "--model", "lenet5", "--set", "model.input_shape=[28, 28, 1]",
                  "--set", "model.num_classes=10", "--set", "model.dtype=float32",
                  "--set", "batch.buckets=[8]", "--set", "batch.max_batch=8",
                  "--port", "0", "--device", "cpu")
    try:
        port = None
        for line in proc.stderr:
            if line.startswith("serving lenet5 on port "):
                port = int(line.split()[-1])
                break
        assert port, proc.stderr.read()
        with InferenceClient(f"127.0.0.1:{port}") as c:
            info = c.info()
            y = c.predict(np.random.RandomState(0).rand(3, 28, 28, 1).astype(np.float32))
        assert info["model"] == "lenet5" and info["buckets"] == [8]
        assert y.shape == (3, 10) and np.allclose(y.sum(-1), 1, atol=1e-5)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_run_subcommand_serves_for_its_duration(tmp_path):
    cfg = tmp_path / "run.toml"
    cfg.write_text('[model]\nname = "lenet5"\ndtype = "float32"\nnum_classes = 10\n'
                   'input_shape = [28, 28, 1]\n[batch]\nmax_batch = 8\nbuckets = [8]\n'
                   '[obs]\nenabled = true\n[plan]\nenabled = true\n')
    proc = _spawn("run", "t", "in", "out", "--config", str(cfg), "--duration", "2",
                  "--autoscale-target-ms", "50", "--ui-port", "0", "--device", "cpu",
                  "--set", "topology.inference_parallelism=2")
    try:
        _, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, err
    assert "topology 't' running (model=lenet5, broker=memory, obs, plan, autoscaling, ui " \
        "http://127.0.0.1:" in err
    snap = json.loads(err.strip().splitlines()[-1])
    assert "inference-bolt" in snap and "plan" in snap
