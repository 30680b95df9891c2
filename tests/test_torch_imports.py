"""The port stands alone: no module of storm_tpu_torch (its native codec,
MoE layer, model families, QoS package, continuous batcher, tracing and
flight recorder, copy ledger and cost profile, Arrow tensor marshalling,
record frames, topology builder, observatory and cascade, the runtime's
groupings, state, chaos monkey, transactions and metrics consumers, the
exactly-once sink, the decode tier, the ring, DRPC, windows, joins, event
time, shell components, the multilang child side, flux and training
included), and
neither chip_smoke.py nor kernel_sweep.py, imports JAX, orbax,
scikit-learn, pyarrow or anything of the JAX package storm_tpu (the
machine with the card has none of them)."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "storm_tpu_torch")


def _port_files():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "kernel_sweep.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "orbax", "sklearn", "storm_tpu", "pyarrow")


def test_no_jax_or_storm_tpu_imports_in_source():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "__import__" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    """Import every module and build the served topology in a fresh
    interpreter, then look at what got loaded."""
    code = textwrap.dedent(f"""
        import os, pkgutil, importlib, sys
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch
        walked = []
        for m in pkgutil.walk_packages(storm_tpu_torch.__path__, "storm_tpu_torch."):
            importlib.import_module(m.name)
            walked.append(m.name)
        print("WALKED", sorted(walked))
        from storm_tpu_torch.config import BatchConfig, Config, ModelConfig
        from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
        from storm_tpu_torch.infer import InferenceBolt
        from storm_tpu_torch.runtime import TopologyBuilder
        broker = MemoryBroker()
        tb = TopologyBuilder()
        tb.set_spout("spout", BrokerSpout(broker, "in"), parallelism=2)
        tb.set_bolt("infer", InferenceBolt(ModelConfig(name="vit_tiny",
                    input_shape=(32, 32, 3)), BatchConfig(), device="cpu"),
                    parallelism=4).shuffle_grouping("spout")
        tb.set_bolt("sink", BrokerSink(broker, "out"), parallelism=2) \\
            .shuffle_grouping("infer")
        tb.build()
        from storm_tpu_torch.api import decode_instances, encode_predictions
        from storm_tpu_torch.models import build_model
        x = decode_instances('{{"instances": [[[1.5, 2.0]]]}}').data
        print("CODEC", x.shape, encode_predictions(x[0]))
        for name in ("moe_vit_tiny", "mixer_tiny", "mobilenetv2", "resnet50"):
            build_model(name, device="cpu", num_classes=10, input_shape=(32, 32, 3))
        build_model("longseq_tiny", device="cpu")
        from storm_tpu_torch.config import QosConfig
        from storm_tpu_torch.qos import AdmissionController, LoadShedController
        tb = TopologyBuilder()
        qos = QosConfig(enabled=True)
        tb.set_spout("spout", BrokerSpout(broker, "in", qos=qos))
        tb.set_bolt("infer", InferenceBolt(ModelConfig(name="longseq_tiny",
                    input_shape=(64, 16)), BatchConfig(continuous=True), device="cpu",
                    passthrough=("qos_lane",), qos=qos)).shuffle_grouping("spout")
        tb.build()
        from storm_tpu_torch.obs import copyledger, profile_store, ensure_installed
        from storm_tpu_torch.runtime.tracing import FlightRecorder, Tracer, device_trace
        ensure_installed()
        copyledger.ensure_installed()
        Tracer(1.0, seed=0).maybe_trace()
        FlightRecorder().event("batch_formed", size=1)
        print("OBS", sorted(profile_store().snapshot()), copyledger.active())
        import numpy as np
        from storm_tpu_torch.config import Config
        from storm_tpu_torch.main import build_standard_topology
        from storm_tpu_torch.runtime.frames import RecordFrame
        from storm_tpu_torch.serve import decode_tensor, encode_tensor
        msg = encode_tensor(np.ones((1, 2, 3), np.float32))
        frame = RecordFrame([msg, b'{{"instances": [[1.0]]}}'])
        print("TENSOR", decode_instances(frame[0]).data.shape, decode_instances(frame[0]).view,
              RecordFrame.from_buffer(b"".join(frame.encode_parts())).nbytes == frame.nbytes)
        cfg = Config()
        cfg.model = ModelConfig(name="vit_tiny", input_shape=(32, 32, 3))
        cfg.topology.spout_chunk, cfg.topology.spout_scheme = 8, "raw"
        cfg.topology.spout_frames = True
        build_standard_topology(cfg, broker, device="cpu")
        from storm_tpu_torch.config import OffsetsConfig, SinkConfig
        from storm_tpu_torch.connectors import TransactionalBrokerSink
        from storm_tpu_torch.runtime import StatefulBolt
        from storm_tpu_torch.runtime.chaos import ChaosMonkey
        from storm_tpu_torch.runtime.metrics import JsonLinesConsumer, prometheus_text
        from storm_tpu_torch.runtime.transactional import TransactionalSink, TransactionalSpout
        cfg.offsets = OffsetsConfig(policy="txn", group_id="g", max_behind=None)
        cfg.sink = SinkConfig(mode="transactional", offsets_group="g")
        cfg.topology.sink_parallelism = 1
        topo = build_standard_topology(cfg, broker, device="cpu")
        tb = TopologyBuilder()
        tb.set_spout("tx", TransactionalSpout(broker, "in"))
        tb.set_bolt("sink", TransactionalSink(broker, "out")).fields_grouping("tx", "txid")
        tb.build()
        print("EOS", type(topo.specs["kafka-bolt"].obj).__name__, ChaosMonkey.__name__,
              prometheus_text({{}}) == "\\n", issubclass(TransactionalSink, StatefulBolt))
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "CODEC (1, 1, 2) {\"predictions\": [[1.5, 2]]}" in out.stdout, out.stdout
    assert "OBS ['engines'] True" in out.stdout, out.stdout
    assert "TENSOR (1, 2, 3) True True" in out.stdout, out.stdout
    assert "EOS TransactionalBrokerSink ChaosMonkey True True" in out.stdout, out.stdout
    # the split-phase engine's modules, the native codec, the MoE layer
    # and the new model families are among those imported
    for name in ("storm_tpu_torch.infer.engine", "storm_tpu_torch.infer.graphs",
                 "storm_tpu_torch.infer.operator", "storm_tpu_torch.resilience.chaos",
                 "storm_tpu_torch.native", "storm_tpu_torch.parallel",
                 "storm_tpu_torch.parallel.moe", "storm_tpu_torch.runtime.tracing",
                 "storm_tpu_torch.models.moe_vit", "storm_tpu_torch.models.mixer",
                 "storm_tpu_torch.models.mobilenet", "storm_tpu_torch.models.resnet",
                 "storm_tpu_torch.models.longseq", "storm_tpu_torch.qos",
                 "storm_tpu_torch.qos.admission", "storm_tpu_torch.qos.lanes",
                 "storm_tpu_torch.qos.shedding", "storm_tpu_torch.infer.continuous",
                 "storm_tpu_torch.obs", "storm_tpu_torch.obs.copyledger",
                 "storm_tpu_torch.obs.profile", "storm_tpu_torch.serve",
                 "storm_tpu_torch.serve.marshal", "storm_tpu_torch.runtime.frames",
                 "storm_tpu_torch.main", "storm_tpu_torch.obs.slo",
                 "storm_tpu_torch.obs.capacity", "storm_tpu_torch.obs.bottleneck",
                 "storm_tpu_torch.cascade", "storm_tpu_torch.cascade.policy",
                 "storm_tpu_torch.cascade.router", "storm_tpu_torch.runtime.groupings",
                 "storm_tpu_torch.runtime.state", "storm_tpu_torch.runtime.chaos",
                 "storm_tpu_torch.runtime.transactional", "storm_tpu_torch.runtime.metrics",
                 "storm_tpu_torch.runtime.metric_names",
                 "storm_tpu_torch.runtime.metric_registry",
                 "storm_tpu_torch.connectors.sink", "storm_tpu_torch.connectors.memory",
                 "storm_tpu_torch.decode", "storm_tpu_torch.decode.engine",
                 "storm_tpu_torch.decode.kvcache", "storm_tpu_torch.decode.operator",
                 "storm_tpu_torch.decode.session", "storm_tpu_torch.models.chartiny",
                 "storm_tpu_torch.dist", "storm_tpu_torch.dist.ring",
                 "storm_tpu_torch.runtime.drpc", "storm_tpu_torch.runtime.window",
                 "storm_tpu_torch.runtime.join", "storm_tpu_torch.runtime.event_time",
                 "storm_tpu_torch.runtime.shell", "storm_tpu_torch.multilang",
                 "storm_tpu_torch.flux", "storm_tpu_torch.parallel.train",
                 "storm_tpu_torch.data", "storm_tpu_torch.data.digits"):
        assert repr(name) in out.stdout, name


def test_observatory_and_cascade_load_no_jax():
    """The observatory and the cascade, each imported first in a fresh
    interpreter, then a cascade topology built and an observatory stepped
    on a runtime: nothing of JAX or storm_tpu gets loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch.cascade.router
        import storm_tpu_torch.cascade
        import storm_tpu_torch.obs
        from storm_tpu_torch.cascade import CascadeConfig, CascadeRouter, Escalated
        from storm_tpu_torch.config import Config, ModelConfig, ObsConfig, QosConfig
        from storm_tpu_torch.connectors import MemoryBroker
        from storm_tpu_torch.main import build_standard_topology
        from storm_tpu_torch.obs import Observatory
        from storm_tpu_torch.runtime.cluster import TopologyRuntime
        cfg = Config()
        cfg.model = ModelConfig(name="resnet20", input_shape=(32, 32, 3), num_classes=10)
        cfg.cascade = CascadeConfig(enabled=True, tiers=("vit_tiny", "lenet5", "resnet20"),
                                    thresholds=(0.02, 0.1))
        cfg.qos = QosConfig(enabled=True, degrade_model="lenet5")
        topo = build_standard_topology(cfg, MemoryBroker(), device="cpu")
        rt = TopologyRuntime("t", topo, cfg)
        obs = Observatory(rt, ObsConfig(enabled=True))
        obs.step()
        print("STEPPED", sorted(obs.snapshot()), rt.obs is obs, CascadeRouter, Escalated)
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "STEPPED ['baseline_loaded', 'bottleneck', 'copies', 'corrector', 'decode', " \
        "'occupancy', 'regressions', 'slo', 'utilization'] True" in out.stdout, out.stdout


def test_decode_and_stream_operators_load_no_jax():
    """The decode tier, DRPC, the stream operators, shell components and
    flux, each imported first in a fresh interpreter, then a decode
    topology on the ring grouping, a DRPC serving topology and a flux
    definition built and a decode step run on the CPU: nothing of JAX or
    storm_tpu gets loaded, and the multilang child side loads nothing but
    the standard library."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch.multilang
        child = sorted(n for n in sys.modules if n.split(".")[0] in ("torch", "numpy"))
        import storm_tpu_torch.decode
        import storm_tpu_torch.flux
        import storm_tpu_torch.runtime.drpc
        from storm_tpu_torch.config import ModelConfig
        from storm_tpu_torch.decode import DecodeBolt, DecodeConfig, SessionSpout
        from storm_tpu_torch.decode.engine import DecodeEngine
        from storm_tpu_torch.runtime import (EventTimeWindowBolt, JoinBolt, ShellBolt,
                                             TopologyBuilder, TumblingWindowBolt)
        tb = TopologyBuilder()
        tb.set_spout("requests", SessionSpout([{{"session_id": "s0"}}]))
        tb.set_bolt("decode-bolt", DecodeBolt(DecodeConfig(), device="cpu"), 2) \\
            .ring_fields_grouping("requests", "session_id")
        tb.build()
        server = storm_tpu_torch.runtime.drpc.DRPCServer()
        storm_tpu_torch.runtime.drpc.drpc_inference_topology(
            server, ModelConfig(name="lenet5"), device="cpu")
        storm_tpu_torch.flux.load_topology({{"spouts": [{{
            "id": "s", "class": "storm_tpu_torch.decode.SessionSpout",
            "args": {{"requests": []}}}}]}})
        eng = DecodeEngine(blocks=2, max_seq=8, device="cpu")
        print("STEP", eng.predict([[eng.kv.acquire("a"), 0, 0], [-1, 5, 0]]).shape,
              JoinBolt.__name__, EventTimeWindowBolt.__name__, TumblingWindowBolt.__name__,
              ShellBolt.__name__)
        print("CHILD", child)
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "CHILD []" in out.stdout, out.stdout
    assert "STEP (2, 98) JoinBolt EventTimeWindowBolt TumblingWindowBolt ShellBolt" \
        in out.stdout, out.stdout


def test_training_loads_no_jax(tmp_path):
    """The training step imported first in a fresh interpreter, then one
    lenet5 step taken on the CPU, its parameters saved with
    ``save_checkpoint`` and read back: nothing of JAX or storm_tpu gets
    loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch.parallel.train
        import numpy as np
        from storm_tpu_torch.data import train_to_convergence
        from storm_tpu_torch.models.convert import host_tree, trainable_params
        from storm_tpu_torch.models.registry import load_checkpoint, model_def, save_checkpoint
        md = model_def("lenet5")
        step, opt = storm_tpu_torch.parallel.train.make_train_step(md, device="cpu")
        params = trainable_params(md.init(np.random.RandomState(0))[0], "cpu")
        x = np.random.RandomState(1).rand(4, 28, 28, 1).astype(np.float32)
        params, _opt, state, loss = step(params, opt(params), {{}}, x, np.arange(4))
        path = save_checkpoint({str(tmp_path / "lenet5.npz")!r}, host_tree(params), state, md)
        print("TRAINED", float(loss) > 0, load_checkpoint(str(path))[2]["model"],
              train_to_convergence.__name__)
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "TRAINED True lenet5 train_to_convergence" in out.stdout, out.stdout
