"""The port stands alone: no module of storm_tpu_torch (its native codec,
MoE layer, model families, QoS package, continuous batcher, tracing and
flight recorder, copy ledger and cost profile, Arrow tensor marshalling,
record frames, topology builder, observatory and cascade, the runtime's
groupings, state, chaos monkey, transactions and metrics consumers, the
exactly-once sink, the decode tier, the ring, DRPC, windows, joins, event
time, shell components, the multilang child side, flux, training, and
the dist runtime with its Kafka wire client, stub broker, resilience
primitives, controller journal and the worker's ``state_report``,
``decode_sessions`` and ``profile`` ops included, and the parallel
serving paths: the mesh, collectives, sharding, ring attention, sequence
parallelism, expert-parallel MoE, the rank launcher and the sharded
engine, and the control plane: the UI server and the dist UI, the
autoscaler, the planner, the inference worker, its client, the
cross-caller batcher, the remote bolt and the CLI, and the fleet load
generator: its traces, scorecard and scenario-matrix runner, and the
compile cache and the kernel parity cases), and neither chip_smoke.py,
kernel_sweep.py nor the root-script twins (cuda_kernel_parity.py,
bench_device_torch.py, __graft_entry_torch__.py) nor fleet_probe_ab.py,
imports JAX, orbax, scikit-learn, pyarrow, gRPC or anything of the JAX
package storm_tpu (the machine with the card has none of them; the
port's dist RPCs run over the standard library's sockets)."""

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
    for script in ("chip_smoke.py", "kernel_sweep.py", "cuda_kernel_parity.py",
                   "bench_device_torch.py", "__graft_entry_torch__.py", "fleet_probe_ab.py"):
        yield os.path.join(ROOT, script)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "orbax", "sklearn", "storm_tpu", "pyarrow",
                   "grpc")


def test_no_jax_or_storm_tpu_imports_in_source():
    bad = []
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {"storm_tpu_torch/dist/journal.py", "storm_tpu_torch/dist/worker.py",
            "storm_tpu_torch/dist/controller.py", "storm_tpu_torch/loadgen/__init__.py",
            "storm_tpu_torch/loadgen/trace.py", "storm_tpu_torch/loadgen/scorecard.py",
            "storm_tpu_torch/loadgen/fleet.py", "storm_tpu_torch/ops/parity_checks.py",
            "cuda_kernel_parity.py", "bench_device_torch.py",
            "__graft_entry_torch__.py", "fleet_probe_ab.py"} <= scanned
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
        import tempfile
        from storm_tpu_torch.connectors.kafka_protocol import GroupMembership
        from storm_tpu_torch.connectors.spout import parse_seek_position
        from storm_tpu_torch.dist.journal import ControllerJournal
        from storm_tpu_torch.dist.worker import WorkerServer
        d = tempfile.mkdtemp()
        j = ControllerJournal(d)
        j.append("workers", peers={{0: "127.0.0.1:1"}}, pids={{0: 1}})
        j.close()
        ws = WorkerServer(0, 0, device="cpu", host="127.0.0.1")
        rep = ws._control({{"cmd": "state_report"}})
        dec = ws._control({{"cmd": "decode_sessions"}})
        prof = ws._control({{"cmd": "profile", "log_dir": d + "/p", "seconds": 0.05}})
        ws._profile_thread.join(timeout=60)
        ws._server.stop()
        print("CONTROL", ControllerJournal(d).load().peers, rep["submits"],
              dec["decode"]["tokens_emitted"], prof["ok"],
              os.path.exists(d + "/p/trace.json"), parse_seek_position("-3"),
              GroupMembership.PROTOCOL)
        import shutil
        shutil.rmtree(d)
        from storm_tpu_torch.config import ShardingConfig
        from storm_tpu_torch.infer.engine import InferenceEngine
        from storm_tpu_torch.parallel.mesh import Mesh, make_mesh
        from storm_tpu_torch.parallel.sharding import shard_params_tp, tp_param_specs
        from storm_tpu_torch.parallel.collectives import GLOO_CUDA, all_gather
        from storm_tpu_torch.parallel.launch import spawn_ranks
        from storm_tpu_torch.parallel.moe import ExpertShard, shard_moe_params
        from storm_tpu_torch.parallel.ring_attention import ring_attention
        from storm_tpu_torch.parallel.sequence import seq_parallel_encoder
        cfg = Config.from_dict({{"sharding": {{"data_parallel": 1}}}})
        cfg.model = ModelConfig(name="longseq_tiny", input_shape=(64, 16))
        build_standard_topology(cfg, broker, device="cpu")
        eng = InferenceEngine(cfg.model, BatchConfig(max_batch=8, buckets=(8,)), device="cpu",
                              sharding_cfg=ShardingConfig(), mesh=make_mesh(device="cpu"))
        import torch.distributed as tdist
        print("PARALLEL", dict(eng.mesh.shape), eng.pipeline_depth, tdist.is_initialized(),
              sorted(GLOO_CUDA), ring_attention.__name__)
        import torch
        import __graft_entry_torch__, bench_device_torch, cuda_kernel_parity, fleet_probe_ab
        from storm_tpu_torch.ops import parity_checks
        m = build_model("lenet5", device="cpu", dtype=torch.float32, num_classes=10,
                        input_shape=(28, 28, 1))
        cost = bench_device_torch.plain_route_cost(m, torch.float32, 8, (28, 28, 1))
        print("TWINS", len(parity_checks.check_fused_norm("cpu")), cost["flops"] > 0,
              len(__graft_entry_torch__.serving_meshes(4)),
              cuda_kernel_parity.DEFAULT_OUT, sorted(fleet_probe_ab.VARIANTS))
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow", "grpc"))
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
    assert "CONTROL {0: '127.0.0.1:1'} 0 0 True True -3 range" in out.stdout, out.stdout
    assert ("TWINS 6 True 4 build/KERNEL_CUDA.json ['climb', 'probe']"
            in out.stdout), out.stdout
    assert ("PARALLEL {'data': 1, 'model': 1} 2 False ['all_gather', 'all_reduce'] "
            "ring_attention") in out.stdout, out.stdout
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
                 "storm_tpu_torch.data", "storm_tpu_torch.data.digits",
                 "storm_tpu_torch.dist.controller", "storm_tpu_torch.dist.worker",
                 "storm_tpu_torch.dist.transport", "storm_tpu_torch.dist.wire",
                 "storm_tpu_torch.dist.shm", "storm_tpu_torch.dist.journal",
                 "storm_tpu_torch.connectors.kafka_protocol",
                 "storm_tpu_torch.connectors.kafka_stub", "storm_tpu_torch.connectors.lz4",
                 "storm_tpu_torch.connectors.snappy", "storm_tpu_torch.resilience.retry",
                 "storm_tpu_torch.resilience.circuit", "storm_tpu_torch.resilience.tokens",
                 "storm_tpu_torch.parallel.mesh", "storm_tpu_torch.parallel.collectives",
                 "storm_tpu_torch.parallel.sharding", "storm_tpu_torch.parallel.ring_attention",
                 "storm_tpu_torch.parallel.sequence", "storm_tpu_torch.parallel.launch",
                 "storm_tpu_torch.runtime.ui", "storm_tpu_torch.runtime.autoscale",
                 "storm_tpu_torch.plan", "storm_tpu_torch.plan.model",
                 "storm_tpu_torch.plan.solver", "storm_tpu_torch.plan.corrector",
                 "storm_tpu_torch.serve.worker", "storm_tpu_torch.serve.client",
                 "storm_tpu_torch.serve.batcher", "storm_tpu_torch.serve.remote_bolt",
                 "storm_tpu_torch.dist.ui", "storm_tpu_torch.loadgen",
                 "storm_tpu_torch.loadgen.trace", "storm_tpu_torch.loadgen.scorecard",
                 "storm_tpu_torch.loadgen.fleet"):
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
                                               "storm_tpu", "pyarrow", "grpc"))
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
                                               "storm_tpu", "pyarrow", "grpc"))
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
    ``save_checkpoint`` and read back, then one step of the sharded step
    and of the pipeline on a mesh of one: nothing of JAX or storm_tpu gets
    loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch.parallel.train
        import storm_tpu_torch.parallel.pipeline
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
        from storm_tpu_torch.parallel.mesh import make_mesh
        from storm_tpu_torch.parallel.train import init_sharded_training, train_one_step
        mesh = make_mesh(1, 1, device="cpu")
        step, p, o, st = init_sharded_training(md, mesh, device="cpu")
        *_, loss = train_one_step(step, mesh, p, o, st, x, np.arange(4))
        vit = model_def("vit_tiny")
        pp_step, ps, po = storm_tpu_torch.parallel.pipeline.init_pp_training(
            vit, make_mesh(1, 1, ("data", "stage"), device="cpu"), n_micro=2, device="cpu")
        xv = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
        *_, pp_loss = pp_step(ps, po, xv, np.arange(2))
        print("SHARDED", float(loss) > 0, float(pp_loss) > 0, pp_step.heads)
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow", "grpc"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "TRAINED True lenet5 train_to_convergence" in out.stdout, out.stdout
    assert "SHARDED True True 4" in out.stdout, out.stdout


def test_dist_runtime_loads_no_jax_or_grpc():
    """The worker's ``-m`` entry answers ``--help`` in a fresh interpreter,
    and the dist runtime, the wire broker and the stub imported and used
    there (a frame encoded, a transport call answered, the stub's log
    written and read) load nothing of JAX, gRPC or storm_tpu."""
    out = subprocess.run([sys.executable, "-m", "storm_tpu_torch.dist.worker", "--help"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "--index" in out.stdout and "--device" in out.stdout
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.path.insert(0, {ROOT!r})
        sys.argv = ["storm_tpu_torch.dist.worker", "--help"]
        try:
            runpy.run_module("storm_tpu_torch.dist.worker", run_name="__main__")
        except SystemExit as e:
            print("HELP", e.code)
        from storm_tpu_torch.dist import DistCluster, transport, wire
        from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker
        from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
        from storm_tpu_torch.runtime.tuples import Tuple
        frame = wire.encode_deliveries([("b", 0, Tuple(values=[b"x"], fields=("m",),
                                                       source_component="s"))])
        handler = transport.DistHandler(lambda r, c: b"{{}}", lambda r, c: b"{{}}",
                                        lambda r, c: b'{{"ok": true}}', token="")
        srv = transport.TransportServer(handler, port=0, host="127.0.0.1")
        srv.start()
        client = transport.WorkerClient(f"127.0.0.1:{{srv.port}}", token="")
        client.deliver(frame)
        print("PING", client.control("ping"))
        client.close()
        srv.stop()
        stub = KafkaStubBroker(partitions=1)
        b = KafkaWireBroker(f"127.0.0.1:{{stub.port}}")
        b.produce("t", b"v")
        print("FETCH", [r.value for r in b.fetch("t", 0, 0, 5)])
        b.close()
        stub.close()
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow", "grpc"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "HELP 0" in out.stdout, out.stdout
    assert "PING {'ok': True}" in out.stdout, out.stdout
    assert "FETCH [b'v']" in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout


def test_control_plane_loads_no_jax_or_grpc():
    """The control plane, each module imported first in a fresh
    interpreter, then used: the CLI's ``--help``, an offline plan, an
    inference worker answering ``Info`` and an unknown method, a UI
    server's health route over a running topology, an autoscaler step and
    the dist UI's Prometheus facade: nothing of JAX, gRPC or storm_tpu gets
    loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch.runtime.ui
        import storm_tpu_torch.dist.ui
        import storm_tpu_torch.plan
        import storm_tpu_torch.runtime.autoscale
        import storm_tpu_torch.serve.remote_bolt
        import storm_tpu_torch.main as m
        import asyncio, io, json, urllib.request
        from contextlib import redirect_stdout
        from storm_tpu_torch.config import BatchConfig, Config, ModelConfig
        from storm_tpu_torch.resilience import RpcError
        from storm_tpu_torch.runtime import Bolt, TopologyBuilder
        from storm_tpu_torch.runtime.cluster import AsyncLocalCluster
        from storm_tpu_torch.runtime.metrics import prometheus_text
        from storm_tpu_torch.serve import InferenceClient, InferenceWorker
        from storm_tpu_torch.serve.batcher import CrossCallerBatcher
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = m.main(["plan", "--baseline", {os.path.join(ROOT, "PROFILE_r11.json")!r},
                         "--rate", "600", "--slo-ms", "250"])
        print("PLAN", rc, buf.getvalue().split()[0])
        w = InferenceWorker(ModelConfig(name="lenet5", input_shape=(28, 28, 1),
                                        num_classes=10), port=0, device="cpu",
                            host="127.0.0.1").start()
        with InferenceClient(f"127.0.0.1:{{w.port}}") as c:
            info = c.info()
            try:
                c.call("/storm_tpu.Dist/Ack", b"[]")
            except RpcError as e:
                code = e.code().name
        w.stop()
        print("WORKER", info["model"], code, CrossCallerBatcher.__name__)

        class Idle(Bolt):
            async def execute(self, t):
                self.collector.ack(t)

        async def go():
            from storm_tpu_torch.connectors import MemoryBroker, BrokerSpout
            tb = TopologyBuilder()
            tb.set_spout("s", BrokerSpout(MemoryBroker(), "in"))
            tb.set_bolt("inference-bolt", Idle(), 2).shuffle_grouping("s")
            cluster = AsyncLocalCluster()
            rt = await cluster.submit("t", Config(), tb.build())
            ui = await storm_tpu_torch.runtime.ui.UIServer(cluster, port=0).start()
            loop = asyncio.get_running_loop()
            body = await loop.run_in_executor(None, lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{{ui.port}}/healthz").read())
            sc = storm_tpu_torch.runtime.autoscale.Autoscaler(rt)
            step = await sc.step()
            await ui.stop()
            await cluster.shutdown()
            return json.loads(body)["status"], step

        print("UI", *asyncio.run(go()))

        class Fake:
            def metrics(self):
                return {{"c": {{"n": 1}}}}

        print("DIST", prometheus_text({{"d": storm_tpu_torch.dist.ui.DistMetrics(Fake())}})
              .splitlines()[-1])
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow", "grpc"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "PLAN 0 PLAN" in out.stdout, out.stdout
    assert "WORKER lenet5 UNIMPLEMENTED CrossCallerBatcher" in out.stdout, out.stdout
    assert "UI ok None" in out.stdout, out.stdout
    assert 'DIST storm_tpu_n_total{topology="d",component="c"} 1' in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout
    out = subprocess.run([sys.executable, "-m", "storm_tpu_torch.main", "--help"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for cmd in ("run", "dist-run", "serve", "info", "ctl", "traces", "profile", "bottleneck",
                "copies", "plan", "scorecard"):
        assert cmd in out.stdout, cmd


def test_loadgen_loads_no_jax():
    """The load generator imported first in a fresh interpreter, then a
    trace generated, saved and loaded, a cell scored and rendered, every
    fleet scenario's topology built on the CPU (the cascade's tiers on the
    exported checkpoints and the port's digits file) and the fleet's
    ``-m`` entry asked for ``--help``: nothing of JAX, scikit-learn or
    storm_tpu gets loaded."""
    code = textwrap.dedent(f"""
        import os, runpy, sys, tempfile
        sys.path.insert(0, {ROOT!r})
        import storm_tpu_torch.loadgen
        import storm_tpu_torch.loadgen.fleet as fleet
        from storm_tpu_torch.loadgen import (CellTargets, TraceSpec, generate, load_trace,
                                             render_table, score_cell)
        t = generate(TraceSpec(pattern="decode_sessions", duration_s=2.0))
        path = t.save(os.path.join(tempfile.mkdtemp(), "t.trace"))
        ok = score_cell({{"shed_frac": 0.2}}, CellTargets(expect_shed=True))["ok"]
        table = render_table({{"cells": [{{"scenario": "x", "ok": ok}}]}})
        print("TRACE", load_trace(path).rows == t.rows, ok, table.splitlines()[-1])
        built = []
        for sc in fleet._make_scenarios(fleet.SCENARIOS, "cpu"):
            sc.setup()
            try:
                if sc.name == "serve_path":
                    built.append(sc.name)
                    continue
                broker, cfg, topo = sc.build(400.0)
                built.append(sorted(topo.specs))
            finally:
                sc.teardown()
        print("BUILT", len(built), fleet._CascadeScenario().available())
        sys.argv = ["storm_tpu_torch.loadgen.fleet", "--help"]
        try:
            runpy.run_module("storm_tpu_torch.loadgen.fleet", run_name="__main__")
        except SystemExit as e:
            print("HELP", e.code)
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu", "pyarrow", "grpc"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "TRACE True True 1/1 cells pass" in out.stdout, out.stdout
    assert "BUILT 5 None" in out.stdout, out.stdout
    assert "HELP 0" in out.stdout and "--fleet-scenarios" in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout
