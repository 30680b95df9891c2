"""The port stands alone: no module of storm_tpu_torch (its native codec,
MoE layer, model families, QoS package and continuous batcher included),
and neither chip_smoke.py nor
kernel_sweep.py, imports JAX, orbax, scikit-learn or anything of the JAX
package storm_tpu (the machine with the card has none of them)."""

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
    return top in ("jax", "jaxlib", "flax", "orbax", "sklearn", "storm_tpu")


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
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "orbax", "sklearn",
                                               "storm_tpu"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "CODEC (1, 1, 2) {\"predictions\": [[1.5, 2]]}" in out.stdout, out.stdout
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
                 "storm_tpu_torch.qos.shedding", "storm_tpu_torch.infer.continuous"):
        assert repr(name) in out.stdout, name
