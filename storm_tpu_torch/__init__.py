"""storm_tpu_torch: the PyTorch and CUDA port of storm_tpu for NVIDIA Hopper.

A package beside ``storm_tpu`` (the JAX reference), laid out like it:
``ops/`` (layers and the hand-written CUDA kernels under ``csrc/``),
``models/``, ``infer/`` (engine, batcher, inference operator),
``runtime/`` and ``connectors/`` (the streaming core), ``api/`` (the wire
contract) and ``config.py``. It imports neither JAX nor anything of
``storm_tpu``.
"""

__version__ = "0.1.0"
