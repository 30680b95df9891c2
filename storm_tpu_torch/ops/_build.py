"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library in the library directory
(:func:`library_dir`: ``build/storm_tpu_torch/`` at the repository root,
unless :func:`set_library_dir` moved it), then loaded with :mod:`ctypes`.
Nothing is built when a module is imported: the first launch of a kernel
builds it (cached by a hash of its sources and flags), and
:func:`build_all` builds every kernel at once, one ``nvcc`` process per
source, all started together. A library already in the directory is
loaded as it is: ``nvcc`` is looked for only when one is missing.

Every pointer and the stream cross as ``c_void_p``; every C entry returns
``cudaGetLastError()`` after its launch, and :meth:`Kernel.launch` raises
when that is not 0 — a refused launch never runs, and a later
``synchronize`` would not report it.

Two counts of launches. ``Kernel.launches`` (:func:`launch_counts`) counts
the wrapper's eager launches, process-wide: what ``kernel_sweep.py`` and
``chip_smoke.py``'s kernel phase read. A launch made while a CUDA graph is
being captured only records the kernel into the graph, so it is not
counted there; :func:`record_launches` gives the capturing thread the
kernels its capture recorded, and the inference engine tallies those per
replay (``InferenceEngine.launch_tally``), beside the launches of its own
eager forwards. The served paths' launch gates read that tally.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# The default library directory; set_library_dir moves it.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "storm_tpu_torch"
_LIBRARY_DIR: Optional[Path] = None
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Element-type codes of the C entries (csrc/common.cuh DTYPE_*).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The calling thread's launch recorder (record_launches).
_RECORDER = threading.local()


def library_dir() -> Path:
    """Where the kernels' libraries are built and looked for, read at each
    build and load."""
    return _LIBRARY_DIR or BUILD_DIR


def set_library_dir(path) -> None:
    """Build and load the kernels' libraries in ``path`` from now on (the
    compile cache, ``infer.engine.enable_compile_cache``). A kernel whose
    library is already loaded keeps it."""
    global _LIBRARY_DIR
    _LIBRARY_DIR = Path(path)


@contextlib.contextmanager
def record_launches(capturing: bool = False):
    """Count, by kernel name, the launches this thread makes inside the
    block. With ``capturing`` the block is a CUDA graph capture: its
    launches are recorded into the graph, not run, so they stay out of
    ``Kernel.launches`` (each replay runs them; its caller tallies them)."""
    counts: Counter = Counter()
    prev = getattr(_RECORDER, "state", None)
    _RECORDER.state = (counts, capturing)
    try:
        yield counts
    finally:
        _RECORDER.state = prev


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's conventional install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of storm_tpu_torch are built from source at first use")


class Kernel:
    """One CUDA source with a C entry point, built on demand.

    ``launches`` counts successful eager launches of the kernel, and
    nothing else: the wrappers in ``storm_tpu_torch.ops`` call
    :meth:`launch` only where they run the kernel, never on their CPU
    (plain) path, and a launch inside a graph capture is left to the
    capture's recorder (:func:`record_launches`).
    """

    def __init__(self, name: str, source: str, argtypes: Sequence,
                 libs: Sequence[str] = ()) -> None:
        self.name = name
        self.source = CSRC / source
        self.argtypes = list(argtypes)
        self.libs = list(libs)  # linker flags, after the source
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _sources(self) -> List[Path]:
        return [self.source, CSRC / "common.cuh"]

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in self._sources():
            h.update(p.read_bytes())
        h.update(" ".join([*NVCC_FLAGS, *self.libs]).encode())
        return library_dir() / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self, lib: Optional[Path] = None):
        """Start ``nvcc`` for this source unless its library ``lib`` (default
        :meth:`library_path`) is built; returns what :meth:`finish_build`
        takes, or None when nothing is to be done. Its output goes to the
        ``.log`` beside the library."""
        lib = lib or self.library_path()
        if lib.exists():
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        # Build into a private name, then rename: a concurrent build of the
        # same source (another process sharing the directory) never loads
        # a half-written library.
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source),
                 *self.libs], stdout=log, stderr=subprocess.STDOUT)
        return proc, lib, tmp

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, lib, tmp = started
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {rc}):\n{lib.with_suffix('.log').read_text()}")
        os.replace(tmp, lib)

    def build_log(self) -> str:
        """The compiler's output of the last build (``-Xptxas -v``
        registers, shared memory and spills per instantiation)."""
        p = self.library_path().with_suffix(".log")
        return p.read_text() if p.exists() else ""

    def function(self):
        with self._lock:
            if self._fn is None:
                path = self.library_path()
                self.finish_build(self.start_build(path))
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, self.name)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry with ``args`` (tensors pass their data
        pointers) on ``device``'s current stream, appended as the last
        argument, and raise if the launch was refused."""
        fn = self.function()
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*ptrs, stream)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError_t {rc}")
        state = getattr(_RECORDER, "state", None)
        if state is not None:
            state[0][self.name] += 1
        if state is None or not state[1]:
            self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# Each variant of a kernel is an entry of its own, with its own launch
# count: the first versions (CUDA-core FMAs, float32 and bfloat16) and the
# redesigns for Hopper (*_sm90: w8a16 and flash attention on tensor cores,
# bfloat16 only; the fused norm, float32 and bfloat16).
KERNELS: Dict[str, Kernel] = {
    k.name: k for k in (
        # (dtype, x, q, s, out, M, N, K, stream)
        Kernel("w8a16_matmul", "w8a16_matmul.cu", [I, P, P, P, P, I, I, I, P]),
        # (x, q, s, out, M, N, K, warpgroups, tile_m, load mode | 4 for an f32
        #  out, stream)
        # (links the driver library for cuTensorMapEncodeTiled)
        Kernel("w8a16_matmul_sm90", "w8a16_matmul_sm90.cu",
               [P, P, P, P, I, I, I, I, I, I, P], libs=("-lcuda",)),
        # (dtype, x, r, g, b, y, out, rows, d, eps, stream)
        Kernel("residual_layernorm", "fused_norm.cu",
               [I, P, P, P, P, P, P, I, I, F, P]),
        # (dtype, param dtype, x, r, g, b, y, out, rows, d, eps, lanes,
        #  vectors, load_mode, rows_per_block, stream)
        Kernel("residual_layernorm_sm90", "fused_norm_sm90.cu",
               [I, I, P, P, P, P, P, P, I, I, F, I, I, I, I, P]),
        # (dtype, q, k, v, o, B*H, S, D, scale, stream)
        Kernel("flash_attention", "flash_attention.cu",
               [I, P, P, P, P, I, I, I, F, P]),
        # (q, k, v, o, B*H, S, D, scale, stream)
        Kernel("flash_attention_sm90", "flash_attention_sm90.cu",
               [P, P, P, P, I, I, I, F, P]),
    )
}


def build_all() -> Dict[str, Path]:
    """Build every kernel from source, one ``nvcc`` per file in parallel,
    and load each. Returns name -> library path."""
    errors = []
    with contextlib.ExitStack() as held:
        # Hold every kernel's lock, so no launch builds the same source
        # beside this build.
        for k in KERNELS.values():
            held.enter_context(k._lock)
        procs = [(k, k.start_build()) for k in KERNELS.values()]
        for k, proc in procs:
            try:
                k.finish_build(proc)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n\n".join(errors))
    for k in KERNELS.values():
        k.function()
    return {name: k.library_path() for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"CUDA kernels take float32 or bfloat16, got {t.dtype}") from None


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor a kernel reads or writes: on one CUDA device and
    contiguous. Returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
    return dev


def route(name: str, *tensors: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False to run the plain version.

    The plain version serves CPU tensors only; a tensor on any other
    device than the CPU or a CUDA card is refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(
        f"{name}: tensors must all be on the CPU or all on one CUDA "
        f"device, got {sorted(kinds)}")
