"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/storm_tpu_torch/``
at the repository root, then loaded with :mod:`ctypes`. Nothing is built
when a module is imported: the first launch of a kernel builds it (cached
by a hash of its sources and flags), and :func:`build_all` builds every
kernel at once, one ``nvcc`` process per source, all started together.

Every pointer and the stream cross as ``c_void_p``; every C entry returns
``cudaGetLastError()`` after its launch, and :meth:`Kernel.launch` raises
when that is not 0 — a refused launch never runs, and a later
``synchronize`` would not report it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "storm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Element-type codes of the C entries (csrc/common.cuh DTYPE_*).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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

    ``launches`` counts successful launches of the kernel, and nothing
    else: the wrappers in ``storm_tpu_torch.ops`` call :meth:`launch` only
    where they run the kernel, never on their CPU (plain) path.
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
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self, nvcc: str) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library is built;
        returns the process (or None when nothing is to be done). Its
        output goes to the ``.log`` beside the library."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(lib.with_suffix(".log"), "w") as log:
            return subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(self._tmp_path()),
                 str(self.source), *self.libs],
                stdout=log, stderr=subprocess.STDOUT)

    def _tmp_path(self) -> Path:
        # Build into a private name, then rename: a concurrent build of
        # the same source never loads a half-written library.
        return self.library_path().with_suffix(f".{os.getpid()}.tmp")

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {rc}):\n{self.build_log()}")
        os.replace(self._tmp_path(), self.library_path())

    def build_log(self) -> str:
        """The compiler's output of the last build (``-Xptxas -v``
        registers, shared memory and spills per instantiation)."""
        p = self.library_path().with_suffix(".log")
        return p.read_text() if p.exists() else ""

    def function(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build(find_nvcc()))
                lib = ctypes.CDLL(str(self.library_path()))
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
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# Each variant of a kernel is an entry of its own, with its own launch
# count: the f32 variants (CUDA-core FMAs, float32 and bfloat16) and the
# tensor-core variants (*_sm90, bfloat16 only).
KERNELS: Dict[str, Kernel] = {
    k.name: k for k in (
        # (dtype, x, q, s, out, M, N, K, stream)
        Kernel("w8a16_matmul", "w8a16_matmul.cu", [I, P, P, P, P, I, I, I, P]),
        # (x, q, s, out, M, N, K, warpgroups, tile_m, load_mode, stream)
        # (links the driver library for cuTensorMapEncodeTiled)
        Kernel("w8a16_matmul_sm90", "w8a16_matmul_sm90.cu",
               [P, P, P, P, I, I, I, I, I, I, P], libs=("-lcuda",)),
        # (dtype, x, r, g, b, y, out, rows, d, eps, stream)
        Kernel("residual_layernorm", "fused_norm.cu",
               [I, P, P, P, P, P, P, I, I, F, P]),
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
    nvcc = find_nvcc()
    errors = []
    with contextlib.ExitStack() as held:
        # Hold every kernel's lock, so no launch builds the same source
        # beside this build.
        for k in KERNELS.values():
            held.enter_context(k._lock)
        procs = [(k, k.start_build(nvcc)) for k in KERNELS.values()]
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
