"""Build, load and count the hand-written CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
and loaded with :mod:`ctypes`.  Libraries are named by a hash of their
source and flags, so an edited source builds anew and a stale library is
never loaded.

The build directory is ``<checkout>/build/kernels`` when this package lies
in a source checkout (a ``pyproject.toml`` beside ``src/``), else
``~/.cache/repro_torch/kernels``.

Nothing here runs at import: this module is imported on hosts that have no
``nvcc`` and no card, where the kernels' plain versions serve CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_SOURCES = ("segstats", "blockscan", "scatter_add", "int8_quant",
                  "xent")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """Where the shared libraries go (module docstring)."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src").is_dir():
        return root / "build" / "kernels"
    return Path.home() / ".cache" / "repro_torch" / "kernels"


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit PyTorch
    found.  Raises when there is none — a CUDA tensor never falls back."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}.{digest.hexdigest()[:12]}.so"


class _Compile:
    """One running ``nvcc``.  It writes a temporary file that is renamed
    into place when it succeeds, so a concurrent process never loads a
    half-written library."""

    def __init__(self, name: str, out: Path):
        self.name, self.out = name, out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, self.tmp = tempfile.mkstemp(prefix=out.name, suffix=".tmp",
                                        dir=out.parent)
        os.close(fd)
        self.proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", self.tmp,
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            os.unlink(self.tmp)
            raise RuntimeError(f"nvcc failed on {self.name}.cu "
                               f"(exit {self.proc.returncode}):\n{log}")
        os.replace(self.tmp, self.out)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.tmp):
            os.unlink(self.tmp)


def _compile(name: str) -> _Compile | None:
    """Start compiling ``name`` unless its library exists."""
    out = library_path(name)
    return None if out.is_file() else _Compile(name, out)


def build_all(names=KERNEL_SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [j for j in (_compile(n) for n in names) if j is not None]
        try:
            for j in jobs:
                j.finish()
        except BaseException:
            for j in jobs:  # reap the other compilers too
                j.kill()
            raise
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _compile(name)
        if job is not None:
            job.finish()
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
        return lib


_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}

PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def function(lib: str, name: str, argtypes: tuple,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """``name`` from library ``lib`` with its C signature declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits).
    Launchers return ``cudaGetLastError()`` as an int."""
    key = (lib, name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[key] = fn
    return fn


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA card, False when every one lies
    on the CPU (where the plain versions run); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different cards: "
                             f"{sorted(str(t.device) for t in tensors)}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on one CUDA card or all on the "
                     f"CPU, got {sorted(kinds)}")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s card."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def expect(t, what: str, dtypes: tuple, ndims: tuple) -> None:
    """Raise unless ``t`` has one of ``dtypes``, one of ``ndims`` and is
    contiguous: the C kernels take nothing else."""
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() not in ndims:
        raise ValueError(f"{what}: expected {ndims}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")


class LaunchCounts:
    """Kernel launches by name, counted by each CUDA wrapper where it
    launches its kernel (plain-version calls are not launches)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n.clear()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._n)


launch_counts = LaunchCounts()
