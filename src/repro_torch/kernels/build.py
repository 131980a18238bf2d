"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc`` have a plain C interface and include no
PyTorch header, so ``nvcc`` compiles them in seconds.  Each ``.cu`` file is
compiled by its own ``nvcc`` process (all started together), the objects are
linked into one shared library, and the library is loaded with ``ctypes``.
The build happens at first use, never at import: a host without a CUDA
toolkit can import every module of the package.

The library lands in ``build/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``) under a name that carries a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is reused.  A
failed build raises :class:`KernelBuildError` with the compiler's output;
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("routing.cu", "softmax.cu", "flash_attention.cu",
           "decode_attention.cu", "sampling.cu")
HEADERS = ("approx_math.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error code."""


_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None      # guarded-by: _lock


def build_dir() -> Path:
    root = os.environ.get(BUILD_DIR_ENV)
    if root:
        return Path(root)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built on this host")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path, tag: str) -> None:
    """One ``nvcc -c`` per source, all started together, then one link;
    the library is published atomically (add ``-Xptxas -v`` to
    :data:`NVCC_FLAGS` to see each kernel's registers and spills)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    objects: List[str] = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}_{tag}.{os.getpid()}.o"
        objects.append(str(obj))
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        tmp = out_dir / f"libfastcaps_{tag}.{os.getpid()}.tmp.so"
        link = [nvcc, "-shared", "-o", str(tmp), *objects]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise KernelBuildError(
                f"link failed:\n$ {' '.join(link)}\n{res.stdout}")
        os.replace(tmp, out_dir / f"libfastcaps_{tag}.so")
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes / restype for every entry (an undeclared pointer argument
    would be passed as a 32-bit int and cut)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_routing_smem_bytes.argtypes = [i, i, i, i]
    lib.fused_routing_smem_bytes.restype = ctypes.c_longlong
    lib.fused_routing_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.fused_routing_launch.restype = i
    lib.taylor_softmax_launch.argtypes = [p, p, i, i, i, i, i, p]
    lib.taylor_softmax_launch.restype = i
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           i, i, i, i, p]
    lib.flash_attention_launch.restype = i
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, i, i, p]
    lib.decode_attention_launch.restype = i
    lib.fused_sampling_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.fused_sampling_launch.restype = i


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use and loaded once per
    process."""
    global _library
    with _lock:
        if _library is None:
            tag = _source_hash()
            path = build_dir() / f"libfastcaps_{tag}.so"
            if not path.exists():
                _compile(find_nvcc(), build_dir(), tag)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _library = lib
        return _library


def check_launch(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise KernelLaunchError(
            f"{what}: launch refused with CUDA error code {code}")
