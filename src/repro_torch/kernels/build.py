"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc`` have a plain C interface and include no
PyTorch header, so ``nvcc`` compiles them in seconds.  Each ``.cu`` file is
compiled by its own ``nvcc`` process (all started together; a source of
:data:`SOURCE_PARTS` by one process per part), the objects are linked into
one shared library, and the library is loaded with ``ctypes``.
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
from typing import List, Optional, Tuple

import torch

BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("routing.cu", "softmax.cu", "flash_attention.cu",
           "decode_attention.cu", "sampling.cu", "gemm.cu", "device.cu")
HEADERS = ("approx_math.cuh", "launch.cuh", "wgmma.cuh")
# Sources compiled once per part, the part's number in a macro
# (``-D<macro>=<part>``): each part holds some of the source's template
# instances, so a long source builds in parallel.
SOURCE_PARTS = {"decode_attention.cu": ("FASTCAPS_DECODE_PART", 8)}
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
    h.update(repr(sorted(SOURCE_PARTS.items())).encode())
    return h.hexdigest()[:16]


def compile_units() -> List[Tuple[str, List[str]]]:
    """``(source, extra nvcc flags)`` of each ``nvcc -c``: one per source,
    one per part of a source of :data:`SOURCE_PARTS`."""
    units = []
    for name in SOURCES:
        macro, parts = SOURCE_PARTS.get(name, (None, 1))
        for part in range(parts):
            units.append((name, [f"-D{macro}={part}"] if macro else []))
    return units


def _compile(nvcc: str, out_dir: Path, tag: str) -> None:
    """One ``nvcc -c`` per compile unit (:func:`compile_units`), all
    started together, then one link; the library is published atomically
    (add ``-Xptxas -v`` to :data:`NVCC_FLAGS` to see each kernel's
    registers and spills)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    objects: List[str] = []
    for i, (name, defines) in enumerate(compile_units()):
        obj = out_dir / f"{Path(name).stem}{i}_{tag}.{os.getpid()}.o"
        objects.append(str(obj))
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", str(CSRC_DIR / name),
               "-o", str(obj)]
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
    lib.fused_routing_smem_bytes.argtypes = [i, i, i, i, i]
    lib.fused_routing_smem_bytes.restype = ctypes.c_longlong
    lib.fused_routing_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                         i, p]
    lib.fused_routing_launch.restype = i
    lib.taylor_softmax_launch.argtypes = [p, p, i, i, i, i, i, i, i, p]
    lib.taylor_softmax_launch.restype = i
    lib.taylor_softmax_bwd_launch.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                              p]
    lib.taylor_softmax_bwd_launch.restype = i
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           i, i, i, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_dequant_launch.argtypes = [p, p, p, p, p, p, i, i, i,
                                                   i, i, i, i, i, i, i, i, p]
    lib.flash_attention_dequant_launch.restype = i
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, i, i, i, i, i, i, i, i,
                                            p]
    lib.decode_attention_launch.restype = i
    lib.fused_sampling_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                          i, p]
    lib.fused_sampling_launch.restype = i
    lib.fixed_order_matmul_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.fixed_order_matmul_launch.restype = i
    lib.fastcaps_grid_limits.argtypes = [i, ctypes.POINTER(i)]
    lib.fastcaps_grid_limits.restype = i


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use and loaded once per
    process; a first use inside a CUDA graph's capture raises
    :class:`repro_torch.graphs.GraphError` (the kernels build before it)."""
    global _library
    with _lock:
        if _library is None:
            from repro_torch import graphs

            graphs.refuse_in_capture("building the kernels' library")
            tag = _source_hash()
            path = build_dir() / f"libfastcaps_{tag}.so"
            if not path.exists():
                _compile(find_nvcc(), build_dir(), tag)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _library = lib
        return _library


_raw_stream = None


def stream_query():
    """The function that gives a device's current CUDA stream handle:
    PyTorch's private raw-stream query where this build has it, which
    builds no ``torch.cuda.Stream`` object (that costs a few microseconds a
    call, as much as the kernels it would launch); else the public
    ``torch.cuda.current_stream``, which gives the same handle."""
    query = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if query is not None:
        return query
    return lambda index: torch.cuda.current_stream(index).cuda_stream


def raw_stream(device_index: int) -> int:
    """The handle of the current CUDA stream of a device, as an integer for
    a launch through ``ctypes`` (the query is bound at first use)."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = stream_query()
    return _raw_stream(device_index)


def device_grid_limits(device_index: int) -> Tuple[int, int, int]:
    """The most blocks a grid may have on axes x, y and z of card
    ``device_index``, as the device reports them
    (``cudaDeviceGetAttribute``)."""
    xyz = (ctypes.c_int * 3)()
    check_launch(load_library().fastcaps_grid_limits(int(device_index), xyz),
                 "cudaDeviceGetAttribute (grid limits)")
    return int(xyz[0]), int(xyz[1]), int(xyz[2])


def check_launch(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise KernelLaunchError(
            f"{what}: launch refused with CUDA error code {code}")


ROUTING_HINT = ("train through RoutingSpec.reference() or "
                "RoutingSpec.optimized() (as the reference package does)")
ATTENTION_HINT = ('train with attn_impl="chunked" or "reference" (as the '
                  'reference package does)')


def refuse_grad(what: str, *xs, hint: str = ROUTING_HINT) -> None:
    """A kernel without a backward (every one but ``taylor_softmax``, whose
    backward is ``taylor_softmax_bwd``).  A wrapper given a tensor that needs a
    gradient, with autograd on, raises on every device (on the CPU too,
    where its plain version could differentiate) rather than hand back an
    output the gradient cannot pass through.  ``hint`` names the plain path
    the caller should train through."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in xs):
        raise RuntimeError(
            f"{what} has no backward: {hint}, or call it under "
            f"torch.no_grad() on tensors that need no gradient")
