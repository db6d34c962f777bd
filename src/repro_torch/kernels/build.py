"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles on its own into a shared library with a plain C
interface, ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``, and is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds, not
the minutes of ``torch.utils.cpp_extension.load``). Libraries land in
``build/repro_torch/`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides it) under a name that carries a hash of the sources and flags:
a changed source rebuilds, an unchanged one loads the library already
there. ``build_all`` starts one ``nvcc`` per stale source, all at once.

Nothing here runs at import time. A failed build raises; no caller falls
back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# dynamic shared memory one thread block may use on Hopper (sm_90)
MAX_SMEM_BYTES = 227 * 1024

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas's per-kernel report (registers, shared memory, spills) of the
# builds this process ran, by source stem
build_log: Dict[str, str] = {}


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_TORCH_BUILD_DIR")
                        or _REPO_ROOT / "build" / "repro_torch")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the repro_torch CUDA "
                       "kernels); put the CUDA toolkit on PATH or set "
                       "CUDA_HOME")


def sources() -> List[str]:
    """Stems of the kernel sources, e.g. ``["segment_mm", "traversal"]``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(stem: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all(stems: Optional[Sequence[str]] = None) -> float:
    """Compile every stale source in parallel; returns the wall seconds.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    stems = list(stems) if stems is not None else sources()
    t0 = time.perf_counter()
    todo = [(s, _library_path(s)) for s in stems
            if not _library_path(s).exists()]
    if not todo:
        return 0.0
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for stem, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log[stem] = log
        if p.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {p.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(stem: str, signatures: Dict[str, Sequence],
         sizes: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns an ``int`` (a ``cudaError_t``), except those named in
    ``sizes``, which return a byte count (``long long``)."""
    lib = _loaded.get(stem)      # the per-launch path takes no lock
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(stem)
        if lib is not None:
            return lib
        path = _library_path(stem)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_longlong if name in sizes else ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _loaded[stem] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def check_args(kernel: str, device, **named) -> None:
    """Every named ``(tensor, dtype)`` pair lies on ``device`` with the dtype
    the kernel reads (``None`` tensors are skipped); raises otherwise."""
    for name, (t, dtype) in named.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, the "
                            f"kernel takes {dtype}")
