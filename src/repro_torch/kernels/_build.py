"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles on its own with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` -- no PyTorch headers, so a build
takes seconds.  Libraries land in ``build/kernels/`` at the repository root
(git-ignored), named by a hash of the source and the flags, and are built
at first use.  :func:`build` starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a``, ``-O3``, and deliberately no ``--use_fast_math`` and no
``-ftz=true``: MX8 scales reach 2^-133, a subnormal that flush-to-zero
would turn into a division by zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ``ptxas -v`` output (registers, shared memory, spills) per source name
PTXAS_REPORT: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


#: every source under ``csrc/`` (one library each)
SOURCES = ("mx_state_update", "mx_attention", "mx_paged_attention",
           "mx_spec_attention", "mx_quant")


class KernelBuildError(RuntimeError):
    pass


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands: named by a hash of
    the source, the shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            PTXAS_REPORT[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return paths


def builds_done() -> int:
    """How many sources this process has compiled (a serving step that
    raised it paid for a build)."""
    return len(PTXAS_REPORT)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def entry(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<source>.cu`` with its argument
    types set (``ctypes.c_void_p`` for pointers and the stream, or ctypes
    would pass them as 32-bit ints) and an ``int`` (CUDA error) result."""
    fn = getattr(load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn
