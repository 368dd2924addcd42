"""Build the CUDA kernels with nvcc and load them with ctypes.

Counterpart of ``repro/kernels/common.py`` (the layer between the
kernels and their wrappers).  Each ``csrc/<name>.cu`` exposes a plain C
launch function; at first use it is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
under ``build/``, named by a hash of its source and the shared headers
(``csrc/*.cuh``) so an edited source is rebuilt and a stale library is
never loaded.  All sources are compiled
in parallel, one nvcc each, the first time any kernel is asked for.  No
source includes PyTorch's headers, so a build takes seconds.

A wrapper passes device pointers as ``c_void_p`` and calls :func:`launch`,
which makes the tensors' device current and passes its current stream;
every launch function returns ``cudaGetLastError()`` and :func:`launch`
raises on a non-zero code.  A failed build raises; nothing falls back to
a plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # one build at a time in a process


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels cannot be built")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all at
    once.  Returns ``{name: ptxas report}`` for the sources it built."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [(s, _target(s)) for s in sources if not _target(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
            continue
        os.replace(tmp, out)
        reports[src.stem] = text
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building every stale
    source first."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    with _lock:
        build_all()
    return ctypes.CDLL(str(_target(src)))


@functools.cache
def _entry(name: str, argtypes: tuple):
    """The typed ``<name>_launch`` (``argtypes`` plus the stream) and
    ``<name>_error`` functions of ``csrc/<name>.cu``'s library."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.cache
def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(name: str, argtypes: tuple, device: torch.device, *args) -> None:
    """``<name>_launch(*args, stream)`` from ``csrc/<name>.cu`` (built and
    loaded at first use) with ``device`` current, on its current stream;
    raises with ``<name>_error``'s text on a non-zero return code."""
    fn, err = _entry(name, argtypes)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code:
        raise RuntimeError(f"{name} launch failed: " + err(code).decode())
