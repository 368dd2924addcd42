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

:func:`scratch` keeps the kernels' cross-block scratch buffers, one per
kernel, device and stream, zeroed once when made: a kernel that keeps
its bookkeeping there (epochs, tickets, counters) needs no fill before a
call, and calls on two streams never share one.
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
def symbol(name: str, fn_name: str, argtypes: tuple, restype):
    """The typed function ``fn_name`` of ``csrc/<name>.cu``'s library."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


@functools.cache
def _entry(name: str, argtypes: tuple):
    """The typed ``<name>_launch`` (``argtypes`` plus the stream) and
    ``<name>_error`` functions of ``csrc/<name>.cu``'s library."""
    return (symbol(name, f"{name}_launch", (*argtypes, ctypes.c_void_p),
                   ctypes.c_int),
            symbol(name, f"{name}_error", (ctypes.c_int,), ctypes.c_char_p))


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


_scratch: dict = {}  # (kernel, device, stream) -> tensor
# Buffers replaced by a larger one or dropped: a CUDA graph may have
# captured their address, so they stay allocated for the process's life.
_retired: list = []


def stream_key(device: torch.device) -> int:
    """The handle of ``device``'s current stream."""
    return torch.cuda.current_stream(device).cuda_stream


def scratch(kernel: str, device: torch.device, numel: int,
            dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The scratch of ``kernel`` on ``device``'s current stream, of at
    least ``numel`` elements, zeros when made.  It is not made while the
    stream captures a CUDA graph: that raises, and the caller warms the
    kernel up on the stream first (at this size or larger)."""
    key = (kernel, device, stream_key(device))
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{kernel}: no scratch of {numel} elements for the "
                "capturing stream; call the kernel once on that stream, at "
                "this size or larger, before capturing")
        if buf is not None:
            _retired.append(buf)
        buf = _scratch[key] = torch.zeros(numel, dtype=dtype, device=device)
    return buf


def drop_scratch(kernel: str, device: torch.device) -> None:
    """Forget ``kernel``'s scratch on the current stream (after a launch
    that raised, whose effect on it is unknown): the next call starts on
    a fresh zeroed one."""
    buf = _scratch.pop((kernel, device, stream_key(device)), None)
    if buf is not None:
        _retired.append(buf)
