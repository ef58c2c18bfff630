"""Builds the hand-written CUDA kernels of `repro_torch/kernels/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The library goes into `build/kernels/` at the root of the checkout (listed
in `.gitignore`), named by a hash of its source and of the shared headers
(`csrc/*.cuh`), so an edited kernel or header is rebuilt and an unchanged
one is built once.  Nothing is built when the package is imported: the
first launch builds what it needs, and `build_all()` builds every source at
once, one `nvcc` process each, all started together.  No
`--use_fast_math`: the kernels' numerics are held bit for bit against their
plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# what nvcc printed for each library it built (ptxas register/spill report)
build_logs: Dict[str, str] = {}


def sources() -> tuple:
    """Names of every kernel source in csrc/ (without the .cu suffix)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and $PATH); the CUDA kernels "
                           "are built from source at first use")
    return found


def _library_path(name: str) -> Path:
    """build/kernels/lib<name>-<hash>.so, the hash over the source, every
    shared header of csrc/ (*.cuh, name and content) and the flags, so an
    edited header rebuilds every library that may include it."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = None) -> Dict[str, float]:
    """Compile every named source (default: all of csrc/) that has no
    up-to-date library, one nvcc process per source, started together.
    Returns {name: seconds its build took} (0.0 for a library already
    built).  Raises RuntimeError with nvcc's output if any build fails."""
    names = tuple(sources() if names is None else names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs, seconds = {}, {}
        t0 = time.perf_counter()
        for name in names:
            out = _library_path(name)
            if out.exists():
                seconds[name] = 0.0
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return seconds


def c_function(source: str, name: str, argtypes, restype=ctypes.c_int):
    """The C function `name` of csrc/<source>.cu, with its ctypes
    signature set (pointers as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, restype
    return fn


def check_cuda(name: str, tensors) -> None:
    """Raise unless `tensors` are contiguous and on one CUDA device."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors; got devices "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def launch(name: str, fn, device, *args, what: str) -> None:
    """Call the C launcher `fn` with `args` and the current CUDA stream of
    `device` as its last argument; raise if it returns a CUDA error (a
    launch refused for its threads or shared memory never runs, and no
    synchronize reports it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc} "
                           f"({what})")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]
