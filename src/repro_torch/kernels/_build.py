"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library's file name carries a hash of its source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds and
an unchanged one loads at once.  Builds happen at first use, never at
import; :func:`build` starts one ``nvcc`` per source in parallel.  The build directory is ``_build/`` inside the
package (git-ignored), or ``$REPRO_TORCH_BUILD_DIR``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent / "_build"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build with the CUDA toolkit (set CUDA_HOME)")
    return found


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at its current content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named sources that are not built yet, all in parallel.

    Returns {name: ptxas report} for the sources compiled by this call.
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)                 # atomic against a racing build
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str, argtypes: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.

    ``argtypes`` maps each C entry point to its ctypes argument types; they
    are set once, when the library is first loaded (every entry point
    returns an int, a CUDA error code)."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(target(name)))
        for fn_name, types in argtypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = types, ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer (None -> NULL) for a ctypes call."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a ctypes call."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
