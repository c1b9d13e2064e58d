"""Build the port's CUDA sources (`shallowspeed_tpu_torch/csrc/*.cu`)
with nvcc into shared libraries with a plain C interface, load them
with ctypes, and launch their C entries (`launch`).

A library is built at first use into `csrc/_build/` (listed in
.gitignore), keyed by a hash of its source, the shared `*.cuh` headers
and the flags, so a fresh
checkout builds what it runs and an edited source rebuilds. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
# sm_90a, not sm_90: Hopper's wgmma/setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# compiler output (registers, shared memory, spills from -Xptxas -v) of
# the builds this process ran, by source name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # the toolkit's conventional home when its bin/ is not on PATH
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "shallowspeed_tpu_torch are built on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    # the shared headers are part of every source's key
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so"


def _compile(name: str) -> Path:
    src, so = _target(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stdout}"
                           f"{r.stderr}")
    build_logs[name] = r.stdout + r.stderr
    os.replace(tmp, so)      # atomic: a reader never sees half a library
    return so


def build(names) -> None:
    """Compile every named source that is not built yet, one nvcc each,
    all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for f in [ex.submit(_compile, n) for n in names]:
            f.result()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_compile(name)))
        _loaded[name] = lib
    return lib


def launch(wrapper, entry, error_string, device, *args) -> None:
    """Call the C entry `entry(*args, stream)` on `device`'s current
    stream, raise on a non-zero return (the launch's cudaGetLastError),
    and add one to `wrapper.launches`: the one place a wrapper counts."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: "
                           f"{error_string(rc).decode()}")
    wrapper.launches += 1
