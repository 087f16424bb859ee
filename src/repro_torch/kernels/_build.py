"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the repo root
(``.gitignore`` lists ``build/``). The library's file name carries a hash of
its source, so an edited kernel is rebuilt and a stale one is never loaded.
``build`` starts one ``nvcc`` per source, all at once, and waits for them.

Launchers take pointers and the stream as ``c_void_p`` and sizes as
``c_int``, launch on the given stream, allocate nothing, and return
``cudaGetLastError()``; the Python wrapper raises when that is not 0.

Launch counts: every wrapper calls ``count(name)`` right after its kernel
launched, and nowhere else, so a run can show that its main path went
through the kernels (``reset_launch_counts`` / ``launch_counts``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path
    seconds: float      # wall time of this build's nvcc (0.0 = cached)
    ptxas: str          # what -Xptxas -v reported (registers, smem, spills)


_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: collections.Counter = collections.Counter()


def count(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, BuildInfo]:
    """Compile every named kernel that is not built yet, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    infos = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            infos[name] = BuildInfo(out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        infos[name] = BuildInfo(out, seconds, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return infos


def load(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """The kernel's library, built on first use, with ``fn`` typed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        launcher = getattr(lib, fn)
        launcher.argtypes = list(argtypes)
        launcher.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
