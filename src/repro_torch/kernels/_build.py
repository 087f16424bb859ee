"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes one or more plain C launchers and is
compiled on its own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the repo root
(``.gitignore`` lists ``build/``). The library's file name carries a hash of
its source, so an edited kernel is rebuilt and a stale one is never loaded.
``build`` starts one ``nvcc`` per source, all at once, and waits for them.

Launchers take pointers and the stream as ``c_void_p`` and sizes as
``c_int``, launch on the given stream, allocate nothing, and return
``cudaGetLastError()``. ``launch`` is the one place that calls them: it
passes tensors as their data pointers and None as a null pointer, appends
the current stream of the tensors' device, and raises when the launcher
returns an error. A kernel module gives it the launcher's arguments and
their ctypes types, the stream left out.

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
from typing import Dict, Iterable, NamedTuple, Sequence, Set, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path
    seconds: float      # wall time of this build's nvcc (0.0 = cached)
    ptxas: str          # what -Xptxas -v reported (registers, smem, spills)


_LIBS: Dict[str, ctypes.CDLL] = {}
_TYPED: Set[Tuple[str, str]] = set()     # (library, launcher) pairs typed
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
    """The kernel's library, built on first use, with ``fn`` typed.

    A library may hold several launchers: each one is typed the first time
    it is asked for (untyped, ctypes would pass a pointer as a 32-bit C
    ``int``), and never again."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBS[name] = lib
    if (name, fn) not in _TYPED:
        launcher = getattr(lib, fn)
        launcher.argtypes = list(argtypes)
        launcher.restype = ctypes.c_int
        _TYPED.add((name, fn))
    return lib


def launch(name: str, fn: str, argtypes: Sequence, *args) -> None:
    """Call launcher ``fn`` of library ``name`` (typed with ``argtypes``
    and the stream's ``c_void_p`` on first use, as ``load`` does) on
    ``args``: a tensor passes as its data pointer, None as a null pointer,
    anything else as it is; the current stream of the first tensor's
    device goes last. Raises RuntimeError when the launcher returns a CUDA
    error."""
    lib = load(name, fn, [*argtypes, ctypes.c_void_p])
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    rc = getattr(lib, fn)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: {fn} failed with CUDA error {rc}")
