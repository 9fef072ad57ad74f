"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled for
Hopper (`sm_90a`) into `_build/<name>-<hash>.so` inside the package at first
use; the hash covers the source and the flags, so an edited source rebuilds
and an unchanged one is reused. Nothing here runs at import: the CPU tests
import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: __logf would move time deltas near a bucket boundary
# into the next bucket (see csrc/hstu_attention_fwd.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output, with the -Xptxas -v register/smem summary


_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use on the card's machine"
    )


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: List[str]) -> Dict[str, Built]:
    """Compile every named source that has no current library, one nvcc
    process each, all started together; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Built] = {}
    running = {}
    start = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = Built(target, 0.0, "reused " + target.name)
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        running[name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (target, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a library
        out[name] = Built(target, time.perf_counter() - start, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _load_lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name].path))
        return _loaded[name]
