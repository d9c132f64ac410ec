"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, from the
package's sources alone, into ``src/repro_torch/_build/`` (git-ignored);
a library's file name carries a hash of its sources and flags, so an edited
source rebuilds and an unchanged one is reused. All missing libraries are
compiled together, one ``nvcc`` process each. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["LIBRARIES", "build_all", "load", "build_report"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# library name -> its source file under csrc/ (headers are hashed with all)
LIBRARIES = {
    "rm_feature": "rm_feature.cu",
    "rm_fused_attention": "rm_fused_attention.cu",
    "rm_attention_chunked": "rm_attention_chunked.cu",
    "tensor_sketch": "tensor_sketch.cu",
    "rm_fused_state": "rm_fused_state.cu",
    "rm_fused_apply": "rm_fused_apply.cu",
    "ctr_feature": "ctr_feature.cu",
    "structured_feature": "structured_feature.cu",
    "rm_feature_bucket": "rm_feature_bucket.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent compiling in this process or 0.0 if reused,
#          the compiler's output: ptxas register / shared-memory report)
_REPORT: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
        f"{CSRC} at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.name == LIBRARIES[name]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every library that is not built yet, all at once.

    Returns ``{name: path of the shared library}``.

    Raises:
        RuntimeError: nvcc is missing or a compile failed (its output is
            in the message).
    """
    paths = {name: _lib_path(name) for name in LIBRARIES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {LIBRARIES[name]} (rc {proc.returncode})"
                            f"\n{log}")
            continue
        os.replace(tmp, todo[name])
        _REPORT[name] = (time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all()[name]
        _REPORT.setdefault(name, (0.0, "(reused an earlier build)"))
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def build_report() -> Dict[str, Tuple[float, str]]:
    """``{name: (build seconds, compiler output)}`` for this process."""
    return dict(_REPORT)
