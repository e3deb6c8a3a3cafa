"""Build and load the port's CUDA kernels (``core/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface under ``build/segmm_torch_kernels/`` at the
root of the checkout, and loaded with ``ctypes``. Nothing is built when this
module is imported: the first call to :func:`load_library` builds every
source, one ``nvcc`` process each, all started together, and later calls
reuse the libraries whose file name carries the hash of their sources. A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "segmm_torch_kernels"
SOURCES = ("two_block_attention", "proj_two_block_attention",
           "two_block_attention_bwd", "proj_two_block_attention_bwd",
           "masked_attention", "masked_attention_bwd",
           "dual_stream_attention", "dual_stream_attention_bwd",
           "layer_stream", "layer_stream_bwd", "proj_two_block_attention_v2",
           "proj_two_block_attention_v2_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build printed (ptxas register / shared-memory report), for
# chip_smoke.py to show
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in paths.items() if not p.exists()]
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources first
    if needed."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = ctypes.CDLL(str(p))
        return _libs[name]
