"""Build and load the port's CUDA kernels (``core/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface under ``build/segmm_torch_kernels/`` at the
root of the checkout, and loaded with ``ctypes``. A library may have parts,
``csrc/<name>.<part>.cu``, that hold some of its template instantiations:
then each file is compiled to an object and the objects are linked, so that
one long compile is cut into several that run side by side. The sources
of ``COMMON`` (the key-chunk paths of the bf16 and fp32 attention cores,
and the bf16 core's forward, which three libraries run) are compiled once
into objects that the libraries launching their kernels link. Nothing is
built when this module is imported: the first call to :func:`load_library`
builds every library, one ``nvcc`` process a file, all started together;
each library takes its final name as soon as it links, and later calls
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
import time
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
# compiled once, each linked into the libraries that launch its kernels:
# the key-chunk paths of the bf16 two-block core and of the fp32 3xTF32
# core, and the bf16 core's forward (K2f, K4f, K4b's recompute; the
# libraries declare it extern)
COMMON = {
    "two_block_chunked": (
        "proj_two_block_attention", "proj_two_block_attention_bwd",
        "dual_stream_attention", "dual_stream_attention_bwd",
        "layer_stream", "layer_stream_bwd", "proj_two_block_attention_v2",
        "proj_two_block_attention_v2_bwd"),
    "tf32_chunked": (
        "two_block_attention", "two_block_attention_bwd",
        "masked_attention", "masked_attention_bwd"),
    "k2_core_fwd": (
        "proj_two_block_attention", "layer_stream", "layer_stream_bwd")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# compiling a library's parts to objects: the same without -shared
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build printed (ptxas register / shared-memory report), how
# long each library took and when each of its files' compiles ended (from
# the library's start), for chip_smoke.py to show
build_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}
part_seconds: Dict[str, Dict[str, float]] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _files(name: str):
    """A library's source and its parts."""
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob(f"{name}.*.cu"))


def _common_files(lib=None):
    """The COMMON sources, or those library ``lib`` links."""
    return [CSRC / f"{c}.cu" for c, libs in COMMON.items()
            if lib is None or lib in libs]


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + _files(name) + _common_files(name):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, out: Path, common=None, publish=None):
    """Start building ``csrc/<name>.cu`` (and its parts) into the library
    ``out``, linked with the objects of ``common`` (a thread that compiles
    the COMMON objects, and the paths of those this library links), then
    renames it ``publish``; returns a thread and a dict that holds nvcc's
    exit code, its output and the seconds it took once the thread has
    ended. Without ``common``, compiles ``csrc/<name>.cu`` to the object
    ``out``."""
    res = {"code": 0, "text": "", "seconds": 0.0, "parts": {}}
    files = _files(name)
    inc = ("-I", str(CSRC))
    t0 = time.perf_counter()

    def run(cmds, labels):
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [""] * len(procs)

        def wait(i):
            outs[i] = procs[i].communicate()[0]
            res["parts"][labels[i]] = time.perf_counter() - t0
        waits = [threading.Thread(target=wait, args=(i,))
                 for i in range(len(procs))]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        for proc, out in zip(procs, outs):
            res["text"] += out
            res["code"] = res["code"] or proc.returncode

    def go():
        compile_and_link()
        res["seconds"] = time.perf_counter() - t0
        if publish is not None and not res["code"]:
            os.replace(out, publish)

    def compile_and_link():
        if common is None:
            run([[_nvcc(), *COMPILE_FLAGS, "-c", *inc, "-o", str(out),
                  str(files[0])]], [files[0].name])
            return
        objs = [out.with_suffix(f".{i}.o") for i in range(len(files))]
        run([[_nvcc(), *COMPILE_FLAGS, "-c", *inc, "-o", str(o),
              str(f)] for o, f in zip(objs, files)], [f.name for f in files])
        thread, (cres, cobjs) = common
        thread.join()
        if cres["code"]:
            res["code"] = cres["code"]
        if not res["code"]:
            run([[_nvcc(), "-shared", "-o", str(out), *map(str, objs),
                  *map(str, cobjs)]], ["link"])
        for o in objs:
            o.unlink(missing_ok=True)
    thread = threading.Thread(target=go)
    thread.start()
    return thread, res


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    tag = f"{os.getpid()}"
    cobjs = [BUILD_DIR / f"{c}.{tag}.o" for c in COMMON]
    cjobs = [_start_build(c, o) for c, o in zip(COMMON, cobjs)]
    cres = {"code": 0, "text": "", "seconds": 0.0}

    def common_done():
        for (thread, res) in cjobs:
            thread.join()
            cres["text"] += res["text"]
            cres["code"] = cres["code"] or res["code"]
    cthread = threading.Thread(target=common_done)
    cthread.start()
    jobs = {}
    for n in todo:
        linked = [o for c, o in zip(COMMON, cobjs) if n in COMMON[c]]
        tmp = paths[n].with_suffix(f".{tag}.tmp")
        jobs[n] = _start_build(n, tmp, (cthread, (cres, linked)), paths[n])
    failed = []
    for n, (thread, res) in jobs.items():
        thread.join()
        build_log[n] = res["text"]
        build_seconds[n] = res["seconds"]
        part_seconds[n] = res["parts"]
        if res["code"]:
            failed.append(f"{n}.cu (exit {res['code']}):\n{res['text']}")
    cthread.join()
    for c, o in zip(COMMON, cobjs):
        o.unlink(missing_ok=True)
    build_log["+".join(COMMON)] = cres["text"]
    if cres["code"]:
        failed.append(f"{'+'.join(COMMON)}.cu (exit {cres['code']}):\n"
                      f"{cres['text']}")
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
