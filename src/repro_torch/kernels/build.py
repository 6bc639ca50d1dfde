"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (or up front through ``build()``), one ``nvcc`` per
source, all started together, into ``build/repro_torch_kernels/`` at the
repository root. A library's file name carries a digest of its sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
KERNELS = ("gossip_mix", "gossip_mix_sparse", "gossip_mix_quant",
           "flash_attention", "flash_attention_tc", "moe_router",
           "moe_route_slots", "ssd_chunk_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point and argument types of each library; every entry returns
# cudaGetLastError() after its launch (0 = success)
SIGNATURES = {
    "gossip_mix": ("gossip_mix_launch",
                   (_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _P)),
    "gossip_mix_sparse": ("gossip_mix_sparse_launch",
                          (_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P)),
    "gossip_mix_quant": ("gossip_mix_quant_launch",
                         (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I,
                          _I, _P)),
    "flash_attention": ("flash_attention_launch",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                         _L, _L, _L, _L, _L, _I, _I, _I, _P)),
    "flash_attention_tc": ("flash_attention_tc_launch",
                           (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                            _L, _L, _L, _L, _L, _L, _I, _I, _P)),
    "moe_router": ("moe_router_launch", (_P, _P, _P, _I, _I, _I, _I, _P)),
    "moe_route_slots": ("moe_route_slots_launch",
                        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I,
                         _P)),
    "ssd_chunk_tc": ("ssd_chunk_tc_launch",
                     (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                      _L, _L, _L, _L, _P)),
}

# Second entry points of a library, picked by ``load`` when a call passes
# their number of arguments: the SIMT flash kernel's split launch (its
# scratch and split count after the dtype code; ``ops.flash_simt_splits``)
VARIANTS = {
    "flash_attention": ("flash_attention_split_launch",
                        SIGNATURES["flash_attention"][1][:-1] + (_P, _I, _P)),
}

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all at once. Returns ``{name: {"seconds",
    "cached", "log"}}`` where ``log`` is ptxas's register and spill report.
    Raises ``RuntimeError`` with the compiler's output if any build
    fails. The report is kept beside each library (``.log``), so a cached
    library reports it too."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, jobs = {}, {}
    nvcc = None
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "log": log.read_text() if log.exists() else ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    try:
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode}):"
                              f"\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            report[name] = {"seconds": secs, "cached": False, "log": log}
    finally:                       # a timeout or an interrupt: stop them all
        for proc, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return report


def load(name: str, nargs: int | None = None):
    """The C entry point of kernel ``name`` as a ctypes function with its
    argument types declared, building the library first if needed.
    ``nargs`` (the arguments a call passes, the stream included) picks the
    entry in ``VARIANTS`` where it is that entry's count."""
    variant = name in VARIANTS and nargs == len(VARIANTS[name][1])
    key = (name, nargs) if variant else name
    fn = _loaded.get(key)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        symbol, argtypes = VARIANTS[name] if variant else SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[key] = fn
    return fn
