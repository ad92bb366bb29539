"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, which ``ctypes`` loads.  The library lands in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named after a hash of its source, the headers it includes and the flags,
so an edited source or header rebuilds and an unchanged one is built
once.  Nothing here runs at import time: the first launch builds, and
``build()`` starts every compiler at once when a caller wants all kernels
ready up front.

``note_launch`` is the one place a wrapper counts a launch of its kernel
(and, for a kernel that loops, the hops or rounds of the launch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("pack_flush", "chain_order", "quant_pack", "flash_attention",
           "flash_attention_bwd", "hash_probe")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
SIGNATURES: Dict[str, Dict[str, List]] = {
    "pack_flush": {
        "pack_rows_grouped_launch": [_P, _INT, _P, _P, _P],
        "scatter_rows_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _P],
    },
    # the chain kernels' last arguments but the stream: the packed
    # layout's n_shards (0: the global layout), seg_rows and its host
    # offsets (null for the router's partition)
    "chain_order": {
        "jump_double_launch": [_P, _P, _P, _P, _P, _P, _I64, _INT, _INT,
                               _INT, _INT, _P, _P],
        "walk_segments_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                 _I64, _INT, _INT, _INT, _INT, _INT, _INT,
                                 _INT, _INT, _P, _P],
        "expand_segments_launch": [_P, _P, _P, _P, _P, _I64, _I64, _INT,
                                   _INT, _INT, _P, _P],
        "gather_next_launch": [_P, _P, _INT, _P, _I64, _I64, _INT, _P, _P,
                               _INT, _INT, _P, _P],
    },
    "quant_pack": {
        "quantize_blockwise_launch": [_P, _P, _P, _I64, _P],
        "dequantize_blockwise_launch": [_P, _P, _P, _I64, _INT, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                   _INT, _INT, _INT, _F32, _INT, _F32, _INT,
                                   _P],
        "flash_attention_smem_bytes": [_INT, _INT],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I64, _I64, _I64, _INT, _INT,
                                       _INT, _F32, _INT, _F32, _INT, _INT,
                                       _P],
        "flash_attention_bwd_smem_bytes": [_INT, _INT, _INT],
    },
    "hash_probe": {
        "probe_launch": [_P, _P, _P, _P, _I64, _I64, _P],
        "probe_grouped_launch": [_P, _P, _P, _P, _P, _I64, _P, _I64, _I64,
                                 _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def note_launch(wrapper, size: int, steps: Optional[int] = None) -> None:
    """Count one launch of ``wrapper``'s kernel: ``wrapper.launches`` and
    ``wrapper.sizes``, a histogram of the launch's main dimension (rows,
    lanes, queries) keyed by that size rounded up to a power of two.  A
    kernel that loops (``gather_next``'s hops, ``jump_double``'s rounds)
    also counts ``steps`` in ``wrapper.steps[size key][steps]``."""
    wrapper.launches += 1
    key = 1 << max(0, int(size) - 1).bit_length()
    wrapper.sizes[key] = wrapper.sizes.get(key, 0) + 1
    if steps is not None:
        by = wrapper.steps.setdefault(key, {})
        by[steps] = by.get(steps, 0) + 1


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    directly or through another header, each once."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers it
    includes and the flags: an edit to any of them builds anew."""
    data = b"".join(p.read_bytes() for p in sources(name))
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all
    compilers started together.  Returns {name: seconds} for the ones it
    built; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen, float]] = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT),
                      time.perf_counter()))
    took: Dict[str, float] = {}
    failed = []
    for name, out, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), its entry points
    typed from SIGNATURES."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
