"""Kernel runtime: build, load and launch-count the port's CUDA kernels.

Counterpart of ``repro.kernels.runtime.resolve_interpret``, without its knob:
where a tensor lies decides the path. A CPU tensor goes through the kernel's
plain PyTorch version; a CUDA tensor goes through the hand-written kernel or
the call raises. There is no switch that sends a CUDA tensor to the plain
version.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/repro_torch/<hash of the sources>/`` at the root of the checkout, and
loaded with ``ctypes``. Every C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; the wrapper raises on a non-zero
code. A failed build raises; it never degrades to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
_REPO_ROOT = _KERNELS_DIR.parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "repro_torch"

# kernel library -> its source, relative to this directory
SOURCES = {
    "decode_paged": "flash_attention/csrc/decode_paged.cu",
    "qkv_rope_paged": "fused_decode/csrc/qkv_rope_paged.cu",
    "oproj_ffn_swiglu": "fused_decode/csrc/oproj_ffn_swiglu.cu",
    "flash_decode": "flash_attention/csrc/decode.cu",
    "qkv_rope": "fused_decode/csrc/qkv_rope.cu",
    "ffn_swiglu": "fused_decode/csrc/ffn_swiglu.cu",
    "flash_prefill": "flash_attention/csrc/prefill.cu",
    "lru_scan": "lru_scan/csrc/lru_scan.cu",
    "monarch_fused": "monarch_fft/csrc/monarch.cu",
    "monarch_conv_fused": "monarch_fft/csrc/monarch_conv.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
_launches: Dict[str, int] = {name: 0 for name in SOURCES}


# ---------------------------------------------------------------- launches
def count_launch(name: str) -> None:
    """Called by a wrapper right after it launched its kernel, and nowhere
    else: the count shows that a run went through the kernel."""
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launches() -> None:
    for k in _launches:
        _launches[k] = 0


# ---------------------------------------------------------------- dispatch
def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the kernel),
    False when every tensor lies on the CPU (use the plain version). Mixed
    or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel inputs on mixed/unsupported devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    """The kernels index dense row-major arrays with 16-byte vector loads."""
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must start on a 16-byte boundary")


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        lib = _libs[name]
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------------- build
def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            path = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_KERNELS_DIR.rglob("*.cu*")):
        h.update(str(p.relative_to(_KERNELS_DIR)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / source_hash() / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel libraries (all by default) that are not built
    yet, one ``nvcc`` per source, all started together. Returns each
    library's ``-Xptxas -v`` report (registers, shared memory, spills), kept
    beside it from the build that made it."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    nvcc = _nvcc() if todo else ""
    procs = {}
    for n in todo:
        out = _lib_path(n)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_KERNELS_DIR / "csrc"),
               "-o", str(tmp), str(_KERNELS_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    logs = {n: _lib_path(n).with_suffix(".log") for n in names}
    return {n: p.read_text() if p.exists() else "" for n, p in logs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """One C entry point of library ``name`` with its argument types set
    (``c_void_p`` for every pointer and the stream, ``c_int`` for ints)."""
    key = (name, symbol)
    if key not in _fns:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
