"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``):
``ota_superpose``, ``ota_quantize_superpose``, ``topk_cosine``,
``flash_attention``, ``fake_quant``, ``ota_aggregate`` and ``qmatmul``.

Each source compiles on its own, at first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into a shared library with a plain C interface under ``build/repro_torch/``
at the repository root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads from the cache. The library is loaded with ``ctypes``;
the wrappers pass pointers and the stream as ``c_void_p`` and each C entry
point returns ``cudaGetLastError()`` after its launch. No fast-math flag:
the kernels' parity rests on IEEE f32 arithmetic.

``launch`` calls an entry point on the current stream of a tensor's device
(``torch.cuda.stream(...)`` contexts included) with as little host work as
it can: the raw stream pointer from ``torch._C``, and no device switch when
that device is already current.

``build_all`` starts one ``nvcc`` per source, all at once, and waits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float

# C signatures of the entry points, per source
SIGNATURES = {
    "ota_superpose": {
        "ota_superpose_launch": [_P, _I, _I, _L, _L, _P, _L, _L, _P, _P, _P, _P, _I, _P],
    },
    "ota_quantize_superpose": {
        "ota_quantize_superpose_launch": [_P, _I, _L, _I, _P, _P, _P, _U, _P, _P, _P, _L, _P, _I,
                                          _I, _P],
        "ota_quantize_superpose_blocks_per_sm": [_I, _I],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
        "flash_attention_design": [_I, _I],
    },
    "topk_cosine": {
        "topk_cosine_launch": [_P, _I, _I, _P, _I, _P, _I, _L, _L, _I, _P, _P, _P],
    },
    "fake_quant": {
        "fake_quant_launch": [_P, _I, _L, _P, _P, _F, _P, _I, _P],
    },
    "ota_aggregate": {
        "ota_aggregate_launch": [_P, _I, _L, _P, _P, _P, _F, _P, _I, _P],
    },
    "qmatmul": {
        "qmatmul_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "qmatmul_design": [_I, _I, _I, _P],
        "qmatmul_decode_clusters": [_I, _I, _I, _I],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# the last build's wall seconds and ptxas report per source
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def build_dir() -> pathlib.Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(d) if d else REPO_ROOT / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str, verbose: bool) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.repro_name, proc.repro_tmp, proc.repro_out = name, tmp, out  # type: ignore[attr-defined]
    proc.repro_t0 = time.perf_counter()  # type: ignore[attr-defined]
    return proc


def _finish(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    name = proc.repro_name  # type: ignore[attr-defined]
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - proc.repro_t0,  # type: ignore[attr-defined]
        "log": log,
    }
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(proc.repro_tmp, proc.repro_out)  # type: ignore[attr-defined]


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def sources() -> List[str]:
    return sorted(SIGNATURES)


def build_all(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every source not yet in the cache, in parallel; load all."""
    with _LOCK:
        procs = [p for p in (_start(n, verbose) for n in sources()) if p is not None]
        errors = []
        for p in procs:
            try:
                _finish(p)
            except RuntimeError as e:  # report every failed source, then raise
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in sources():
            if n not in _LIBS:
                _LIBS[n] = _load(n)
        return dict(_LIBS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            if name not in _LIBS:
                proc = _start(name, False)
                if proc is not None:
                    _finish(proc)
                _LIBS[name] = _load(name)
            lib = _LIBS[name]
    return lib


def on_card(t) -> bool:
    """True where a wrapper launches its kernel (a CUDA tensor), False where
    it runs its plain version (a CPU tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch(fn, index: int, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with the raw pointer of
    the current stream of CUDA device ``index`` and raise on the
    ``cudaError_t`` it returns. Enters ``torch.cuda.device(index)`` only
    where another device is current (a kernel launches on the current
    device)."""
    if torch._C._cuda_getDevice() == index:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc} at launch")
