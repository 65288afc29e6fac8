"""Build and bind the port's CUDA kernels.

Each source under ``horovod_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. Nothing is built when a module is imported: the
first kernel launch builds, and later launches reuse the loaded library.

Libraries land in ``build/horovod_tpu_torch/`` beside the package (the
repository's ``build/`` directory), named by a hash of the source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edit of either
rebuilds and an unchanged source is built once. A source compiles as
``PARTS`` translation units at once (``-DHVD_PART=i``, one ``nvcc -c``
each, started together), linked into one library: its kernels of each
element type build in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "horovod_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# Translation units of each source (``HVD_PART`` 0 .. PARTS-1):
# flash_attention's fp32 kernels with the C interface, its bf16 kernels and
# its fp16 kernels.
PARTS = 3

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of each library's entry points (argtypes, restype int).
SIGNATURES: Dict[str, Dict[str, List]] = {
    "flash_attention": {
        # dtype, D, B, H, Tq, Tk; q, k, v, o, lse, m, l, q_ids, k_ids,
        # id_scratch, strides; causal, q_off, k_off, window; scale; stream
        "hvd_flash_fwd": [_I] * 6 + [_P] * 11 + [_I] * 4 + [_F, _P],
        # ...; q, k, v, dout, lse, delta, dq, q_ids, k_ids, id_scratch,
        # strides; out_f32, causal, q_off, k_off, window; scale; stream
        "hvd_flash_bwd_dq": [_I] * 6 + [_P] * 11 + [_I] * 5 + [_F, _P],
        # as dq with dk, dv in place of dq
        "hvd_flash_bwd_dkv": [_I] * 6 + [_P] * 12 + [_I] * 5 + [_F, _P],
        # dtype, D -> keys per tile of the forward kernel
        "hvd_flash_fwd_key_tile": [_I] * 2,
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# The compiler's report (``-Xptxas -v``: registers, spills) of each
# library built with ``verbose``.
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
    toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by a
    hash of the source, every ``csrc/*.cuh`` header, the flags and the
    ``defines``."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join([*NVCC_FLAGS, *_macros(defines)]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _macros(defines: Sequence[str]) -> List[str]:
    return [f"-D{d}" for d in defines]


def build_commands(name: str, out: str, verbose: bool = False,
                   defines: Sequence[str] = ()) -> List[List[str]]:
    """The ``nvcc`` commands that build ``csrc/<name>.cu`` into ``out``:
    one ``-c`` per part into ``<out>.<i>.o`` (run together), then the link
    of those objects as the last command. ``defines``: macros every part
    compiles with (a check's variant of the library)."""
    nvcc, src = find_nvcc(), str(CSRC_DIR / f"{name}.cu")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{out}.{i}.o" for i in range(PARTS)]
    cmds = [[nvcc, *compile_flags, *ptxas, *_macros(defines),
             f"-DHVD_PART={i}", "-c", "-o", o, src]
            for i, o in enumerate(objs)]
    return cmds + [[nvcc, *NVCC_FLAGS, "-o", out, *objs]]


def _run(cmd: List[str], name: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    return proc.stderr


def build(name: str, verbose: bool = False, defines: Sequence[str] = ()
          ) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists.

    The compiler writes to a temporary file that is renamed into place,
    so processes that build at once never load a half-written library.
    ``verbose`` adds ``-Xptxas -v`` and keeps its report in BUILD_LOG.
    ``defines`` builds a variant of the library (``build_commands``),
    which ``load`` never returns.
    """
    from concurrent.futures import ThreadPoolExecutor

    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    *parts, link = build_commands(name, tmp, verbose, defines)
    try:
        with ThreadPoolExecutor(max_workers=max(1, len(parts))) as pool:
            logs = list(pool.map(lambda c: _run(c, name), parts))
        logs.append(_run(link, name))
        if verbose and not defines:
            BUILD_LOG[name] = "".join(logs)
        os.replace(tmp, out)
    finally:
        for path in [tmp] + [f"{tmp}.{i}.o" for i in range(len(parts))]:
            if os.path.exists(path):
                os.unlink(path)
    return out


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` per source."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(lambda n: build(n, verbose), names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = bind(name, build(name))
        return lib


def bind(name: str, path: Path) -> ctypes.CDLL:
    """The library at ``path`` (built from ``csrc/<name>.cu``) with its C
    signatures set."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hvd_error_string.argtypes = [ctypes.c_int]
    lib.hvd_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero return from a launcher (a cudaError_t, or -1
    for a dtype/head-dim pair the library was not built for)."""
    if err == 0:
        return
    if err == -1:
        raise ValueError(f"{what}: unsupported dtype/head dim")
    raise RuntimeError(f"{what}: CUDA error {err} "
                       f"({lib.hvd_error_string(err).decode()})")
