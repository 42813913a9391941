"""Build step for the port's compiled code: the CUDA kernels and the host
library.

Each CUDA source under ``csrc/`` (``digest.cu``, ``boxgame.cu``,
``vectorwar.cu``) is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The host library
is the port's native host code (the input codec and message framing, the
endpoint datapath, the sync core, the session bank and the batched socket
datapath), compiled by ``g++`` from the package's own
``csrc/host/codec.cpp``, ``endpoint.cpp``, ``sync_core.cpp``,
``session_bank.cpp`` and ``net_batch.cpp`` (with ``wire_common.h``) into
ONE library: the bank calls the endpoint, sync-core and socket entry
points of the same shared object.  These sources began as copies of the
JAX package's native tree, code unchanged, and are the port's to change:
nothing checks that the two trees stay byte-equal.  The copy gives the port
ownership of its sources, not an independent check of them: the
cross-package tests (``tests/test_torch_native*.py``,
``test_torch_host_bank.py``, ``test_torch_bank_faults.py``) hold a
library compiled from these sources against the JAX package's library
compiled from its own, on the same inputs, so while the code of the two
trees is the same a fault in it shows on both sides and passes; those
tests catch a change of behaviour once the trees diverge.  Builds happen at first use into
``_build/`` beside this file (listed in ``.gitignore``); each library's file
name carries a hash of every source and header it is built from and of the
flags, so an edited source is rebuilt and never mixed up with an old
library.  A library is written to a temporary file and moved into place, so
processes that build at the same time never load a torn file.  A failed
build raises with the compiler's output.

``GGRS_NATIVE_SANITIZE`` selects an instrumented host library, as it does
for the JAX package's loader: ``1`` (or ``address``, or any other non-empty
value) builds ASan+UBSan, ``thread`` builds TSan.  The variant's file name
says which (``libggrs_host_san-<hash>.so``, ``libggrs_host_tsan-<hash>.so``)
and its hash covers the flags, so it never stands in for the production
library.  A process that loads a sanitized library must have the
sanitizer's runtime preloaded (``LD_PRELOAD``), or it aborts;
``scripts/port_build_sanitized.sh`` runs the port's tests that way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
HOST_DIR = _PKG / "csrc" / "host"

SOURCES: Dict[str, Path] = {
    "digest": _PKG / "csrc" / "digest.cu",
    "boxgame": _PKG / "csrc" / "boxgame.cu",
    "vectorwar": _PKG / "csrc" / "vectorwar.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_NVCC_TIMEOUT_S = 600

# the host library: every translation unit of csrc/host/ in one shared object
HOST_SOURCES = tuple(
    HOST_DIR / n
    for n in ("codec.cpp", "endpoint.cpp", "sync_core.cpp", "session_bank.cpp", "net_batch.cpp")
)
HOST_HEADERS = (HOST_DIR / "wire_common.h",)
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
HOST = "host"
# the instrumented variants: file-name suffix and the flags in place of -O2
# (the JAX package's net/_native.py flags)
SANITIZE: Dict[str, tuple] = {
    "address": ("_san", ("-O1", "-g", "-fsanitize=address,undefined",
                         "-fno-sanitize-recover=all")),
    "thread": ("_tsan", ("-O1", "-g", "-fsanitize=thread")),
}
_GXX_TIMEOUT_S = 300

# name -> loaded library; name -> the compiler's output of the build
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """A compiler (nvcc or g++) is missing or refused a source."""


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every named source that has no library yet, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {_NVCC_TIMEOUT_S} s"
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def sanitize_mode(sanitize: Optional[str] = None) -> Optional[str]:
    """The host library variant: ``"address"``, ``"thread"`` or None (the
    production library).  ``sanitize`` None reads ``GGRS_NATIVE_SANITIZE``;
    an empty string asks for the production library whatever it says."""
    value = os.environ.get("GGRS_NATIVE_SANITIZE") if sanitize is None else sanitize
    if not value:
        return None
    return "thread" if value == "thread" else "address"


def host_flags(sanitize: Optional[str] = None) -> tuple:
    """The ``g++`` flags of the host library variant (see ``sanitize_mode``)."""
    mode = sanitize_mode(sanitize)
    if mode is None:
        return HOST_FLAGS
    return (*SANITIZE[mode][1], *HOST_FLAGS[1:])


def host_library_path(sanitize: Optional[str] = None) -> Path:
    flags = host_flags(sanitize)
    h = hashlib.sha256()
    for src in HOST_SOURCES + HOST_HEADERS:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(flags).encode())
    mode = sanitize_mode(sanitize)
    suffix = SANITIZE[mode][0] if mode else ""
    return BUILD_DIR / f"libggrs_host{suffix}-{h.hexdigest()[:12]}.so"


def build_host(sanitize: Optional[str] = None) -> float:
    """Compile the host library variant (see ``sanitize_mode``) with ``g++``
    unless it is built already.  Returns the wall seconds spent (0.0 when
    nothing was built)."""
    path = host_library_path(sanitize)
    if path.exists():
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError(
            "g++ not found on PATH; the port's host library is built from "
            "csrc/host/*.cpp at first use"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(prefix="libggrs_host-", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *host_flags(sanitize), "-o", tmp, *map(str, HOST_SOURCES)]
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=_GXX_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired as e:
        os.unlink(tmp)
        raise KernelBuildError(f"g++ timed out after {_GXX_TIMEOUT_S} s\n{e.output or ''}")
    build_logs[HOST] = proc.stdout
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"host library build failed: g++ exited {proc.returncode}\n{proc.stdout}"
        )
    os.replace(tmp, path)
    return time.perf_counter() - t0


def load_host(sanitize: Optional[str] = None) -> ctypes.CDLL:
    """The loaded host library variant (see ``sanitize_mode``), building it
    first if needed."""
    key = f"{HOST}:{sanitize_mode(sanitize) or ''}"
    lib = _loaded.get(key)
    if lib is None:
        build_host(sanitize)
        lib = ctypes.CDLL(str(host_library_path(sanitize)))
        _loaded[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed: the
    first build compiles every source that has no library yet, all at once,
    so a process pays for one ``nvcc`` wall time, not one per library."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
