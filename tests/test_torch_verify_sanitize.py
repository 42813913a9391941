"""The sanitize switch of the port's host library (``_build.sanitize_mode``):
the library's name, path and flags for each mode, and a short bank drive on
the ASan+UBSan build in a subprocess under ``LD_PRELOAD``, bitwise equal to
the same drive on the production build and free of sanitizer reports.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path


import ggrs_tpu_torch._build as tbuild

ROOT = Path(__file__).resolve().parents[1]

# a short seeded bank drive on lossy in-memory networks: prints which host
# library the process loaded and a digest of every request list, event,
# frame and wire byte
DRIVE = r"""
import hashlib, random, sys
sys.path.insert(0, sys.argv[1])
from ggrs_tpu_torch import _build
from ggrs_tpu_torch.core import Local, Remote
from ggrs_tpu_torch.core.config import Config
from ggrs_tpu_torch.net import InMemoryNetwork, _native
from ggrs_tpu_torch.parallel.host_bank import HostSessionPool
from ggrs_tpu_torch.sessions import SessionBuilder

clock = [0]
h = hashlib.sha256()
pool = HostSessionPool()
nets = []
for m in range(3):
    net = InMemoryNetwork(seed=77 + m, loss=0.08, duplicate=0.04, reorder=0.15, latency_ticks=1)
    # every datagram any socket sends, per datagram or batched
    net._send = lambda src, dst, data, send=net._send: (h.update(bytes(data)), send(src, dst, data))[1]
    nets.append(net)
    names = (f"A{m}", f"B{m}")
    for me in (0, 1):
        b = (SessionBuilder(Config.for_uint(16)).with_clock(lambda: clock[0])
             .with_rng(random.Random(3 + 5 * m + me))
             .add_player(Local(), me).add_player(Remote(names[1 - me]), 1 - me))
        pool.add_session(b, net.socket(names[me]))
assert pool.native_active
n = 6
for i in range(60):
    clock[0] += 16
    pool.stage_inputs([(idx, idx % 2, (i * 7 + 3 * idx) % 16) for idx in range(n)])
    reqs = pool.advance_all()
    for idx in range(n):
        for r in reqs[idx]:
            kind = type(r).__name__
            if kind == "SaveGameState":
                r.cell.save(r.frame, None, None)
                h.update(f"S{r.frame}".encode())
            elif kind == "AdvanceFrame":
                h.update(repr([(v, st.name) for v, st in r.inputs]).encode())
            else:
                h.update(f"{kind}{r.frame}".encode())
        h.update(repr([repr(e) for e in pool.events(idx)]).encode())
        h.update(f"{pool.current_frame(idx)},{pool.last_confirmed_frame(idx)}".encode())
    for net in nets:
        net.tick()
print(_native.bank_lib()._name)
print(pool.crossings, pool.fast_slot_ticks > 0)
print(h.hexdigest())
"""


def test_library_name_path_and_flags_per_mode(monkeypatch):
    monkeypatch.delenv("GGRS_NATIVE_SANITIZE", raising=False)
    prod = tbuild.host_library_path()
    assert prod.parent == tbuild.BUILD_DIR and prod.name.startswith("libggrs_host-")
    assert tbuild.host_flags() == tbuild.HOST_FLAGS == ("-O2", "-shared", "-fPIC", "-std=c++17")
    want = {
        "address": ("_san", ("-O1", "-g", "-fsanitize=address,undefined",
                             "-fno-sanitize-recover=all", "-shared", "-fPIC", "-std=c++17")),
        "thread": ("_tsan", ("-O1", "-g", "-fsanitize=thread", "-shared", "-fPIC",
                             "-std=c++17")),
    }
    for value, mode in (("1", "address"), ("address", "address"), ("yes", "address"),
                        ("thread", "thread")):
        suffix, flags = want[mode]
        assert tbuild.sanitize_mode(value) == mode
        assert tbuild.host_flags(value) == flags
        path = tbuild.host_library_path(value)
        assert path.parent == tbuild.BUILD_DIR
        assert path.name.startswith(f"libggrs_host{suffix}-") and path.suffix == ".so"
        # the environment selects the same variant
        monkeypatch.setenv("GGRS_NATIVE_SANITIZE", value)
        assert tbuild.host_library_path() == path and tbuild.sanitize_mode() == mode
        # an empty string asks for the production library whatever the variable says
        assert tbuild.host_library_path("") == prod
        monkeypatch.delenv("GGRS_NATIVE_SANITIZE")
    assert tbuild.sanitize_mode("") is None and tbuild.sanitize_mode() is None
    names = {tbuild.host_library_path(v).name for v in ("", "1", "thread")}
    assert len(names) == 3  # the hash covers the flags: no variant stands in for another


def test_sanitized_builds_get_their_own_loaded_slot(monkeypatch, tmp_path):
    # load_host keys its cache by variant: a process asking for the
    # production library never gets a sanitized one back
    loaded = {}
    monkeypatch.setattr(tbuild, "_loaded", loaded)
    monkeypatch.setattr(tbuild, "build_host", lambda sanitize=None: 0.0)
    monkeypatch.setattr(tbuild.ctypes, "CDLL", lambda path: ("lib", path))
    prod = tbuild.load_host("")
    san = tbuild.load_host("1")
    assert prod == ("lib", str(tbuild.host_library_path("")))
    assert san == ("lib", str(tbuild.host_library_path("1")))
    assert tbuild.load_host("address") is san and len(loaded) == 2


def _run_drive(env):
    return subprocess.run(
        [sys.executable, "-c", DRIVE, str(ROOT)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_asan_bank_drive_equals_the_production_drive():
    gxx = shutil.which("g++")
    assert gxx is not None, "g++ builds the host library here"
    runtime = subprocess.run([gxx, "-print-file-name=libasan.so"], capture_output=True,
                             text=True).stdout.strip()
    assert os.path.isabs(runtime) and os.path.exists(runtime), runtime
    tbuild.build_host("")
    tbuild.build_host("1")
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "GGRS_NATIVE_SANITIZE", "LD_PRELOAD", "ASAN_OPTIONS")}
    prod = _run_drive(base)
    assert prod.returncode == 0, prod.stderr
    san = _run_drive(dict(base, GGRS_NATIVE_SANITIZE="1", LD_PRELOAD=runtime,
                          ASAN_OPTIONS="detect_leaks=0:abort_on_error=1"))
    assert san.returncode == 0, san.stderr[-4000:]
    assert "AddressSanitizer" not in san.stderr and "runtime error:" not in san.stderr
    prod_lib, prod_counts, prod_digest = prod.stdout.split("\n")[:3]
    san_lib, san_counts, san_digest = san.stdout.split("\n")[:3]
    assert Path(prod_lib) == tbuild.host_library_path("")
    assert Path(san_lib) == tbuild.host_library_path("1")
    assert san_counts == prod_counts == "60 True"
    assert san_digest == prod_digest
