"""Build the package's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for ``sm_90a`` into ``stcat_tpu_torch/_build/`` (listed in
.gitignore), under a file name that carries a hash of the source and of every
shared header ``csrc/*.cuh``, so an edited source or header is rebuilt and a
stale library is never loaded. ``build_all``
starts one nvcc per source at once, for callers that want every kernel ready
up front.

The host decoders ``native/<name>.cc`` (libjpeg batch decode, the ffmpeg
pipe pool) build the same way with g++ (``NativeLibrary``), into the same
directory under the same lock; a failed g++ build is recorded and the
caller falls back to its Python route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "bottleneck")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _hashed(name: str, parts: List[bytes]) -> Path:
    """BUILD_DIR/lib<name>-<hash of parts>.so"""
    h = hashlib.sha1()
    for part in parts:
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _lib_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    for header in sorted(CSRC.glob("*.cuh")):
        parts += [header.name.encode(), header.read_bytes()]
    return _hashed(name, parts)


def _nvcc_cmd(name: str, tmp: Path) -> List[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns nvcc's output by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        dst = _lib_path(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".tmp{os.getpid()}")
        procs[name] = (dst, tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    logs = {}
    for name, (dst, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, dst)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


class NativeLibrary:
    """``native/<name>.cc`` built with ``g++ -O2 -fPIC -shared ... <link>``
    into BUILD_DIR at first use (under the build lock, so the loader's
    threads build it once) and loaded with ctypes; ``declare(lib)`` sets its
    ``argtypes`` and ``restype``. ``get()`` returns None when the build
    failed (no g++, a missing system header or library), and ``error`` then
    says why; a library that did build but does not load raises.

    The file name hashes the source, the link flags and what the build reads
    of the machine (``_machine``), so a library built elsewhere and copied
    along with the tree is never found under this machine's name."""

    def __init__(self, name: str, link: Sequence[str], declare: Callable[[ctypes.CDLL], None]):
        self.name, self.link, self.declare = name, tuple(link), declare
        self.error: Optional[str] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._machine_parts: Optional[List[bytes]] = None

    def _machine(self) -> List[bytes]:
        """The bytes of every header ``g++ -M`` finds for the source (or its
        error, naming the header that is missing) and of every library a
        ``-l`` flag resolves to (``g++ -print-file-name``); just the error
        where g++ does not run. Computed once."""
        if self._machine_parts is None:
            src = NATIVE / f"{self.name}.cc"
            try:
                deps = subprocess.run(["g++", "-M", str(src)], capture_output=True, text=True,
                                      timeout=60)
                parts = [deps.stderr.encode()]
                if deps.returncode == 0:
                    # "<name>.o: <source> <header> ... \" -> the files after the target
                    parts += [Path(f).read_bytes()
                              for f in deps.stdout.replace("\\\n", " ").split()[1:]]
                for flag in self.link:
                    if flag.startswith("-l"):
                        found = subprocess.run(["g++", f"-print-file-name=lib{flag[2:]}.so"],
                                               capture_output=True, text=True, timeout=60)
                        real = os.path.realpath(found.stdout.strip())
                        parts += [flag.encode(),
                                  Path(real).read_bytes() if os.path.isfile(real) else b"-"]
            except (OSError, subprocess.TimeoutExpired) as e:
                parts = [f"g++ does not run: {e}".encode()]
            self._machine_parts = parts
        return self._machine_parts

    def path(self) -> Path:
        """BUILD_DIR/lib<name>-<hash of the source, the link flags and the
        machine's headers and libraries>.so"""
        return _hashed(self.name, [(NATIVE / f"{self.name}.cc").read_bytes(),
                                   " ".join(self.link).encode(), *self._machine()])

    def _build(self, dst: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(f".tmp{os.getpid()}")
        try:
            subprocess.run(["g++", "-O2", "-fPIC", "-shared", str(NATIVE / f"{self.name}.cc"),
                            "-o", str(tmp), *self.link], check=True, capture_output=True,
                           text=True, timeout=240)
            os.replace(tmp, dst)
        finally:
            tmp.unlink(missing_ok=True)

    def get(self) -> Optional[ctypes.CDLL]:
        with _lock:
            if self._lib is None and self.error is None:
                dst = self.path()
                if not dst.exists():
                    try:
                        self._build(dst)
                    except subprocess.CalledProcessError as e:
                        self.error = f"g++ failed for {self.name}.cc: {e.stderr[-2000:]}"
                    except (OSError, subprocess.TimeoutExpired) as e:
                        self.error = f"g++ could not build {self.name}.cc: {e}"
                if self.error is None:
                    lib = ctypes.CDLL(str(dst))
                    self.declare(lib)
                    self._lib = lib
            return self._lib


class LaunchCounter:
    """Number of kernel launches a wrapper has made (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
