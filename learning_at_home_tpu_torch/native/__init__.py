"""ctypes bindings for the native (C++) server data plane.

The port of ``learning_at_home_tpu/native/``.  ``FramePump`` wraps
``framepump.cpp`` (a byte-for-byte copy of the JAX package's) — a
GIL-free epoll thread that owns all socket work for the framed tensor
RPC protocol (wire-compatible with ``utils/serialization.py``).  The
shared library is built at first use with ``g++ -O2 -shared -fPIC
-pthread`` into ``build/native/`` at the root of the checkout (listed in
``.gitignore``; never next to the source), under a name keyed by a hash
of the source and flags, by one process at a time (an exclusive flock: a
swarm starts its servers together) through a temp file renamed into
place, so no process can load a half-written library.

``native_available()`` returns False when the build fails (no compiler,
not Linux); ``Server(transport="native")`` then raises, and never falls
back to the asyncio transport.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import socket
import subprocess
from pathlib import Path
from typing import Optional

from learning_at_home_tpu_torch.utils import sanitizer

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "framepump.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = sanitizer.lock("native.lib")


def library_path() -> Path:
    """Where the pump's library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"framepump_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the pump unless this source's library exists."""
    so = library_path()
    if so.exists():
        return so
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        with open(so.with_name(so.name + ".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            # another process may have finished the build while we waited
            if so.exists():
                return so
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=120)
            if r.returncode != 0:
                logger.warning(
                    "native framepump build failed:\n%s", r.stderr[-2000:]
                )
                return None
            os.replace(tmp, so)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native framepump build failed to run: %s", e)
        return None
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.lah_pump_create.restype = ctypes.c_void_p
        lib.lah_pump_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        ]
        lib.lah_pump_next.restype = ctypes.c_int
        lib.lah_pump_next.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lah_pump_send.restype = ctypes.c_int
        lib.lah_pump_send.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        lib.lah_pump_buffree.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.lah_pump_shutdown.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class FramePump:
    """GIL-free epoll data plane; Python sees only whole frames.
    ``frames_in`` and ``frames_out`` count the frames it handed over and
    the replies it queued."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native framepump unavailable (g++ build failed); "
                "use transport='asyncio'"
            )
        self._lib = lib
        # the C side binds with inet_addr (numeric only): resolve names
        try:
            host = socket.gethostbyname(host)
        except OSError:
            pass  # let bind() produce the error for truly bad hosts
        out_port = ctypes.c_int(0)
        self._h = lib.lah_pump_create(host.encode(), port,
                                      ctypes.byref(out_port))
        if not self._h:
            raise OSError(f"framepump could not bind {host}:{port}")
        self.port = out_port.value
        self._closed = False
        self.frames_in = 0
        self.frames_out = 0
        # serializes send vs shutdown: a reply arriving on another thread
        # during shutdown must either be queued on live C state or see
        # _closed — never call into freed memory.  next() is NOT guarded
        # (it blocks); callers stop calling next() before shutdown().
        self._call_lock = sanitizer.lock("native.pump_call")

    def next(self, timeout: float = 0.2) -> Optional[tuple[int, bytes]]:
        """Next complete inbound frame as (conn_id, payload).

        None on timeout; raises ``EOFError`` after shutdown."""
        conn = ctypes.c_uint64(0)
        buf = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_uint64(0)
        rc = self._lib.lah_pump_next(
            self._h, int(timeout * 1000), ctypes.byref(conn),
            ctypes.byref(buf), ctypes.byref(length),
        )
        if rc == 0:
            return None
        if rc < 0:
            raise EOFError("framepump stopped")
        try:
            payload = ctypes.string_at(buf, length.value)
        finally:
            self._lib.lah_pump_buffree(buf)
        self.frames_in += 1
        return conn.value, payload

    def send(self, conn_id: int, payload: bytes) -> bool:
        """Queue a reply frame; False if the peer is gone (disconnected or
        not reading replies — its queue cap was hit)."""
        with self._call_lock:
            if self._closed:
                return False
            rc = self._lib.lah_pump_send(
                self._h, conn_id, payload, len(payload)
            )
            if rc == 0:
                self.frames_out += 1
        if rc == -2:
            raise ValueError("frame exceeds MAX_FRAME_BYTES")
        return rc == 0

    def shutdown(self) -> None:
        with self._call_lock:
            if self._closed:
                return
            self._closed = True
        self._lib.lah_pump_shutdown(self._h)

    def __del__(self):  # best-effort; explicit shutdown preferred
        try:
            self.shutdown()
        # finalizer: logging may already be torn down at interpreter exit
        except Exception:
            pass
