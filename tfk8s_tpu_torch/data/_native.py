"""Lazy ``g++`` build and ``ctypes`` binding of the native cores: the
record-IO core (``native/recordio.cc``, bound here) and the image-decode
core (``native/imagecore.cc``, bound by ``images/_native_decode.py``).

Each shared object is built at first use into ``build/native/`` at the root
of the checkout (``$TFK8S_NATIVE_CACHE`` overrides it), under a name that
carries a hash of the source, so an edited source is rebuilt and an
unchanged one reused; processes building at once each write a temporary
file and rename it into place. Without a toolchain, or with
``TFK8S_PURE_PY=1``, the loaders return None and the callers take their
pure-Python (records) or PIL (images) paths.

``TFK8S_NATIVE_SANITIZE=asan|ubsan`` builds both cores with that sanitizer,
under a cache name of its own, so sanitized and plain libraries coexist.
``-O1`` overrides the base ``-O3`` for usable stack traces. An asan library
usually cannot be loaded into a python without ``LD_PRELOAD=libasan.so``:
:func:`dlopen_checked` then warns and the caller falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger("tfk8s.data.native")

_SRC = Path(__file__).resolve().parent / "native" / "recordio.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SANITIZE_FLAGS = {
    "asan": ("-fsanitize=address", "-fno-omit-frame-pointer", "-g", "-O1"),
    "ubsan": ("-fsanitize=undefined", "-fno-sanitize-recover=undefined", "-g", "-O1"),
}
_RECORD_FALLBACK = "the pure-Python codec (~120x slower reads)"


def sanitize_mode() -> Optional[str]:
    """The validated ``TFK8S_NATIVE_SANITIZE`` value, or None. An unknown
    value warns and is ignored rather than building a plain core under a
    name that suggests a sanitizer."""
    mode = os.environ.get("TFK8S_NATIVE_SANITIZE", "").strip().lower()
    if not mode:
        return None
    if mode not in _SANITIZE_FLAGS:
        log.warning("TFK8S_NATIVE_SANITIZE=%r is not one of %s; building plain",
                    mode, "/".join(sorted(_SANITIZE_FLAGS)))
        return None
    return mode


def build_dir() -> Path:
    d = Path(os.environ.get("TFK8S_NATIVE_CACHE") or _BUILD_DIR)
    d.mkdir(parents=True, exist_ok=True)
    return d


def build_cached(src_path, prefix: str, build_log: logging.Logger, what: str,
                 fallback: str, extra_flags: tuple = ()) -> Optional[str]:
    """Compile ``src_path`` (once per source hash and sanitizer mode) into
    the build directory as ``<prefix>[-<mode>]-<hash>.so`` and return its
    path, or None: quietly when there is no ``g++`` (the caller reports the
    consequence on first use), loudly, with the compiler's words, when a
    present ``g++`` fails. ``what`` and ``fallback`` name the core and its
    slower path in the warnings."""
    src = Path(src_path).read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    mode = sanitize_mode()
    sanitize_flags: tuple = ()
    if mode is not None:
        prefix = f"{prefix}-{mode}"
        sanitize_flags = _SANITIZE_FLAGS[mode]
    out = build_dir() / f"{prefix}-{tag}.so"
    if out.exists():
        return str(out)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(build_dir()))
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src_path), "-o", tmp,
           *sanitize_flags, *extra_flags]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return str(out)
    except FileNotFoundError:
        return None
    except subprocess.CalledProcessError as e:
        build_log.warning(
            "native %s build FAILED (g++ rc=%s); falling back to %s. stderr:\n%s",
            what, e.returncode, fallback, (e.stderr or b"").decode(errors="replace")[-2000:],
        )
        return None
    except (subprocess.SubprocessError, OSError) as e:
        build_log.warning("native %s build errored (%s: %s); falling back to %s",
                          what, type(e).__name__, e, fallback)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def dlopen_checked(path: str, build_log: logging.Logger, what: str,
                   fallback: str) -> Optional[ctypes.CDLL]:
    """``ctypes.CDLL(path)``, or None with a warning when the library does
    not load (most often a sanitized build whose runtime is not preloaded):
    a configuration to fall back from, not to crash on."""
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        build_log.warning("native %s built but failed to load (%s); falling back to %s",
                          what, e, fallback)
        return None


def load() -> Optional[ctypes.CDLL]:
    """The bound record core, or None (no toolchain, or disabled). Built
    and bound once a process; the result is latched."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("TFK8S_PURE_PY") == "1":
            return None
        path = build_cached(_SRC, "recordio", log, "recordio core", _RECORD_FALLBACK)
        if path is None:
            return None
        lib = dlopen_checked(path, log, "recordio core", _RECORD_FALLBACK)
        if lib is None:
            return None
        i64, u32 = ctypes.c_int64, ctypes.c_uint32
        pi64 = ctypes.POINTER(i64)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        lib.rio_crc32c.restype = u32
        lib.rio_crc32c.argtypes = [ctypes.c_char_p, i64]
        lib.rio_masked_crc32c.restype = u32
        lib.rio_masked_crc32c.argtypes = [ctypes.c_char_p, i64]
        lib.rio_index.restype = i64
        lib.rio_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(pi64), ctypes.POINTER(pi64)]
        lib.rio_free.restype = None
        lib.rio_free.argtypes = [ctypes.c_void_p]
        lib.rio_read.restype = i64
        lib.rio_read.argtypes = [ctypes.c_char_p, i64, pi64, pi64, pu8, ctypes.c_int, pi64]
        lib.rio_write.restype = i64
        lib.rio_write.argtypes = [ctypes.c_char_p, i64, pu8, pi64]
        _lib = lib
        return _lib
