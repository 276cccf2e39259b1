"""Lazy ``g++`` build and ``ctypes`` binding of the native record-IO core
(``native/recordio.cc``).

The shared object is built at first use into ``build/native/`` at the root
of the checkout (``$TFK8S_NATIVE_CACHE`` overrides it), under a name that
carries a hash of the source, so an edited source is rebuilt and an
unchanged one reused; processes building at once each write a temporary
file and rename it into place. Without a toolchain, or with ``TFK8S_PURE_PY=1``,
``load()`` returns None and ``recordio.py`` uses its pure-Python codec.
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


def build_dir() -> Path:
    d = Path(os.environ.get("TFK8S_NATIVE_CACHE") or _BUILD_DIR)
    d.mkdir(parents=True, exist_ok=True)
    return d


def _build() -> Optional[str]:
    """Compile the core (once per source hash) and return the library's
    path, or None: quietly when there is no ``g++``, loudly, with the
    compiler's words, when a present ``g++`` fails."""
    src = _SRC.read_bytes()
    out = build_dir() / f"recordio-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(build_dir()))
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return str(out)
    except FileNotFoundError:
        return None
    except subprocess.CalledProcessError as e:
        log.warning(
            "native recordio core build FAILED (g++ rc=%s); falling back to the "
            "pure-Python codec. stderr:\n%s",
            e.returncode, (e.stderr or b"").decode(errors="replace")[-2000:],
        )
        return None
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native recordio core build errored (%s: %s); falling back "
                    "to the pure-Python codec", type(e).__name__, e)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The bound native library, or None (no toolchain, or disabled). Built
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
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.warning("native recordio core built but failed to load (%s); "
                        "falling back to the pure-Python codec", e)
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
