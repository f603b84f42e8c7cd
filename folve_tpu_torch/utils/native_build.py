"""Build-on-demand for the native runtime library (the codecs).

The sources live in the repository's ``native/`` directory, which this
package only ever reads.  The library is looked up in this order:

1. ``FOLVE_NATIVE_LIB``: an explicit library path (sanitizer builds);
2. ``build/folve_tpu_torch/native/libfolve_native.so`` when its stamp
   matches the digest of ``native/``'s sources;
3. an existing ``native/libfolve_native.so`` whose ``native/.build_stamp``
   matches that digest (read only);
4. otherwise a build of ``native/``'s sources into
   ``build/folve_tpu_torch/native/`` (``make TARGET=<path>``), its stamp
   written beside it.  A file lock makes concurrent processes build once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_NAME = "libfolve_native.so"
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "folve_tpu_torch", "native")
_lock = threading.Lock()
_lib = None


def _source_digest() -> str:
    """Hash every build input (all sources/headers/tables + Makefile)."""
    h = hashlib.sha256()
    names = sorted(
        n for n in os.listdir(_NATIVE_DIR)
        if n == "Makefile" or n.endswith((".cc", ".h", ".inc"))
    )
    for name in names:
        path = os.path.join(_NATIVE_DIR, name)
        h.update(name.encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _stamped(lib_path: str, stamp_path: str, digest: str) -> bool:
    """True when ``stamp_path`` names ``digest`` and was written after
    ``lib_path`` (a stamp is written once its build has finished, so a
    library being linked right now is never taken)."""
    try:
        with open(stamp_path) as f:
            if f.read().strip() != digest:
                return False
        return os.stat(stamp_path).st_mtime >= os.stat(lib_path).st_mtime
    except OSError:
        return False


def ensure_built() -> str:
    """Path of a library built from the current sources, building it into
    ``build/folve_tpu_torch/native/`` when no up-to-date one exists."""
    digest = _source_digest()
    lib = os.path.join(_BUILD_DIR, _LIB_NAME)
    stamp = os.path.join(_BUILD_DIR, ".build_stamp")
    with _lock:
        if _stamped(lib, stamp, digest):
            return lib
        if _stamped(os.path.join(_NATIVE_DIR, _LIB_NAME),
                    os.path.join(_NATIVE_DIR, ".build_stamp"), digest):
            return os.path.join(_NATIVE_DIR, _LIB_NAME)
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, ".build_lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if not _stamped(lib, stamp, digest):  # another process built it
                    tmp = f"{lib}.{os.getpid()}.tmp"
                    subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                                   check=True, capture_output=True)
                    os.replace(tmp, lib)
                    with open(stamp, "w") as f:
                        f.write(digest)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
    return lib


def load_native() -> ctypes.CDLL:
    """Load (building if necessary) the native library, cached.

    ``FOLVE_NATIVE_LIB`` overrides the library path (the sanitizer runs
    load the ASAN/TSAN builds this way)."""
    global _lib
    if _lib is None:
        override = os.environ.get("FOLVE_NATIVE_LIB")
        _lib = ctypes.CDLL(override or ensure_built())
    return _lib
