"""Build and import the port's CPython extension (``groupwalk.c``).

A copy of the reference repository's ``native/_build.py``, trimmed to the
extension: a one-shot silent build on first use when the host has a C
compiler (``$CC``, else ``gcc``), atomic (compile to a pid-suffixed
temp, rename into place: a concurrent importer sees either nothing, and
falls back, or the complete library, never a truncated file). The
library goes into this package's git-ignored ``_build/``, named by a
hash of the source and the interpreter's ``EXT_SUFFIX``, so an edited
source or another Python builds anew instead of loading a stale or
ABI-foreign extension (the content key replaces the reference's mtime
check)."""

from __future__ import annotations

import hashlib
import os
import subprocess

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG, "native")
BUILD_DIR = os.path.join(PKG, "_build")


def _ensure_built(so_path: str, src: str, compile_cmd) -> bool:
    """The atomic build step: compile to a pid-suffixed temp and rename
    into place. ``compile_cmd(tmp)`` returns the argv. True iff
    ``so_path`` is usable."""
    if os.path.exists(so_path):
        return True
    if not os.path.exists(src):
        return False
    tmp = so_path + f".tmp.{os.getpid()}"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(compile_cmd(tmp), check=True, capture_output=True,
                       timeout=60)
        os.replace(tmp, so_path)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def ext_path(module_name: str, c_name: str) -> str:
    """Where the extension built from ``native/<c_name>`` lives: this
    package's ``_build/``, keyed by the source's bytes and EXT_SUFFIX."""
    import sysconfig
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    with open(os.path.join(NATIVE_DIR, c_name), "rb") as f:
        key = hashlib.sha256(f.read() + suffix.encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{module_name}_{key}{suffix}")


def build_ext_and_import(module_name: str, c_name: str):
    """Build (once) and import the CPython extension ``module_name`` from
    ``native/<c_name>``. Returns the module or None: callers keep a
    pure-Python fallback."""
    import importlib.util
    import sysconfig
    src = os.path.join(NATIVE_DIR, c_name)
    if not os.path.exists(src):
        return None
    so_path = ext_path(module_name, c_name)
    inc = sysconfig.get_paths()["include"]
    if not _ensure_built(so_path, src, lambda tmp: [
            os.environ.get("CC", "gcc"), "-O2", "-fPIC", "-shared", "-I",
            inc, "-o", tmp, src]):
        return None
    try:
        spec = importlib.util.spec_from_file_location(module_name, so_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:
        return None
