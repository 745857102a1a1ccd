"""Build a shared library from sources at first use.

The output lands in ``build/tpu_rt_torch/`` at the root of the checkout
(git-ignored), named by a hash of the sources and the compiler command, so a
changed source or flag rebuilds and an unchanged one is reused.  The build
writes a temporary file and ``os.replace``s it into place, so concurrent
processes (pytest-xdist workers) never load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "tpu_rt_torch")


def build_shared(name: str, sources: list[str], compile_cmd: list[str],
                 timeout: float = 600.0, deps: list[str] = ()) -> tuple[str, str]:
    """Build ``lib<name>-<hash>.so`` from ``sources`` unless it exists.

    ``compile_cmd`` is the compiler command without sources and output; it
    is run as ``compile_cmd + sources + ["-o", tmp]``.  ``deps`` (headers
    the sources include) enter the hash but not the command.  Returns the
    library path and the compiler's output ("" when the library was already
    built).  Raises ``RuntimeError`` with the compiler's output when the
    build fails.
    """
    h = hashlib.blake2b(digest_size=8)
    for src in [*sources, *deps]:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(compile_cmd).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path[:-3]}.tmp{os.getpid()}.so"
    proc = subprocess.run(compile_cmd + sources + ["-o", tmp],
                          capture_output=True, text=True, timeout=timeout)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {name} failed ({' '.join(compile_cmd)}):\n{log[-8000:]}")
    os.replace(tmp, path)
    return path, log
