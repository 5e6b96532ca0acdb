"""Builds a host-side C++ library from the repository's ``native/``
sources with ``g++`` and loads it with ctypes — the port's copy of
``analytics_zoo_tpu/native/_loader.py`` with one difference: the library
goes into ``build/native/`` at the repository root (gitignored), named by
a hash of its source and flags, and never into ``native/``, which holds
only the sources.

The compile writes a pid-unique temporary file and ``os.replace``s it into
place, so two processes building the same library at once never leave a
half-written one behind."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

log = logging.getLogger("analytics_zoo_tpu_torch.native")

REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / "native"
BUILD_DIR = REPO / "build" / "native"

# native/Makefile's flags
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall")
LDFLAGS = ("-shared", "-pthread")


def library_path(stem: str, src_name: str) -> Path:
    """Where ``native/<src_name>`` builds to: ``build/native/lib<stem>-
    <hash of the source and flags>.so``."""
    h = hashlib.sha256((NATIVE_DIR / src_name).read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_and_load(stem: str, src_name: str) -> Optional[ctypes.CDLL]:
    """``build/native/lib<stem>-<hash>.so``, built from ``native/<src_name>``
    first when missing, loaded. None on any failure (no compiler, a failed
    build or load): the caller takes its pure-Python path."""
    try:
        so = library_path(stem, src_name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *CXXFLAGS, str(NATIVE_DIR / src_name),
                     *LDFLAGS, "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            finally:
                if tmp.exists():
                    tmp.unlink()
            log.info("built native library %s", so)
        return ctypes.CDLL(str(so))
    except Exception as e:  # noqa: BLE001 — any failure: the Python path
        log.info("native library %s unavailable (%s)", stem, e)
        return None
