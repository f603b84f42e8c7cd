"""Persistent on-disk cache of compiled filter spectra.

The expensive part of opening a filter is decoding its impulse
responses and transforming them into partition spectra; the result is
immutable for given inputs, so it is content-addressed and reused across
mounts and restarts.  Keys hash the config file BYTES, the sample rate,
the layout version and the CONTENT of every IR file the config reads, so
an edit to any input (not just its mtime) misses cleanly and stale
entries are simply never addressed again.

The key, the ``.npz`` fields and the default location are those of the
JAX package's cache, so a file written by either package loads in the
other.  Default location ``$XDG_CACHE_HOME/folve_tpu/spectra`` (or
``~/.cache/...``); override with ``FOLVE_SPECTRA_CACHE=<dir>``, disable
with ``FOLVE_SPECTRA_CACHE=0``.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import FilterBank
from folve_tpu_torch.filters import compiler
from folve_tpu_torch.filters.compiler import CompiledFilter, FilterCompileError
from folve_tpu_torch.filters.zita_parser import ReadOp, ZitaConfigError, parse_config

# Bump when the on-disk layout or the engine's spectra layout changes.
_VERSION = 1


def cache_dir() -> Optional[str]:
    env = os.environ.get("FOLVE_SPECTRA_CACHE")
    if env is not None:
        if env in ("", "0", "off", "none"):
            return None
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "folve_tpu", "spectra")


def _key(config_path: str, fsamp: int, source_paths: List[str]) -> Optional[str]:
    h = hashlib.sha256()
    h.update(f"v{_VERSION}:{fsamp}:".encode())
    try:
        with open(config_path, "rb") as f:
            h.update(f.read())
        for p in sorted(source_paths):
            h.update(b"\0" + p.encode("utf-8", "surrogateescape") + b"\0")
            with open(p, "rb") as f:
                h.update(f.read())
    except OSError:
        return None  # unreadable input: don't cache (ERR_OTHER semantics)
    return h.hexdigest()


def _load(path: str) -> Optional[dict]:
    """The entry's fields as host arrays; None for an entry of another
    version or one that does not parse."""
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["version"]) != _VERSION:
                return None
            # NpzFile re-reads the zip member on every subscript; read
            # each field (the large spectra among them) exactly once.
            return dict(h_spec=z["h_spec"], fragm=int(z["fragm"]),
                        size=int(z["size"]), ir=z["ir"], fsamp=int(z["fsamp"]),
                        warnings=[str(w) for w in z["warnings"]])
    except Exception:
        return None  # corrupt entry: recompile and overwrite


def _store(path: str, compiled: CompiledFilter) -> None:
    """Write an entry atomically; a cache that cannot be written is
    skipped."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    except OSError:
        return
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=np.int64(_VERSION),
                # The compiler's host copy: no device->host fetch.
                h_spec=compiled.host_spec,
                fragm=np.int64(compiled.bank.fragm),
                size=np.int64(compiled.bank.size),
                ir=compiled.ir,
                fsamp=np.int64(compiled.fsamp),
                warnings=np.asarray(compiled.warnings, dtype="U")
                if compiled.warnings
                else np.asarray([], dtype="U1"),
            )
        os.replace(tmp, path)  # atomic vs concurrent mounts
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def compile_with_cache(config_path: str, fsamp: int,
                       device="cuda") -> CompiledFilter:
    """:func:`compile_spec` onto ``device`` with a content-addressed disk
    cache in front.

    Compiles whenever the cache is disabled, an input is unreadable or a
    cache file is corrupt; a failed store leaves the compile's result
    standing.  Errors of the device are never taken for a corrupt
    entry: they propagate."""
    dev = resolve_device(device)
    try:
        spec = parse_config(config_path)
    except ZitaConfigError as e:
        raise FilterCompileError(str(e)) from e

    cdir = cache_dir()
    key = None
    if cdir is not None:
        sources = [op.path for op in spec.ops if isinstance(op, ReadOp)]
        key = _key(config_path, fsamp, sources)
    if key is not None:
        path = os.path.join(cdir, key + ".npz")
        hit = _load(path) if os.path.exists(path) else None
        if hit is not None:
            # Placed outside _load: an error of the device propagates.
            bank = FilterBank(h_spec=torch.from_numpy(hit["h_spec"]).to(dev),
                              fragm=hit["fragm"], size=hit["size"])
            return CompiledFilter(ir=hit["ir"], bank=bank, fsamp=hit["fsamp"],
                                  warnings=hit["warnings"],
                                  host_spec=hit["h_spec"])
    compiled = compiler.compile_spec(spec, fsamp=fsamp, device=dev)
    if key is not None:
        _store(path, compiled)
    return compiled
