"""Persistent on-disk tuning cache (the port's copy of
``repro.tune.cache``).

A single JSON file maps decision keys (see ``tune/space.py``) to recorded
decisions, so a process that has tuned once never measures again: the next
run replays the table. Location: ``$REPRO_TORCH_TUNE_CACHE`` if set, else
``repro_torch-tune.json`` under ``$XDG_CACHE_HOME`` (default
``~/.cache``). The port keeps a file of its own: its CPU keys equal the
reference's, and each package drops a file whose code fingerprint is not
its own, so a shared file would have the two wipe each other's decisions.

Writes are atomic (tmp file + rename) and the schema is versioned; a cache
written by an incompatible version is ignored rather than misread. The
payload carries a fingerprint of the sources the decisions were measured
against: the kernel wrappers, the ops, codegen, and the CUDA sources of
the kernels, so a kernel change invalidates the whole cache and the next
``full`` run re-tunes.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import pathlib
import tempfile
from typing import Dict, Optional

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
SCHEMA_VERSION = 1

_PKG = pathlib.Path(__file__).resolve().parents[1]
# the sources whose changes invalidate measured decisions
FINGERPRINTED = ("kernels/segment_mm.py", "kernels/traversal.py",
                 "kernels/ops.py", "core/codegen.py", "csrc/segment_mm.cu",
                 "csrc/traversal.cu")


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch-tune.json")


@functools.lru_cache(maxsize=1)
def code_fingerprint() -> str:
    """Digest of the sources whose changes invalidate measured decisions:
    the kernels the variants select among (wrappers and CUDA sources) and
    the ops and codegen that dispatch on them."""
    h = hashlib.sha1()
    for rel in FINGERPRINTED:
        h.update(rel.encode())
        try:
            h.update((_PKG / rel).read_bytes())
        except OSError:
            pass
    return h.hexdigest()[:12]


class TuneCache:
    """Dict-like persistent store: key string -> JSON-able decision value."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._entries: Dict[str, object] = {}
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        if (isinstance(raw, dict) and raw.get("version") == SCHEMA_VERSION
                and raw.get("code") == code_fingerprint()):
            entries = raw.get("entries")
            if isinstance(entries, dict):
                self._entries = entries

    # ------------------------------------------------------------------
    def get(self, key: str):
        return self._entries.get(key)

    def put(self, key: str, value) -> None:
        if self._entries.get(key) != value:
            self._entries[key] = value
            self._dirty = True

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    def save(self) -> None:
        """Atomically persist if anything changed since load/last save."""
        if not self._dirty:
            return
        payload = {"version": SCHEMA_VERSION, "code": code_fingerprint(),
                   "entries": self._entries}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".repro_torch-tune-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._dirty = False
