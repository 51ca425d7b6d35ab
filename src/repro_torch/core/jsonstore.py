"""Shared-JSON-on-a-directory, done once.

Four subsystems independently grew the same pattern — a small JSON
document on a shared filesystem that several processes read, merge, and
republish: FileBroker's per-queue visibility overrides (``.vt.json``),
its per-queue depth bounds (``.depth.json``), the shard discovery
announce file (``broker-serve --announce``), and now the DAG engine's
persisted node state and published-sample index.  Three of the four had
subtly different concurrency stories (unlocked merge-before-write,
fcntl-locked read-modify-write, ad-hoc lock sidecar), and one of those
differences was a real bug class: two unlocked mergers can drop each
other's writes, then a signature-triggered reload erases the loser's own
entry.

This module is the ONE implementation all of them share:

* :func:`save_json` — atomic publish (temp file + ``os.rename``), so a
  reader never observes a torn document.
* :func:`load_json` — tolerant read (missing / torn / mid-rename files
  return the default instead of raising).
* :func:`update_json` — fcntl-locked read-modify-write: takes an update
  function, applies it to the current document *under an exclusive lock
  on a sidecar ``<path>.lock``*, republished atomically.  Concurrent
  updaters serialize; none can drop another's merge.
* :class:`SharedJsonConfig` — the signature-cached reload idiom
  (``(mtime_ns, size)``) for hot paths that must notice other processes'
  updates without re-reading an unchanged file on every call.

Locking is advisory (fcntl) and scoped to hosts sharing the filesystem —
the same contract the broker directory itself relies on.  All helpers
swallow ``OSError`` into best-effort semantics *only* where the caller
asks for it (``strict=False``): shared config is advisory, but DAG state
is correctness-adjacent and uses ``strict=True``.
"""
from __future__ import annotations

import fcntl
import json
import os
import uuid
from typing import Any, Callable, Dict, Optional, Tuple


def save_json(path: str, doc: Dict[str, Any], *, strict: bool = False) -> bool:
    """Atomically publish ``doc`` at ``path`` (temp + rename).

    Returns True on success.  ``strict=True`` re-raises ``OSError``
    instead of degrading to a no-op.
    """
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".tmp-json-{uuid.uuid4().hex}")
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.rename(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if strict:
            raise
        return False


def load_json(path: str, default: Any = None) -> Any:
    """Read a JSON document; missing or torn files yield ``default``."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return default


def file_signature(path: str) -> Optional[Tuple[int, int]]:
    """The cheap change-detection key: ``(mtime_ns, size)`` or None."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def update_json(path: str, update: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]],
                *, lock_path: Optional[str] = None,
                strict: bool = False) -> Optional[Dict[str, Any]]:
    """Locked read-modify-write: load the current doc, apply ``update``,
    republish atomically — all under an exclusive fcntl lock on
    ``lock_path`` (default ``<path>.lock``), so concurrent updaters from
    any process serialize instead of dropping each other's changes.

    ``update`` may mutate its argument in place (return None) or return a
    replacement dict.  Returns the published document, or None when the
    lock file could not be opened and ``strict`` is False (degraded:
    unlocked update — still atomic, merely unserialized).
    """
    lock_path = lock_path or (path + ".lock")
    lf = None
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        lf = open(lock_path, "w")
        fcntl.flock(lf, fcntl.LOCK_EX)
    except OSError:
        if strict:
            if lf is not None:
                lf.close()
            raise
        lf = None  # degraded: proceed unlocked (atomic, unserialized)
    try:
        doc = load_json(path, default={})
        if not isinstance(doc, dict):
            doc = {}
        out = update(doc)
        doc = doc if out is None else out
        save_json(path, doc, strict=strict)
        return doc
    finally:
        if lf is not None:
            lf.close()  # releases the flock


class SharedJsonConfig:
    """A shared JSON config file with signature-cached reloads.

    The pattern behind ``.vt.json`` / ``.depth.json``: many instances on
    one directory each hold an in-memory view; writers publish through
    :meth:`update` (locked merge); readers call :meth:`load_if_changed`
    on their hot path and get the parsed doc only when the on-disk
    signature moved — an unchanged file costs one ``os.stat``.
    """

    def __init__(self, path: str):
        self.path = path
        self._sig: Optional[Tuple[int, int]] = None

    def load_if_changed(self) -> Optional[Dict[str, Any]]:
        """Parsed doc when the file changed since the last call, else None
        (also None for missing/torn files — nothing to apply)."""
        sig = file_signature(self.path)
        if sig is None or sig == self._sig:
            return None
        doc = load_json(self.path)
        if not isinstance(doc, dict):
            return None
        self._sig = sig
        return doc

    def update(self, fn: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]) -> Dict[str, Any]:
        """Locked read-modify-write via :func:`update_json`; refreshes the
        cached signature so the writer does not re-apply its own write."""
        doc = update_json(self.path, fn) or {}
        self._sig = file_signature(self.path)
        return doc

    def forget(self) -> None:
        """Drop the signature cache (force the next load to re-read)."""
        self._sig = None
