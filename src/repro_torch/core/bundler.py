"""Hierarchical result bundling/aggregation (paper Sec. 3.1, Fig. 7).

The JAG study's layout, Conduit/HDF5 swapped for npz (no h5py offline):
N simulations per *bundle file*, ``files_per_leaf`` bundle files per leaf
directory; once a leaf fills, an aggregation step merges it into a single
aggregate file of ``bundle * files_per_leaf`` simulations.  All writes are
atomic renames — no file locking or I/O coordination between the
asynchronous writers, exactly the paper's design.

``crawl()`` is the resilience primitive: walk the tree, return which sample
ids actually made it to disk (and which files are corrupt), so missing work
can be resubmitted (the 70% -> 99.755% story).

Incremental loading
-------------------
The learner side of the loop (core/active.py) re-reads the archive at every
funnel.  ``load_all`` therefore keeps a per-file cache keyed by the file's
``(inode, mtime_ns, size)`` signature: only files that appeared or changed
since the previous call are decompressed, everything else is served from
memory, and an unchanged tree returns the previously concatenated result
without touching the files at all.  ``load_since(cursor)`` exposes the same
machinery as an explicit delta: it returns only the records from files not
yet covered by ``cursor`` plus the advanced cursor.  Writers publish via
atomic rename (fresh inode per publish), so a cached signature can never
alias a concurrent rewrite.  Note that aggregation rewrites sample ids into
a *new* file, so a cursor held across ``aggregate_leaf`` re-delivers those
ids — hold cursors within one aggregation epoch.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

# a file's identity-and-content signature: (inode, mtime_ns, size)
Sig = Tuple[int, int, int]


class Bundler:
    def __init__(self, root: str, files_per_leaf: int = 100, sink=None):
        self.root = root
        self.files_per_leaf = files_per_leaf
        # optional same-host fast path: any object with
        # ``push_bundle(lo, hi, results) -> bool`` (e.g.
        # core/shmring.BundleRing).  Fed AFTER the durable file write —
        # the npz tree stays the source of truth and of load_since
        # cursors; a full/broken sink only costs the latency shortcut.
        self.sink = sink
        os.makedirs(root, exist_ok=True)
        self._file_cache: Dict[str, Tuple[Sig, Dict[str, np.ndarray]]] = {}
        self._all_cache: Optional[Tuple[Dict[str, Sig],
                                        Dict[str, np.ndarray]]] = None

    def attach_sink(self, sink) -> None:
        """Install/replace the write sink (None detaches)."""
        self.sink = sink

    # -- writing -------------------------------------------------------------
    def leaf_dir(self, bundle_lo: int, bundle_size: int) -> str:
        leaf = (bundle_lo // bundle_size) // self.files_per_leaf
        d = os.path.join(self.root, f"leaf_{leaf:06d}")
        os.makedirs(d, exist_ok=True)
        return d

    def write_bundle(self, lo: int, hi: int, results: Dict[str, np.ndarray]) -> str:
        """results: dict of arrays with leading dim == hi-lo."""
        d = self.leaf_dir(lo, hi - lo)
        path = os.path.join(d, f"bundle_{lo:09d}_{hi:09d}.npz")
        # np.savez appends ".npz" unless present: keep the suffix on the tmp
        tmp = os.path.join(d, f".tmp-{os.getpid()}-{lo}-{hi}.npz")
        ids = np.arange(lo, hi)
        np.savez_compressed(tmp, _sample_ids=ids, **results)
        os.rename(tmp, path)  # atomic publish
        if self.sink is not None:
            try:
                self.sink.push_bundle(lo, hi, results)
            except Exception:
                pass  # the file above is the durable record; sink is best-effort
        return path

    # -- aggregation ----------------------------------------------------------
    def aggregate_leaf(self, leaf_dir: str) -> Optional[str]:
        files = sorted(f for f in os.listdir(leaf_dir) if f.startswith("bundle_"))
        if not files:
            return None
        parts = [dict(np.load(os.path.join(leaf_dir, f))) for f in files]
        keys = parts[0].keys()
        merged = {k: np.concatenate([p[k] for p in parts]) for k in keys}
        out = os.path.join(leaf_dir, "aggregate.npz")
        tmp = os.path.join(leaf_dir, f".tmp-agg-{os.getpid()}.npz")
        np.savez_compressed(tmp, **merged)
        os.rename(tmp, out)
        for f in files:  # bundles are subsumed by the aggregate
            os.unlink(os.path.join(leaf_dir, f))
        return out

    def aggregate_all(self) -> List[str]:
        outs = []
        for leaf in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, leaf)
            if os.path.isdir(d):
                out = self.aggregate_leaf(d)
                if out:
                    outs.append(out)
        return outs

    # -- resilience -----------------------------------------------------------
    def crawl(self) -> Tuple[Set[int], List[str]]:
        """Return (sample ids present on disk, corrupt file paths)."""
        present: Set[int] = set()
        corrupt: List[str] = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if not f.endswith(".npz") or f.startswith("."):
                    continue
                path = os.path.join(dirpath, f)
                try:
                    with np.load(path) as z:
                        present.update(int(i) for i in z["_sample_ids"])
                except Exception:
                    corrupt.append(path)
        return present, corrupt

    # -- loading --------------------------------------------------------------
    def _scan(self) -> Dict[str, Sig]:
        """Stat every published result file: path -> signature."""
        sigs: Dict[str, Sig] = {}
        for dirpath, _, files in os.walk(self.root):
            for f in sorted(files):
                if not f.endswith(".npz") or f.startswith("."):
                    continue
                path = os.path.join(dirpath, f)
                try:
                    st = os.stat(path)
                except OSError:
                    continue  # deleted between walk and stat (aggregation)
                sigs[path] = (st.st_ino, st.st_mtime_ns, st.st_size)
        return sigs

    def _load_file(self, path: str, sig: Sig) -> Optional[Dict[str, np.ndarray]]:
        """Load one bundle through the per-file cache (None if it vanished)."""
        hit = self._file_cache.get(path)
        if hit is not None and hit[0] == sig:
            return hit[1]
        try:
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
        except (OSError, ValueError):
            self._file_cache.pop(path, None)
            return None
        self._file_cache[path] = (sig, data)
        return data

    @staticmethod
    def _concat(chunks: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        if not chunks:
            return {}
        order = np.argsort(np.concatenate([c["_sample_ids"] for c in chunks]))
        return {k: np.concatenate([c[k] for c in chunks])[order]
                for k in chunks[0].keys()}

    def load_all(self) -> Dict[str, np.ndarray]:
        """Load every result in sample-id order (for the learner side).

        Incremental: only files whose signature changed since the previous
        call are read from disk; an unchanged tree returns the cached
        concatenation directly.
        """
        sigs = self._scan()
        if self._all_cache is not None and self._all_cache[0] == sigs:
            return dict(self._all_cache[1])  # shallow copy: callers may pop
        chunks = []
        for path in sorted(sigs):
            data = self._load_file(path, sigs[path])
            if data is not None:
                chunks.append(data)
            else:
                sigs.pop(path)
        # evict cache entries for files that no longer exist (aggregation)
        for stale in set(self._file_cache) - set(sigs):
            del self._file_cache[stale]
        out = self._concat(chunks)
        self._all_cache = (sigs, out)
        return dict(out)

    def load_since(self, cursor: Optional[Mapping[str, Sig]] = None
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, Sig]]:
        """Delta load: records from files not covered by ``cursor``.

        Returns ``(data, new_cursor)``; start with ``cursor=None`` and feed
        each returned cursor into the next call.  Safe under concurrent
        writers: publishes are atomic renames, so every bundle is returned
        exactly once per cursor chain (aggregation epochs aside, see module
        docstring).
        """
        cursor = dict(cursor) if cursor else {}
        sigs = self._scan()
        chunks = []
        for path in sorted(sigs):
            if cursor.get(path) == sigs[path]:
                continue
            data = self._load_file(path, sigs[path])
            if data is not None:
                chunks.append(data)
            else:
                sigs.pop(path)
        return self._concat(chunks), sigs


def missing_samples(expected_n: int, present: Set[int]) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) ranges of missing sample ids (for resubmission)."""
    missing = sorted(set(range(expected_n)) - present)
    if not missing:
        return []
    ranges = []
    lo = prev = missing[0]
    for i in missing[1:]:
        if i != prev + 1:
            ranges.append((lo, prev + 1))
            lo = i
        prev = i
    ranges.append((lo, prev + 1))
    return ranges
