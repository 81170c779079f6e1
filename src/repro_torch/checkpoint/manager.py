"""CheckpointManager: atomic, elastic, optionally-async training-state
checkpoints built on the descriptor-WAL committer.

The port of ``repro/checkpoint/manager.py``.  The "multi-word" set
committed atomically per step is
  {params shards} U {opt shards} U {data-iterator state} U {rng} U {meta}
— a crash between any two of them can never produce a torn checkpoint
(the linked-list/payload problem of the paper's Fig. 1, at cluster scale).

Shards: every host commits its own slots; slots are named
``<group>.h<host>of<nhosts>``.  Elastic restore re-concatenates and
re-splits when the host count changes.

A group's state is a tree of nested dicts (string keys) with numpy
arrays (or anything ``np.asarray`` takes) at the leaves.  Its payload is
one npz holding every leaf under its key path (``"opt/m/units/..."``),
with no pickled tree structure: restoring rebuilds the nested dicts from
the paths.  The payload bytes differ from the reference's; the restored
trees and the persists a save costs are the same.
"""
from __future__ import annotations

import io
import json
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .committer import Committer, data_rel
from .pmem import PMemPool

SEP = "/"


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` of every leaf, keys sorted at every level (the
    reference's leaf order)."""
    if not isinstance(tree, dict):
        return [(SEP.join(path), tree)]
    out = []
    for key in sorted(tree):
        if not isinstance(key, str) or SEP in key or not key:
            raise ValueError(f"checkpoint keys must be non-empty strings "
                             f"without {SEP!r}: {key!r}")
        out += _flatten(tree[key], path + (key,))
    return out


def _unflatten(leaves: List[Tuple[str, Any]]):
    if len(leaves) == 1 and leaves[0][0] == "":
        return leaves[0][1]
    tree: Dict[str, Any] = {}
    for path, leaf in leaves:
        node = tree
        *head, last = path.split(SEP)
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _pack(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{path: np.asarray(x) for path, x in _flatten(tree)})
    return buf.getvalue()


def _unpack(data: bytes):
    npz = np.load(io.BytesIO(data))
    return _unflatten([(k, npz[k]) for k in npz.files])


def _split_tree(tree, n: int) -> List[Any]:
    """Split every leaf along axis 0 into n host shards (pad-free split of
    the leading dim when divisible; otherwise shard 0 holds the leaf)."""
    def split(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[0] % n == 0:
            return np.split(leaf, n, axis=0)
        return [leaf] + [np.zeros((0,) + leaf.shape[1:], leaf.dtype)] * (n - 1)

    leaves = _flatten(tree)
    per_host: List[List[Tuple[str, Any]]] = [[] for _ in range(n)]
    for path, leaf in leaves:
        for h, part in enumerate(split(leaf)):
            per_host[h].append((path, part))
    return [_unflatten(parts) for parts in per_host]


def _merge_trees(shards: List[Any]):
    def merge(*parts):
        parts = [np.asarray(p) for p in parts if np.asarray(p).size or
                 np.asarray(p).ndim == 0]
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=0)

    return _map(merge, *shards)


class CheckpointManager:
    def __init__(self, directory, n_hosts: int = 1, keep: int = 3,
                 pool: Optional[PMemPool] = None):
        self.pool = pool or PMemPool(directory)
        self.committer = Committer(self.pool)
        self.n_hosts = n_hosts
        self.keep = keep

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> bool:
        """Atomically commit all groups of `state` (one slot per group x
        host) as checkpoint `step`."""
        payloads: Dict[str, bytes] = {}
        targets: List[Tuple[str, int, int]] = []
        for group, tree in state.items():
            shards = _split_tree(tree, self.n_hosts)
            for h, shard in enumerate(shards):
                name = f"{group}.h{h}of{self.n_hosts}"
                payloads[name] = _pack(shard)
                targets.append((name, self.committer.slot_version(name),
                                step))
        meta = {"step": step, "groups": sorted(state),
                "n_hosts": self.n_hosts}
        name = "meta"
        payloads[name] = json.dumps(meta).encode()
        targets.append((name, self.committer.slot_version(name), step))
        return self.committer.commit(f"ckpt-{step}", targets, payloads)

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        self.committer.recover()
        v = self.committer.slot_version("meta")
        return v or None

    def restore(self, n_hosts: Optional[int] = None
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Recover + load the newest committed checkpoint, resharding to
        `n_hosts` if the cluster size changed (elastic restart)."""
        step = self.latest_step()
        if not step:
            return None
        meta = json.loads(self.pool.read(data_rel("meta", step)))
        saved_hosts = meta["n_hosts"]
        state = {}
        for group in meta["groups"]:
            shards = []
            for h in range(saved_hosts):
                name = f"{group}.h{h}of{saved_hosts}"
                ver = self.committer.slot_version(name)
                shards.append(_unpack(self.pool.read(data_rel(name, ver))))
            state[group] = _merge_trees(shards)
        return step, state


class AsyncCheckpointManager(CheckpointManager):
    """Double-buffered background checkpointing: `save_async` snapshots to
    host memory synchronously (cheap) and commits on a worker thread,
    overlapping the fsync-heavy commit with subsequent training steps."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._results: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state = item
            try:
                ok = self.save(step, state)
                self._results.put((step, ok, None))
            except Exception as e:  # noqa: BLE001 -- reported by wait()
                self._results.put((step, False, e))

    def save_async(self, step: int, state: Dict[str, Any]):
        snap = _map(lambda x: np.asarray(x).copy(), state)
        self._q.put((step, snap))  # blocks if previous commit still running

    def wait(self):
        """The ``(step, ok, error)`` of every commit finished since the
        last call."""
        results = []
        while not self._results.empty():
            results.append(self._results.get())
        return results

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=30)
