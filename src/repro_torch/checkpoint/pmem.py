"""A directory-backed "persistent memory" with explicit persist boundaries.

Maps the paper's memory model onto files: a *write* is visible (page cache =
"CPU cache") but not durable until *persist* (fsync = "clflush + sfence").
Atomic pointer flips use rename, the filesystem's CAS-like primitive.

Crash injection: constructing the pool with ``crash_after_persists=N``
raises SimulatedCrash on the N-th persist — tests sweep N across the whole
commit protocol, mirroring the simulator's crash sweeps.  A "crash" is then
modeled by REOPENING the directory fresh (page cache dropped is simulated
by the fact that recovery only trusts what was fsynced — we additionally
delete files written-but-not-persisted to emulate lost cache lines).
"""
from __future__ import annotations

import json
import os
import pathlib
import time
import zlib
from typing import Dict, Optional

from ..obs import record_fence, span


class SimulatedCrash(Exception):
    pass


class PMemPool:
    def __init__(self, root, crash_after_persists: Optional[int] = None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.crash_after = crash_after_persists
        self.persist_count = 0
        self.write_count = 0
        # wall-clock spent inside persist fences (fsync), for the
        # per-op persist_us attribution in the service stats
        self.persist_ns = 0
        # files written but not yet persisted ("dirty cache lines"), mapped
        # to their last DURABLE content (None = never existed durably) so a
        # crash can restore what the medium actually held
        self._unpersisted: Dict[pathlib.Path, Optional[bytes]] = {}

    # -- primitive ops --------------------------------------------------------
    def write(self, rel: str, data: bytes) -> pathlib.Path:
        """Visible but not durable (like a store into CPU cache)."""
        path = self.root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if path not in self._unpersisted:
            durable = path.read_bytes() if path.exists() else None
            self._unpersisted[path] = durable
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic visibility
        self.write_count += 1
        return path

    def persist(self, rel: str):
        """Durability barrier for one file (clflush analogue)."""
        path = self.root / rel
        self.persist_count += 1
        if self.crash_after is not None and \
                self.persist_count > self.crash_after:
            raise SimulatedCrash(f"crash before persisting {rel}")
        # the line is clean (nothing unpersisted under it) => this fence
        # changes no durable state; the provenance ledger flags it as
        # redundant — the instruction class the paper removes
        redundant = path not in self._unpersisted
        t0 = time.perf_counter_ns()
        with span("pmem.persist", rel=rel):
            with open(path, "rb") as f:
                os.fsync(f.fileno())
        self.persist_ns += time.perf_counter_ns() - t0
        record_fence(redundant=redundant)
        self._unpersisted.pop(path, None)

    def write_persist(self, rel: str, data: bytes):
        self.write(rel, data)
        self.persist(rel)

    def read(self, rel: str) -> bytes:
        with open(self.root / rel, "rb") as f:
            return f.read()

    def exists(self, rel: str) -> bool:
        return (self.root / rel).exists()

    def delete(self, rel: str):
        p = self.root / rel
        if p not in self._unpersisted:
            self._unpersisted[p] = p.read_bytes() if p.exists() else None
        if p.exists():
            p.unlink()

    def delete_persist(self, rel: str):
        """Durable unlink (the directory-fsync analogue): unlike
        :meth:`delete`, the file does NOT come back after a crash.
        Counts as one persist, so crash injection covers it too."""
        p = self.root / rel
        self.persist_count += 1
        if self.crash_after is not None and \
                self.persist_count > self.crash_after:
            raise SimulatedCrash(f"crash before durably deleting {rel}")
        # redundant iff there was durably nothing to delete and no
        # visible-but-dirty file to discard
        redundant = p not in self._unpersisted and not p.exists()
        t0 = time.perf_counter_ns()
        with span("pmem.persist", rel=rel, delete=True):
            if p.exists():
                p.unlink()
        self.persist_ns += time.perf_counter_ns() - t0
        record_fence(redundant=redundant)
        self._unpersisted.pop(p, None)

    def listdir(self, rel: str):
        d = self.root / rel
        if not d.exists():
            return []
        return sorted(x.name for x in d.iterdir())

    # -- cache-line introspection (epoch tests assert the bounded-loss
    # window directly against what is dirty) --------------------------------
    def is_dirty(self, rel: str) -> bool:
        """True if the file is visible but not durable (a crash now
        would revert it to its last persisted content)."""
        return (self.root / rel) in self._unpersisted

    @property
    def dirty_lines(self) -> int:
        """Files currently written-but-unpersisted."""
        return len(self._unpersisted)

    # -- crash model -----------------------------------------------------------
    def crash(self) -> "PMemPool":
        """Revert every file to its last durable content and reopen."""
        for p, durable in self._unpersisted.items():
            if durable is None:
                if p.exists():
                    p.unlink()
            else:
                p.write_bytes(durable)
        return PMemPool(self.root)

    # -- checksummed JSON records ----------------------------------------------
    def write_record(self, rel: str, obj: Dict, persist: bool = True):
        body = json.dumps(obj, sort_keys=True).encode()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        data = json.dumps({"crc": crc,
                           "body": obj}, sort_keys=True).encode()
        if persist:
            self.write_persist(rel, data)
        else:
            self.write(rel, data)

    def read_record(self, rel: str) -> Optional[Dict]:
        try:
            raw = json.loads(self.read(rel))
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        body = raw.get("body")
        crc = zlib.crc32(json.dumps(body, sort_keys=True).encode()) \
            & 0xFFFFFFFF
        if crc != raw.get("crc"):
            return None  # torn write: treat as absent (never persisted)
        return body
