"""Execution backends for the canonical PMwCAS operation model.

One batch semantics, three substrates:

=============  ==========================================  ==================
backend        substrate                                   wraps
=============  ==========================================  ==================
SimBackend     cycle-accurate many-core simulator          core.engine / sim
KernelBackend  batched Hopper kernel (CUDA) / plain torch  kernels.pmwcas_apply
DurableBackend file-granularity descriptor-WAL committer   checkpoint.committer
=============  ==========================================  ==================

``KernelBackend`` is a word table on a torch device plus the batched
MwCAS primitive, which runs the hand-written Hopper kernel on a CUDA
table and its plain PyTorch version on a CPU table.  ``DurableBackend``
is host code over a :class:`repro_torch.checkpoint.PMemPool`: it holds
no tensors and takes no device.  ``SimBackend`` runs each batch through
the micro-op machines, on the card in one launch of the simulator kernel
(``csrc/pmwcas_sim.cu``), on the CPU through its plain version.

Canonical batch semantics (DESIGN.md Sec. 3.2) — *deterministic one-shot*:
the batch executes against the pre-batch state with index order as the
linearization.  Op ``i`` succeeds iff

  (a) every target's expected value matches the pre-batch state, and
  (b) no lower-index op that also passes (a) targets a shared address.

``KernelBackend`` and ``DurableBackend`` implement exactly this.
``SimBackend`` replays the batch through the micro-op state machines (one
attempt per op, expected values read before any attempt runs) which
yields the *winner-blocking* refinement of (b): an (a)-passing op that
itself lost does not block later ops, because the state machine rolls its
reservations back before the next attempt starts.  The two verdicts
coincide on any batch in which every pair of address-sharing ops involves
an actual winner — the differential test constructs such batches, and
``repro_torch.pmwcas.differential`` asserts three-way agreement.
"""
from __future__ import annotations

import pathlib
import tempfile
from typing import (Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.checkpoint.committer import (Committer, DurabilityStats,
                                              _slot_rel, data_rel)
from repro_torch.checkpoint.marker_committer import MarkerCommitter
from repro_torch.checkpoint.pmem import PMemPool
from repro_torch.core import SimConfig
from repro_torch.core.model import (ALG_PCAS, TAG_MASK, TAG_SHIFT,
                                    init_state, state_to_arrays)
from repro_torch.core.sim import run_jobs
from repro_torch.kernels.pmwcas_sim.kernel import (ERR_READ_PHASE,
                                                   MODE_BACKEND, O_ERR,
                                                   O_ERR_THREAD, SimJob)
from repro_torch.kernels.pmwcas_apply.ops import (pmwcas_apply,
                                                  tensor_to_words,
                                                  words_to_tensor)
from repro_torch.obs import span

from .algorithms import Algorithm, OURS, resolve
from .descriptor import (Addr, Descriptor, MwCASOp, OpResult,
                         ops_to_arrays, results_from_mask)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it without a card raises rather than running
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false; pass device='cpu' for the plain PyTorch version")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@runtime_checkable
class Backend(Protocol):
    """What every PMwCAS execution backend provides."""
    name: str

    def execute(self, ops: Sequence[MwCASOp]) -> List[OpResult]:
        """Run one batch under the deterministic one-shot semantics."""
        ...

    def read(self, addr: Addr) -> int:
        """Current committed value of one word/slot."""
        ...


class KernelBackend:
    """Word table on a torch device + the batched MwCAS primitive.

    The table holds the uint32 words as their int32 bit patterns;
    :meth:`read` and :meth:`values` give them back as uint32 values.
    """
    name = "kernel"

    def __init__(self, n_words: Optional[int] = None,
                 values: Optional[Sequence[int]] = None, *,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if values is not None:
            self._words = words_to_tensor(np.asarray(values, np.uint32),
                                          self.device)
        elif n_words is not None:
            self._words = torch.zeros(n_words, dtype=torch.int32,
                                      device=self.device)
        else:
            raise ValueError("need n_words or values")

    # -- Backend protocol ------------------------------------------------------
    def execute(self, ops: Sequence[MwCASOp],
                k: Optional[int] = None) -> List[OpResult]:
        with span("mwcas.round", backend=self.name, ops=len(ops)):
            addr, exp, des = (words_to_tensor(a, self.device)
                              for a in ops_to_arrays(ops, k))
            _, success = pmwcas_apply(self._words, addr, exp, des)
            return results_from_mask(ops, success.cpu().numpy(), self.name)

    def read(self, addr: Addr) -> int:
        if not isinstance(addr, int):
            raise TypeError(f"kernel backend uses int addresses, got {addr!r}")
        return int(self._words[addr]) & 0xFFFFFFFF

    def values(self) -> np.ndarray:
        """A host copy of the table as uint32 words."""
        return tensor_to_words(self._words)

    def read_words(self, lo: int, hi: int) -> np.ndarray:
        """Words ``lo:hi`` (clipped to the table) as uint32, in one copy
        to the host."""
        return tensor_to_words(self._words[lo:hi])

    # -- sharded-service surface ----------------------------------------------
    @property
    def n_words(self) -> int:
        return int(self._words.shape[0])

    def word_table(self) -> torch.Tensor:
        """The live device word table (int32[W] bit patterns).  Under the
        sharded service's stacked dispatch it is a view of this shard's
        row of one persistent ``[S, W]`` tensor (:meth:`bind_row`), which
        ONE kernel launch per wave updates in place for every shard."""
        return self._words

    def set_word_table(self, new: torch.Tensor) -> None:
        """Overwrite the table with ``new`` (copied into the live table,
        so a view bound by :meth:`bind_row` stays bound).  Must match
        :meth:`word_table` in shape, dtype and device."""
        self._check_like(new)
        self._words.copy_(new)

    def bind_row(self, row: torch.Tensor) -> None:
        """Move the table into ``row``, a view of a caller's persistent
        stacked tensor: the current words are copied in once, and from
        then on every read, round and :meth:`set_word_table` works on
        the view."""
        self._check_like(row)
        row.copy_(self._words)
        self._words = row

    def _check_like(self, t: torch.Tensor) -> None:
        if t.shape != self._words.shape or t.dtype != torch.int32 \
                or t.device != self._words.device:
            raise ValueError(
                f"word table {tuple(t.shape)} {t.dtype} on "
                f"{t.device} != {tuple(self._words.shape)} int32 on "
                f"{self._words.device}")


class UnsupportedBatch(ValueError):
    """The backend cannot express this batch (see SimBackend limits)."""


# ===========================================================================
# Simulator backend
# ===========================================================================

class SimBackend:
    """One-shot batches through the cycle-accurate micro-op state machines.

    Each op becomes one simulated thread running exactly one attempt:
    every thread first reads its targets (so all expected values are
    pre-batch), then attempts run to their operation boundary in index
    order.  Success is the thread's own verdict (op_idx advanced); the
    word table is carried across ``execute`` calls.  A batch is one
    launch of the simulator kernel on ``device`` (``"cuda"``, the
    default; it raises without a card) or its plain version on
    ``"cpu"``.

    Arbitrary desired values are native: the machines take explicit
    per-target desired payloads (``ops_des`` in the engine state), so
    structure rounds — whose desireds are keys, values and TOMBSTONEs,
    not increments — run without shadowing onto fresh words.  Two
    per-batch remaps make that fit the engine:

    - a *value codec*: the machines compare words only for equality, so
      payloads are injectively renumbered into small ids (keeping every
      real value, including ``TOMBSTONE = 2**32 - 1``, inside the
      ``32 - TAG_SHIFT``-bit payload field) and decoded on write-back;
    - *address compression + private pads*: touched addresses compress
      to ``0..n-1`` (monotonic, so canonical sorted order is preserved)
      and each op narrower than the batch's widest is padded to uniform
      width with fresh private guard words (expected == desired == 0)
      appended above the compressed range — invisible to the conflict
      graph, required because one engine config has a single ``k``.

    Limits (``UnsupportedBatch`` otherwise):

    - expected values must equal the current stored values: one-shot
      batches take pre-batch expecteds;
    - addresses sorted (the paper's canonical embedding order), distinct
      within an op, int only, in range;
    - the PCAS strategy only supports k == 1 and increment-shaped ops
      (its state machine is hard-wired to ``CAS(v -> v+1)``).

    Instrumentation: the batch's per-thread counters (int64) are exposed
    as ``counters`` after each batch, so the same batch can be costed in
    modeled cycles.
    """
    name = "sim"

    def __init__(self, n_words: int,
                 algorithm: Union[str, Algorithm] = OURS,
                 values: Optional[Sequence[int]] = None, *,
                 attempt_cap: int = 10_000,
                 device: Union[str, torch.device] = "cuda"):
        self.algorithm = resolve(algorithm)
        self.n_words = n_words
        self.device = resolve_device(device)
        self._values = (np.zeros(n_words, np.uint32) if values is None
                        else np.asarray(values, np.uint32).copy())
        if self._values.shape != (n_words,):
            raise ValueError("values shape mismatch")
        self.attempt_cap = attempt_cap
        self.counters: Optional[np.ndarray] = None

    # -- validation ------------------------------------------------------------
    def _check_batch(self, ops: Sequence[MwCASOp]) -> int:
        if not ops:
            raise UnsupportedBatch("empty batch")
        k_max = max(op.k for op in ops)
        for i, op in enumerate(ops):
            if not self.algorithm.supports_k(op.k):
                raise UnsupportedBatch(
                    f"{self.algorithm.name} supports k<="
                    f"{self.algorithm.max_k}, got {op.k}")
            if self.algorithm.name == ALG_PCAS and not op.is_increment():
                raise UnsupportedBatch(
                    f"op {i} is not increment-shaped; the PCAS machine is "
                    "hard-wired to CAS(v -> v+1)")
            addrs = list(op.addrs)
            if any(not isinstance(a, int) for a in addrs):
                raise UnsupportedBatch(f"op {i} has non-int addresses")
            if addrs != sorted(addrs):
                raise UnsupportedBatch(
                    f"op {i} addresses not in canonical sorted order")
            if len(set(addrs)) != len(addrs):
                raise UnsupportedBatch(f"op {i} has duplicate addresses")
            if any(a < 0 or a >= self.n_words for a in addrs):
                raise UnsupportedBatch(f"op {i} address out of range")
            for t in op.targets:
                if t.expected != int(self._values[t.addr]):
                    raise UnsupportedBatch(
                        f"op {i} expects {t.expected} at word {t.addr} but "
                        f"the simulator holds {int(self._values[t.addr])}; "
                        "one-shot batches take pre-batch expected values")
        return k_max

    # -- Backend protocol ------------------------------------------------------
    def execute(self, ops: Sequence[MwCASOp]) -> List[OpResult]:
        with span("mwcas.round", backend=self.name, ops=len(ops)):
            return self._execute(ops)

    def _execute(self, ops: Sequence[MwCASOp]) -> List[OpResult]:
        k_max = self._check_batch(ops)
        B = len(ops)
        # compress touched addresses to 0..n-1 (monotonic) and lay private
        # pad words above the compressed range
        touched = sorted({a for op in ops for a in op.addrs})
        index = {a: i for i, a in enumerate(touched)}
        n_pads = sum(k_max - op.k for op in ops)
        # value codec: renumber payloads into dense ids (0 always encodes
        # to id 0, so pad words need no seeding)
        vals = sorted({0} | {int(self._values[a]) for a in touched}
                      | {int(t.desired) for op in ops for t in op.targets})
        if len(vals) >= 1 << (32 - TAG_SHIFT):
            raise UnsupportedBatch("too many distinct payload values")
        enc = {v: i for i, v in enumerate(vals)}
        dec = np.asarray(vals, np.uint32)
        addr_rows: List[List[int]] = []
        des_rows: List[List[int]] = []
        next_pad = len(touched)
        for op in ops:
            pads = list(range(next_pad, next_pad + (k_max - op.k)))
            next_pad += len(pads)
            addr_rows.append([index[a] for a in op.addrs] + pads)
            des_rows.append([enc[int(t.desired)] for t in op.targets]
                            + [0] * len(pads))
        # the word count rounded up to a power of two, as the reference
        # does (it shapes the state, the lines and so the counters)
        n_sim = max(k_max, len(touched) + n_pads)
        n_sim = 1 << (n_sim - 1).bit_length() if n_sim > 1 else 1
        cfg = SimConfig(algorithm=self.algorithm.name, n_threads=B,
                        n_words=n_sim, k=k_max, max_ops=1, n_steps=1)
        ops_arr = np.asarray(addr_rows, np.int32).reshape(B, 1, k_max)
        des_arr = np.asarray(des_rows, np.uint32).reshape(B, 1, k_max)
        st = init_state(cfg, ops_arr, ops_des=des_arr, device=self.device)
        mem = np.zeros(n_sim, np.uint32)
        mem[:len(touched)] = [enc[int(self._values[a])] for a in touched]
        word = torch.as_tensor((mem << TAG_SHIFT).view(np.int32),
                               device=self.device)
        st["cache"].copy_(word)
        st["pmem"].copy_(word)

        # phase 1: every thread reads its targets (pre-batch expecteds);
        # phase 2: attempts run to their op boundary in index order
        out = run_jobs([SimJob(cfg, st, np.zeros(0, np.int32),
                               mode=MODE_BACKEND,
                               attempt_cap=self.attempt_cap)])[0]
        if out[O_ERR] == ERR_READ_PHASE:
            raise RuntimeError("read phase did not converge")
        if out[O_ERR]:
            raise RuntimeError(f"attempt of op {int(out[O_ERR_THREAD])} "
                               "did not converge")
        host = state_to_arrays(st)
        success = host["op_idx"] == 1
        cache = host["cache"]
        tags = cache & int(TAG_MASK)
        if not (tags == 0).all():
            raise AssertionError("batch left non-payload tags in cache")
        ids = (cache >> TAG_SHIFT).astype(np.int64)
        for a, i in index.items():          # decode ids back to real values
            self._values[a] = dec[ids[i]]
        self.counters = host["counters"]
        return results_from_mask(ops, success, self.name)

    def read(self, addr: Addr) -> int:
        if not isinstance(addr, int):
            raise TypeError(f"sim backend uses int addresses, got {addr!r}")
        return int(self._values[addr])

    def values(self) -> np.ndarray:
        return self._values.copy()


# ===========================================================================
# Durable backend
# ===========================================================================

class DurableBackend:
    """Descriptor-WAL committer as a PMwCAS backend (values = slot versions).

    Every successful op is a real :class:`repro_torch.checkpoint.Committer`
    commit — persisted WAL record, durability linearization point,
    finalize — so a crash at any point recovers to a batch prefix.  The
    one-shot verdict logic (condition (b) above) runs on a pre-batch
    snapshot of slot versions, mirroring the kernel's conservative
    semantics exactly.

    With ``group_commit=True`` (the default; requires the WAL
    committer) a whole batch commits through
    :meth:`repro_torch.checkpoint.Committer.commit_round`: one coalesced
    WAL record and ONE persist fence per round instead of the per-op
    3k+2-flush protocol.  Crash windows collapse to a single question —
    was the round record durable?  (yes → recovery redoes the round; no
    → the round never happened.)  ``durability_stats`` exposes the
    flushes issued/saved and fence counts.

    With ``epoch_rounds > 1`` (requires group commit) rounds buffer into
    a durability epoch sharing ONE fence (DESIGN.md Sec. 14): a round's
    verdict is final at :meth:`execute` return but durable only at the
    next epoch close — :meth:`sync` is the explicit barrier, and a crash
    loses at most ``epoch_rounds - 1`` committed rounds, never a torn
    one.  ``checkpoint_every = N`` persists a checkpoint image every N
    epoch closes so recovery replay stays bounded; :attr:`epoch_pending`
    exposes the open window.

    The backend is host code: it holds no tensors and takes no device.
    """
    name = "durable"

    def __init__(self, root: Union[str, pathlib.Path, None] = None, *,
                 pool: Optional[PMemPool] = None,
                 committer: Union[str, type] = "wal",
                 group_commit: bool = True, epoch_rounds: int = 1,
                 checkpoint_every: int = 0):
        self._tmpdir = None
        if pool is None:
            if root is None:
                # auto-cleaned on GC/interpreter exit (no /tmp litter)
                self._tmpdir = tempfile.TemporaryDirectory(
                    prefix="pmwcas_durable_")
                root = self._tmpdir.name
            pool = PMemPool(root)
        self.pool = pool
        if committer in ("wal", Committer):
            self._committer_cls = Committer
        elif committer in ("marker", MarkerCommitter):
            self._committer_cls = MarkerCommitter
        else:
            raise ValueError(f"unknown committer {committer!r}")
        self.committer = self._committer_cls(
            pool, epoch_rounds=epoch_rounds,
            checkpoint_every=checkpoint_every)
        self.group_commit = bool(group_commit) and getattr(
            self._committer_cls, "supports_rounds", False)
        if int(epoch_rounds) > 1 and not self.group_commit:
            raise ValueError("epoch_rounds > 1 requires group commit "
                             "(epochs buffer coalesced round records)")
        self.epoch_rounds = max(1, int(epoch_rounds))
        self.checkpoint_every = max(0, int(checkpoint_every))
        self._seq = 0

    # -- setup -----------------------------------------------------------------
    def seed(self, values: Mapping[Addr, int],
             payload_for=None) -> None:
        """Initialize slot versions (and their data files) directly."""
        payload_for = payload_for or self._default_payload
        for addr, ver in values.items():
            name = addr if isinstance(addr, str) else f"w{addr}"
            self.pool.write_record(_slot_rel(name), {"version": int(ver)})
            if ver:
                self.pool.write_persist(data_rel(name, int(ver)),
                                        payload_for(name, int(ver)))

    @staticmethod
    def _default_payload(name: str, version: int) -> bytes:
        return f"{name}:v{version}".encode()

    # -- Backend protocol ------------------------------------------------------
    def execute(self, ops: Sequence[MwCASOp],
                payloads: Optional[Mapping[str, bytes]] = None
                ) -> List[OpResult]:
        with span("mwcas.round", backend=self.name, ops=len(ops)):
            return self._execute(ops, payloads)

    def _execute(self, ops: Sequence[MwCASOp],
                 payloads: Optional[Mapping[str, bytes]] = None
                 ) -> List[OpResult]:
        names = {t.slot_name for op in ops for t in op.targets}
        snapshot = {n: self.committer.slot_version(n) for n in names}
        claimed: set = set()
        verdicts: List[bool] = []
        to_commit: List[Tuple[int, Descriptor]] = []
        pls: Dict[str, bytes] = {}
        for i, op in enumerate(ops):
            op_names = [t.slot_name for t in op.targets]
            passes = all(snapshot[n] == t.expected
                         for n, t in zip(op_names, op.targets))
            blocked = passes and any(n in claimed for n in op_names)
            if passes:
                claimed.update(op_names)
            ok = passes and not blocked
            if ok:
                # guard words (desired == expected) participate in the
                # verdict above but are trivially satisfied — the committer
                # only moves targets whose version actually advances
                moving = [t for t in op.targets if t.desired != t.expected]
                if moving:
                    to_commit.append((i, Descriptor(
                        op_id=f"mwcas-{self._seq}-{i}", op=MwCASOp(moving))))
                    pls.update({t.slot_name: (payloads or {}).get(
                        t.slot_name,
                        self._default_payload(t.slot_name, t.desired))
                        for t in moving})
            verdicts.append(ok)
        if to_commit:
            if self.group_commit:
                # one coalesced WAL record, one persist fence per round
                round_ok = self.committer.commit_round(
                    [(desc.op_id, desc.slot_targets())
                     for _i, desc in to_commit], pls)
                for (i, _desc), ok in zip(to_commit, round_ok):
                    verdicts[i] = ok
            else:
                for i, desc in to_commit:
                    op_pls = {n: pls[n] for n, _e, _d in desc.slot_targets()}
                    verdicts[i] = self.committer.commit(
                        desc.op_id, desc.slot_targets(), op_pls)
        results = [OpResult(index=i, success=ok, backend=self.name, op=op)
                   for i, (op, ok) in enumerate(zip(ops, verdicts))]
        self._seq += 1
        return results

    def read(self, addr: Addr) -> int:
        name = addr if isinstance(addr, str) else f"w{addr}"
        return self.committer.slot_version(name)

    # -- durability surface ----------------------------------------------------
    @property
    def durability_stats(self) -> DurabilityStats:
        """Flush/fence accounting of the underlying committer."""
        return self.committer.stats

    def recover(self) -> Dict[str, int]:
        return self.committer.recover()

    def sync(self) -> int:
        """Close the open durability epoch (one fence); returns rounds
        made durable.  No-op outside epoch mode."""
        return self.committer.sync()

    def checkpoint(self) -> int:
        """Persist a checkpoint image and durably drop the round/epoch
        records it covers (closes the open epoch first).  No-op for the
        marker baseline (its commits are durable per slot already)."""
        ckpt = getattr(self.committer, "checkpoint", None)
        return ckpt() if ckpt is not None else 0

    @property
    def epoch_pending(self) -> int:
        """Rounds committed-but-unfenced in the open epoch."""
        return getattr(self.committer, "epoch_pending", 0)

    def prune_completed(self) -> int:
        """WAL hygiene: durably drop spent descriptor records (every op
        writes one; without pruning ``wal/`` grows without bound).  Safe
        at any point — recovery never consults an unreferenced record —
        and the structure crash sweeps assert exactly that in their
        teardown."""
        return self.committer.prune_completed()

    def crash(self) -> "DurableBackend":
        """Simulate a crash: drop unpersisted writes, reopen, recover.

        The durability ledger survives the crash: the new backend's
        committer keeps accumulating into THIS backend's
        ``DurabilityStats`` object, so flush/fence counters are monotone
        across crash/recover cycles (a crash must never zero — or
        double-count — the measurement window)."""
        with span("backend.crash_recover", backend=self.name):
            new = DurableBackend(pool=self.pool.crash(),
                                 committer=self._committer_cls,
                                 group_commit=self.group_commit,
                                 epoch_rounds=self.epoch_rounds,
                                 checkpoint_every=self.checkpoint_every)
            new.committer.stats = self.committer.stats
            new.recover()
        return new


# ===========================================================================
# Backend factory hooks (the sharded service builds per-shard backends
# through this registry, so deployments can plug in their own substrate)
# ===========================================================================

def _make_sim(n_words: Optional[int] = None, **kw) -> SimBackend:
    if n_words is None:
        raise ValueError("sim backend needs n_words")
    return SimBackend(n_words, **kw)


def _make_kernel(n_words: Optional[int] = None, **kw) -> KernelBackend:
    return KernelBackend(n_words=n_words, **kw)


def _make_durable(n_words: Optional[int] = None, **kw) -> DurableBackend:
    # the durable word space is the (unbounded) slot-name namespace, so
    # n_words is accepted-and-ignored for factory-signature uniformity
    return DurableBackend(**kw)


BACKEND_FACTORIES: Dict[str, Callable[..., Backend]] = {
    "sim": _make_sim,
    "kernel": _make_kernel,
    "durable": _make_durable,
}


def register_backend(name: str, factory: Callable[..., Backend],
                     replace: bool = False) -> None:
    """Register a custom backend factory under ``name`` (usable anywhere
    a backend kind string is accepted, e.g. ``KVService(backend=name)``).
    The factory must accept ``n_words`` as a keyword (ignore it if the
    substrate is not array-shaped)."""
    if name in BACKEND_FACTORIES and not replace:
        raise ValueError(f"backend kind {name!r} already registered")
    BACKEND_FACTORIES[name] = factory


def make_backend(spec: Union[str, Callable[..., Backend], Backend],
                 **kw) -> Backend:
    """Resolve a backend spec into an instance.

    ``spec`` may be a registered kind name (``"sim"`` / ``"kernel"`` /
    ``"durable"`` / anything added via :func:`register_backend`), a
    callable factory
    (called with the keyword arguments), or an existing :class:`Backend`
    instance (returned as-is; passing construction kwargs alongside an
    instance is an error).
    """
    if isinstance(spec, str):
        factory = BACKEND_FACTORIES.get(spec)
        if factory is not None:
            return factory(**kw)
        raise ValueError(f"unknown backend kind {spec!r}; registered: "
                         f"{sorted(BACKEND_FACTORIES)}")
    # classes pass the runtime Protocol check (their *attributes* exist on
    # the class object), so treat any type as a factory first
    if not isinstance(spec, type) and isinstance(spec, Backend):
        if kw:
            raise ValueError(
                f"cannot apply kwargs {sorted(kw)} to an existing "
                "backend instance")
        return spec
    if callable(spec):
        return spec(**kw)
    raise TypeError(f"backend spec {spec!r} is not a kind name, factory "
                    "or Backend")
