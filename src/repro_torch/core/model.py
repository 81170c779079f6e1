"""State model for the PMwCAS concurrency simulator.

The simulator models a many-core CPU with a coherent cache hierarchy in
front of persistent memory, at the granularity the paper reasons about:

- ``cache``  -- the CPU-cache-visible value of every word (what loads/CAS see)
- ``pmem``   -- the persisted value of every word (what survives a crash)
- ``line_owner`` -- which thread's cache currently owns each 64-byte line
  (modified state); writes by another thread count an *invalidation*,
  the contention signal the paper attributes the original algorithm's
  collapse to.

Words are uint32 with the paper's low tag bits (Table 2).  State lives in
torch tensors on one device; a uint32 field (``cache``, ``pmem``, the
descriptors' expected/desired words, ``exp``, ``ops_des``) holds the
words' bit patterns as int32, the port's convention.
:func:`state_from_arrays` and :func:`state_to_arrays` carry a state
between that form and numpy arrays of the reference's dtypes.

Geometry is faithful to the paper's benchmark (Fig. 8): each word
logically occupies the head of a ``block_bytes``-sized memory block, so
``words_per_line = max(1, 64 // block_bytes)`` words share a cache line
(the Fig. 14 false-sharing study).  Descriptors live on their own lines
after the word array.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Algorithms (paper Section 5's four competitors)
# ---------------------------------------------------------------------------
ALG_OURS = "ours"            # Section 4: no dirty flags (descriptor-as-WAL)
ALG_OURS_DF = "ours_df"      # Section 3: with dirty flags
ALG_ORIGINAL = "original"    # Wang et al. (ICDE'18): RDCSS install + helping
ALG_PCAS = "pcas"            # Wang et al.'s persistent single-word CAS
ALGORITHMS = (ALG_OURS, ALG_OURS_DF, ALG_ORIGINAL, ALG_PCAS)

# ---------------------------------------------------------------------------
# Word tagging.
#
# Ours (Table 2, 2 low bits):   00 payload | 10 descriptor | 01 dirty payload
# Original (3 low bits):        adds an RDCSS-intermediate tag (bit 2) and may
#                               combine descriptor/dirty bits.
# A payload value v is stored as (v << TAG_SHIFT) | tag.
# ---------------------------------------------------------------------------
TAG_SHIFT = 3  # one shared shift so both schemes coexist in one word array
TAG_MASK = np.uint32((1 << TAG_SHIFT) - 1)

TAG_PAYLOAD = np.uint32(0b000)
TAG_DIRTY = np.uint32(0b001)    # payload with dirty flag
TAG_DESC = np.uint32(0b010)     # PMwCAS descriptor pointer
TAG_DESC_DIRTY = np.uint32(0b011)
TAG_RDCSS = np.uint32(0b100)    # original algorithm's intermediate descriptor

# Descriptor states (paper Table 1).  The original (Wang et al.) algorithm
# additionally distinguishes an Undecided status during its install phase.
ST_COMPLETED = 0
ST_FAILED = 1
ST_SUCCEEDED = 2
ST_UNDECIDED = 3

# Sentinel in the per-op desired-value table (``ops_des``): "desired =
# expected + 1", the paper's benchmark shape.  Payloads are < 2**(32 -
# TAG_SHIFT) (they are stored shifted), so the all-ones word can never be
# a real desired value.
DES_INCREMENT = np.uint32(0xFFFFFFFF)
# The original algorithm's status word carries its own dirty bit; it is
# tracked as a separate field on the descriptor ("d_state_dirty").

_PAYLOAD_MASK = 0xFFFFFFFF >> TAG_SHIFT


def encode(value, tag=TAG_PAYLOAD):
    """``(value << TAG_SHIFT) | tag`` as uint32 words: numpy uint32 for
    numpy or Python input, int32 bit patterns for a torch tensor."""
    if isinstance(value, torch.Tensor):
        return _i64_to_i32((value.to(torch.int64) << TAG_SHIFT) | int(tag))
    value = np.asarray(value, np.uint32)
    return (value << np.uint32(TAG_SHIFT)) | np.uint32(tag)


def decode(word):
    """``(payload, tag)`` of uint32 words (numpy, or a torch tensor of
    int32 bit patterns; ``>>`` on int32 sign-extends, so the payload is
    masked)."""
    if isinstance(word, torch.Tensor):
        w = word.to(torch.int64) & 0xFFFFFFFF
        return w >> TAG_SHIFT, w & int(TAG_MASK)
    word = np.asarray(word, np.uint32)
    return word >> np.uint32(TAG_SHIFT), word & TAG_MASK


def _i64_to_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as int32 bit patterns."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def np_encode(value: int, tag: int = 0) -> int:
    return (int(value) << TAG_SHIFT) | int(tag)


def np_decode(word: int) -> Tuple[int, int]:
    return int(word) >> TAG_SHIFT, int(word) & int(TAG_MASK)


# ---------------------------------------------------------------------------
# Cycle-cost model.  Instruction/invalidation COUNTS are exact; these
# constants only convert counts into modeled wall-cycles for the throughput
# figures.  Calibrated once and then frozen.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CostModel:
    local: int = 1          # register/ALU micro-op
    load_hit: int = 2       # load from an owned/shared line
    load_miss: int = 24     # load needing a coherence transfer
    cas_owned: int = 6      # CAS on a line already in M state locally
    cas_remote: int = 40    # CAS stealing the line (invalidation)
    store_owned: int = 2
    store_remote: int = 30
    flush: int = 250        # clflushopt to Optane (~100ns-class)
    flush_clean: int = 60   # flushing a line that is not locally modified
    wait: int = 4           # one back-off step

    def as_array(self) -> np.ndarray:
        """The ten costs in ``C_*`` order, int64."""
        return np.array(
            [self.local, self.load_hit, self.load_miss, self.cas_owned,
             self.cas_remote, self.store_owned, self.store_remote,
             self.flush, self.flush_clean, self.wait], dtype=np.int64)


# Cost indices (into CostModel.as_array()).
C_LOCAL, C_LOAD_HIT, C_LOAD_MISS, C_CAS_OWNED, C_CAS_REMOTE = 0, 1, 2, 3, 4
C_STORE_OWNED, C_STORE_REMOTE, C_FLUSH, C_FLUSH_CLEAN, C_WAIT = 5, 6, 7, 8, 9


# ---------------------------------------------------------------------------
# Simulator configuration.  Frozen + hashable.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SimConfig:
    algorithm: str = ALG_OURS
    n_threads: int = 8
    n_words: int = 1 << 16          # paper: 1e6; tests use smaller
    k: int = 3                      # words per PMwCAS
    block_bytes: int = 256          # Fig. 8 memory-block size
    alpha: float = 0.0              # Zipf skew (Eq. 1)
    max_ops: int = 256              # distinct pre-generated ops per thread
    n_steps: int = 20_000           # scheduler micro-steps
    seed: int = 0
    backoff_init: int = 4           # back-off (paper Sec. 3 impl notes)
    backoff_cap: int = 256
    cost: CostModel = dataclasses.field(default_factory=CostModel)

    # Derived geometry -----------------------------------------------------
    @property
    def words_per_line(self) -> int:
        # 64-byte cache lines; each word heads a block_bytes-sized block.
        return max(1, 64 // self.block_bytes)

    @property
    def n_word_lines(self) -> int:
        wpl = self.words_per_line
        return (self.n_words + wpl - 1) // wpl

    @property
    def desc_lines(self) -> int:
        # state+count header (16B) + k * 24B of target info, 64B lines
        return (16 + self.k * 24 + 63) // 64

    @property
    def n_lines(self) -> int:
        return self.n_word_lines + self.n_threads * self.desc_lines

    def desc_line(self, tid):
        """First cache line of thread `tid`'s descriptor."""
        return self.n_word_lines + tid * self.desc_lines

    def validate(self) -> "SimConfig":
        assert self.algorithm in ALGORITHMS, self.algorithm
        assert self.k >= 1
        if self.algorithm == ALG_PCAS:
            assert self.k == 1, "PCAS is single-word"
        assert self.n_words >= self.k
        return self


# ---------------------------------------------------------------------------
# Program counters (micro-op state machines).  One memory event per step.
# ---------------------------------------------------------------------------
class PC:
    # shared front-end: benchmark reads current values (read procedure Fig. 5)
    READ_TGT = 0
    READ_WAIT = 1
    INIT_DESC = 2          # Fig.4 line 1 (state <- Failed; fill targets)
    PERSIST_DESC = 3       # Fig.4 line 2
    RESERVE_TEST = 4       # TTAS load (impl. details, Sec. 3)
    RESERVE_WAIT = 5       # back-off while another PMwCAS is in flight
    RESERVE_CAS = 6        # Fig.4 line 6
    PERSIST_TGT = 7        # Fig.4 line 13
    SET_SUCC = 8           # Fig.4 line 14
    PERSIST_STATE = 9      # Fig.4 line 15 (durability linearization point)
    FIN_STORE_DIRTY = 10   # Fig.4 line 21 (ours_df only)
    FIN_PERSIST_DIRTY = 11  # Fig.4 line 22
    FIN_STORE = 12         # Fig.4 line 23
    FIN_PERSIST = 13       # Fig.4 line 24
    OP_DONE = 14           # Fig.4 line 25 (state <- Completed; next op)

    # original (Wang et al.) extras: RDCSS two-phase install + dirty handling
    O_RDCSS_CAS = 15       # CAS #1: install RDCSS intermediate
    O_PROMOTE_CAS = 16     # CAS #2: promote to MwCAS descriptor (|dirty)
    O_PERSIST_TGT = 17     # flush the installed (dirty) descriptor word
    O_CLEAR_TGT = 18       # store: clear the dirty bit on the descriptor word
    O_STATUS_CAS = 19      # CAS #3-class: Undecided -> Succeeded/Failed |dirty
    O_STATUS_PERSIST = 20
    O_STATUS_CLEAR = 21
    O_FIN_CAS = 22         # CAS #4: descriptor -> final value |dirty
    O_FIN_PERSIST = 23
    O_FIN_CLEAR = 24       # store: clear dirty on final value

    # helping (original only): a reader/installer that hits a foreign
    # descriptor completes that operation before retrying its own.
    H_TEST = 25
    H_CAS = 26
    H_STATUS_CAS = 27
    H_FIN_CAS = 28
    H_FIN_PERSIST = 29
    H_FIN_CLEAR = 30

    # PCAS
    P_READ = 31
    P_CAS = 32             # CAS(v -> (v+1)|dirty)
    P_PERSIST = 33
    P_CLEAR = 34           # store clean value

    COUNT = 35


# Counter slots (per thread).
CNT_CAS = 0          # CAS-class events (incl. atomic finalize stores)
CNT_FLUSH = 1
CNT_LOAD = 2
CNT_STORE = 3
CNT_INVAL = 4        # cache-line invalidations this thread caused
CNT_OPS = 5          # completed (successful) PMwCAS operations
CNT_FAILS = 6        # failed PMwCAS attempts (op retried)
CNT_CYCLES = 7       # modeled cycles consumed by this thread
CNT_HELPS = 8        # helping episodes entered (original only)
N_COUNTERS = 9


def start_pc(algorithm: str) -> int:
    """Where every thread of ``algorithm`` starts an operation."""
    return PC.P_READ if algorithm == ALG_PCAS else PC.READ_TGT


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    """Eq. (1): f(k; alpha, |W|) over word ranks 1..n."""
    if alpha == 0.0:
        return np.full(n, 1.0 / n)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def generate_ops(cfg: SimConfig) -> np.ndarray:
    """Pre-generate [n_threads, max_ops, k] distinct, address-sorted targets.

    The paper's benchmark selects k words per operation by Zipf rank and
    embeds descriptors in a canonical (sorted) address order so that
    concurrent PMwCAS operations cannot deadlock (Sec. 2.1).  The draws
    are the reference's, call for call, so the tables are equal.
    """
    rng = np.random.default_rng(cfg.seed)
    p = zipf_probs(cfg.n_words, cfg.alpha)
    # Popularity rank r maps to word id perm[r] (stable shuffle).
    perm = rng.permutation(cfg.n_words)
    shape = (cfg.n_threads, cfg.max_ops, cfg.k)
    ranks = rng.choice(cfg.n_words, size=shape, p=p)
    # Reject duplicate words within an op (sample-until-distinct).
    for _ in range(64):
        ids = perm[ranks]
        srt = np.sort(ids, axis=-1)
        d = srt[..., 1:] == srt[..., :-1]
        if not d.any():
            break
        # resample every position of ops that contain any duplicate
        bad_ops = d.any(axis=-1)
        n_bad = int(bad_ops.sum())
        ranks[bad_ops] = rng.choice(cfg.n_words, size=(n_bad, cfg.k), p=p)
    ids = perm[ranks]
    ids = np.sort(ids, axis=-1)  # canonical embedding order
    return ids.astype(np.int32)


def generate_schedule(cfg: SimConfig) -> np.ndarray:
    """A uniformly random but deterministic thread interleaving."""
    rng = np.random.default_rng(cfg.seed + 0x5EED)
    return rng.integers(0, cfg.n_threads, size=cfg.n_steps, dtype=np.int32)


# ---------------------------------------------------------------------------
# State: field names, shapes and the numpy <-> torch carry-across
# ---------------------------------------------------------------------------

# fields that hold uint32 words (int32 bit patterns in tensors)
U32_FIELDS = frozenset(("cache", "pmem", "d_exp", "d_des", "d_exp_p",
                        "d_des_p", "exp", "ops_des"))
BOOL_FIELDS = frozenset(("success", "help_ok"))
# every field, in the order the simulator kernel takes their pointers
FIELDS = ("cache", "pmem", "line_owner",
          "d_state", "d_state_p", "d_state_dirty",
          "d_addr", "d_exp", "d_des", "d_addr_p", "d_exp_p", "d_des_p",
          "d_ver", "d_ver_p",
          "pc", "op_idx", "tgt_idx", "success", "backoff", "backoff_exp",
          "exp", "help_desc", "help_tgt", "help_ok", "ret_pc",
          "ref_cache", "ref_pmem", "counters", "ops", "ops_des")


def field_shapes(cfg: SimConfig) -> Dict[str, tuple]:
    """The shape of every state field under ``cfg``."""
    T, k = cfg.n_threads, cfg.k
    shapes = {f: (T,) for f in FIELDS}
    shapes.update(cache=(cfg.n_words,), pmem=(cfg.n_words,),
                  line_owner=(cfg.n_lines,), counters=(T, N_COUNTERS),
                  ops=(T, cfg.max_ops, k), ops_des=(T, cfg.max_ops, k))
    for f in ("d_addr", "d_exp", "d_des", "d_addr_p", "d_exp_p",
              "d_des_p", "exp"):
        shapes[f] = (T, k)
    return shapes


def field_dtype(name: str) -> torch.dtype:
    if name == "counters":
        return torch.int64
    if name in BOOL_FIELDS:
        return torch.bool
    return torch.int32


def init_state(cfg: SimConfig, ops: Optional[np.ndarray] = None,
               ops_des: Optional[np.ndarray] = None, *,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, torch.Tensor]:
    """Build the initial simulator state: a dict of tensors on ``device``
    with the reference's field names.

    ``ops_des`` optionally supplies explicit desired payload values per
    target (``[n_threads, max_ops, k]`` uint32, same shape as ``ops``);
    entries equal to :data:`DES_INCREMENT` (the default everywhere) fall
    back to the benchmark's ``expected + 1``.  This is how structure
    rounds — whose desired values are real keys/values, not increments —
    run natively on the cycle-accurate machines."""
    cfg.validate()
    dev = torch.device(device)
    T, k = cfg.n_threads, cfg.k
    if ops is None:
        ops = generate_ops(cfg)
    ops = np.asarray(ops)
    if ops_des is None:
        ops_des = np.full(ops.shape, DES_INCREMENT, np.uint32)
    ops_des = np.asarray(ops_des, np.uint32)
    if ops_des.shape != ops.shape:
        raise ValueError(f"ops_des shape {ops_des.shape} != ops shape "
                         f"{ops.shape}")
    if ops.shape != (T, cfg.max_ops, k):
        raise ValueError(f"ops shape {ops.shape} != "
                         f"{(T, cfg.max_ops, k)} (threads, max_ops, k)")
    start = start_pc(cfg.algorithm)

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return {
        # memory ------------------------------------------------------------
        "cache": full((cfg.n_words,), 0),
        "pmem": full((cfg.n_words,), 0),
        "line_owner": full((cfg.n_lines,), -1),
        # descriptor table (cache + pmem copies) -----------------------------
        "d_state": full((T,), ST_COMPLETED),
        "d_state_p": full((T,), ST_COMPLETED),
        "d_state_dirty": full((T,), 0),      # original's status dirty bit
        "d_addr": full((T, k), -1),
        "d_exp": full((T, k), 0),            # tagged expected words
        "d_des": full((T, k), 0),            # tagged desired words
        "d_addr_p": full((T, k), -1),
        "d_exp_p": full((T, k), 0),
        "d_des_p": full((T, k), 0),
        # descriptor generation counters.  The descriptor *pointer* stored
        # in a word is ver*T + tid, so helpers can detect a recycled
        # descriptor (the ABA hazard Wang et al. solve with epoch-based GC;
        # the paper's own algorithms never dereference foreign descriptors,
        # so they need no GC -- one of its contributions).
        "d_ver": full((T,), 0),
        "d_ver_p": full((T,), 0),
        # per-thread registers ------------------------------------------------
        "pc": full((T,), start),
        "op_idx": full((T,), 0),
        "tgt_idx": full((T,), 0),
        "success": full((T,), True, torch.bool),
        "backoff": full((T,), 0),
        "backoff_exp": full((T,), cfg.backoff_init),
        "exp": full((T, k), 0),              # untagged payload values
        "help_desc": full((T,), -1),
        "help_tgt": full((T,), 0),
        "help_ok": full((T,), True, torch.bool),
        "ret_pc": full((T,), start),
        # outstanding descriptor references per owner thread (cache / pmem);
        # see engine.Machine.ref_update for why these exist
        "ref_cache": full((T,), 0),
        "ref_pmem": full((T,), 0),
        # instrumentation -----------------------------------------------------
        "counters": full((T, N_COUNTERS), 0, torch.int64),
        # static data ---------------------------------------------------------
        "ops": torch.as_tensor(np.ascontiguousarray(ops, np.int32),
                               device=dev),
        "ops_des": torch.as_tensor(
            np.ascontiguousarray(ops_des).view(np.int32), device=dev),
    }


def state_from_arrays(cfg: SimConfig, arrays: Mapping[str, Any], *,
                      device: Union[str, torch.device] = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Carry a state given as numpy arrays in the reference's dtypes (a
    ``SimResult.state`` of either package) into tensors on ``device``:
    uint32 words become int32 bit patterns, the counters int64.  The
    shapes are checked against ``cfg``."""
    dev = torch.device(device)
    shapes = field_shapes(cfg)
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if a.shape != shapes[name]:
            raise ValueError(f"field {name!r} has shape {a.shape}, "
                             f"expected {shapes[name]} under this config")
        if name in U32_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        elif name == "counters":
            a = a.astype(np.int64)
        elif name in BOOL_FIELDS:
            a = a.astype(bool)
        else:
            a = a.astype(np.int32)
        out[name] = torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return out


def state_to_arrays(st: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A host copy of a state as numpy arrays in the reference's dtypes
    (uint32 words, bool flags, int32 registers), with the counters as
    int64 (the reference's are int32 with x64 off)."""
    out = {}
    for name in FIELDS:
        a = st[name].detach().cpu().numpy().copy()
        if name in U32_FIELDS:
            a = a.view(np.uint32)
        out[name] = a
    return out
