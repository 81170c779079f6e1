"""Hopper kernel: batched deterministic MwCAS verdict + in-place apply.

Replaces ``pmwcas_success_pallas`` (``src/repro/kernels/pmwcas_apply/
kernel.py:62``) and the XLA gather/scatter around it (``ops.py:24-34``).
The CUDA C++ source is ``src/repro_torch/csrc/pmwcas_apply.cu``; its
header comment has the design.  In short: one launch for all ``S``
shards, one CTA per shard, and condition (b) as a claim per address
(``atomicMin`` of the row index) instead of the TPU kernel's O((BK)^2)
pairwise compare.  :func:`plan` picks one of two routes from ``[B, K]``:

- ``smem``: at most 16 slots a row and :func:`smem_rows` rows (the
  service's waves, ``[4, 1024, 2]``, and serve's page grants, ``[1, 128,
  9]``): one thread per row, and the claims in shared memory.  A plain
  store pass over a tag table finds the slots whose bucket another
  passing slot shares; only those take a shared-memory hash of at least
  ``2 * B * K`` entries (``atomicCAS`` insert, ``atomicMin`` claim).
  Three dependent trips to device memory (load the slots, gather the
  words, store verdicts and winners) and no scratch;
- ``global``: the first design of the kernel, for larger rounds, with
  the claims in a caller-owned ``int32[S, W]`` scratch that is all
  ``CLAIM_FREE`` before and after a launch.

What bounds it on the card: latency (a launch and dependent trips to
memory); the bytes take 0.05 µs at the service's shape.

Build: at first use the source is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/repro_torch/``
of the checkout (``repro_torch.kernels._build``, keyed by source and
flags), then loaded with ``ctypes``.  Nothing is built or imported at
module import time, so the CPU tests import this module freely.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional

import numpy as np
import torch

from .. import _build

SOURCE = _build.CSRC / "pmwcas_apply.cu"
ROUTES = ("smem", "global")
CLAIM_FREE = (1 << 31) - 1          # INT_MAX: an unclaimed word
HASH_MULT = 2654435761              # the smem route's multiplicative hash
SMEM_LIMIT = 232_448                # shared memory a block can use (227 KB)
SMEM_MAX_K = 16                     # the most slots a row on the smem route
TAG_BITS = 16                       # the smem route's 2^16 two-byte tags


def hash_bits(n_slots: int) -> int:
    """log2 of the smem route's hash capacity for ``n_slots`` slots: the
    smallest power of two at least ``2 * n_slots`` (load factor <= 1/2,
    should every slot need a claim)."""
    return max(1, (2 * n_slots - 1).bit_length())


def smem_rows(K: int) -> int:
    """The most rows the smem route takes at ``K`` slots a row: one
    thread per row, 1024 at K <= 4, fewer above (registers)."""
    kmax = 1 << max(0, (K - 1).bit_length())
    return 1024 if kmax <= 4 else 4096 // kmax


def table_bits(B: int, K: int) -> tuple:
    """``(tag_bits, cap_bits)`` of the smem route for a ``[B, K]`` round:
    the tag table's ``TAG_BITS`` and the hash's :func:`hash_bits`."""
    return TAG_BITS, hash_bits(B * K)


def smem_bytes(B: int, K: int) -> int:
    """Dynamic shared memory of the smem route for a ``[B, K]`` round: a
    key and a claim per hash entry (4 bytes each), then a 2-byte slot id
    per tag bucket."""
    tag, cap = table_bits(B, K)
    return 8 * (1 << cap) + 2 * (1 << tag)


def plan(B: int, K: int) -> tuple:
    """``(route, shared-memory bytes)`` for a ``[B, K]`` round: ``smem``
    at ``K <= SMEM_MAX_K`` and ``B <= smem_rows(K)`` (at most 4,096 slots:
    its tables take at most 192 KiB of the ``SMEM_LIMIT``), else
    ``global`` (no shared memory)."""
    if 1 <= K <= SMEM_MAX_K and B <= smem_rows(K):
        return "smem", smem_bytes(B, K)
    return "global", 0


def hash_bucket(addr, bits: int) -> np.ndarray:
    """The smem route's home bucket of each address (the kernel's
    ``(a * HASH_MULT mod 2^32) >> (32 - bits)``)."""
    a = np.asarray(addr).astype(np.uint64)
    return ((a * HASH_MULT) & 0xFFFFFFFF) >> (32 - bits)


def build() -> pathlib.Path:
    """Compile the kernel unless this source was built already; returns
    the library path (see :func:`repro_torch.kernels._build.build`)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pmwcas_apply_smem_launch.argtypes = [ptr] * 5 + [i32] * 3 + [
        i64, i32, i32, ptr]
    lib.pmwcas_apply_launch.argtypes = [ptr] * 6 + [i32] * 3 + [i64, ptr]
    lib.pmwcas_latency_probe_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.pmwcas_smem_bytes.argtypes = [i32, i32]
    lib.pmwcas_smem_bytes.restype = i64
    for fn in (lib.pmwcas_apply_smem_launch, lib.pmwcas_apply_launch,
               lib.pmwcas_latency_probe_launch):
        fn.restype = i32
    lib.pmwcas_error_string.argtypes = [i32]
    lib.pmwcas_error_string.restype = ctypes.c_char_p
    return lib


def kernel_smem_bytes(B: int, K: int) -> int:
    """The compiled source's own count of :func:`smem_bytes` (the card
    tests hold the two equal)."""
    return int(_lib().pmwcas_smem_bytes(*table_bits(B, K)))


def check_addr_range(addr_max: int, W: int) -> None:
    """Raise unless the largest address of a batch lies in a ``W``-word
    table."""
    if addr_max >= W:
        # JAX's gather clamps an out-of-range address silently; the port
        # refuses the batch instead
        raise ValueError(f"address {addr_max} out of range for a "
                         f"{W}-word table")


def check_batch(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
                des: torch.Tensor, addr_max: Optional[int] = None) -> None:
    """Raise on anything the kernel (and its plain version) does not take:
    int32 tensors on one device, ``words [S, W]``, ``addr/exp/des
    [S, B, K]``, contiguous, every valid address ``< W``.  ``addr_max``
    is the batch's largest address where the caller knows it from the
    host; else it is read from ``addr`` (on the card, a wait for it)."""
    for name, t in (("words", words), ("addr", addr), ("exp", exp),
                    ("des", des)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 bit patterns), "
                            f"got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on "
                             f"{words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.dim() != 2 or addr.dim() != 3:
        raise ValueError(f"need words [S, W] and addr [S, B, K], got "
                         f"{tuple(words.shape)} and {tuple(addr.shape)}")
    if exp.shape != addr.shape or des.shape != addr.shape:
        raise ValueError(f"exp {tuple(exp.shape)} / des {tuple(des.shape)} "
                         f"!= addr {tuple(addr.shape)}")
    if addr.shape[0] != words.shape[0]:
        raise ValueError(f"{addr.shape[0]} shard rounds for "
                         f"{words.shape[0]} word tables")
    if addr.shape[2] < 1:
        raise ValueError("need K >= 1 slots per row")
    W = words.shape[1]
    if W >= CLAIM_FREE:
        raise ValueError(f"word table of {W} words exceeds int32 addressing")
    if addr.numel():
        check_addr_range(int(addr.max()) if addr_max is None else addr_max,
                         W)


def launch(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
           des: torch.Tensor, success: torch.Tensor, *,
           route: Optional[str] = None,
           claim: Optional[torch.Tensor] = None) -> str:
    """Enqueue one launch on the current stream along ``route`` (default:
    the one :func:`plan` picks), WITHOUT the input checks and without
    counting it: for timing loops over inputs that
    :func:`pmwcas_apply_cuda` has already accepted.  The ``global`` route
    needs ``claim``.  Returns the route; raises if the launch is refused."""
    S, B, K = addr.shape
    route = route or plan(B, K)[0]
    lib = _lib()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        if route == "smem":
            err = lib.pmwcas_apply_smem_launch(
                words.data_ptr(), addr.data_ptr(), exp.data_ptr(),
                des.data_ptr(), success.data_ptr(), S, B, K,
                words.shape[1], *table_bits(B, K), stream)
        elif route == "global":
            err = lib.pmwcas_apply_launch(
                words.data_ptr(), addr.data_ptr(), exp.data_ptr(),
                des.data_ptr(), claim.data_ptr(), success.data_ptr(),
                S, B, K, words.shape[1], stream)
        else:
            raise ValueError(f"unknown route {route!r}; routes: {ROUTES}")
    if err:
        raise RuntimeError(f"pmwcas_apply {route} launch failed: "
                           + lib.pmwcas_error_string(err).decode())
    return route


def latency_probe(chain: torch.Tensor, out: torch.Tensor, trips: int) -> None:
    """Enqueue the latency probe: one thread follows ``trips`` dependent
    4-byte loads through ``chain`` (int32 indices into itself) and stores
    where it ended in ``out[0]``.  Not counted: it is no part of the op."""
    lib = _lib()
    with torch.cuda.device(chain.device):
        stream = torch.cuda.current_stream(chain.device).cuda_stream
        err = lib.pmwcas_latency_probe_launch(chain.data_ptr(),
                                              out.data_ptr(), trips, stream)
    if err:
        raise RuntimeError("latency probe launch failed: "
                           + lib.pmwcas_error_string(err).decode())


def claim_scratch(words: torch.Tensor) -> torch.Tensor:
    """The global route's ``int32[S, W]`` claim table for ``words [S, W]``,
    all ``CLAIM_FREE``.  Callers that launch it repeatedly keep one."""
    return torch.full(words.shape, CLAIM_FREE, dtype=torch.int32,
                      device=words.device)


def pmwcas_apply_cuda(words: torch.Tensor, addr: torch.Tensor,
                      exp: torch.Tensor, des: torch.Tensor, *,
                      route: Optional[str] = None,
                      claim: Optional[torch.Tensor] = None,
                      addr_max: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel: updates ``words [S, W]`` in place and returns
    ``success bool[S, B]``.  ``route`` forces a route (the tests do);
    else :func:`plan` picks it.  The ``global`` route takes ``claim``
    (:func:`claim_scratch`; allocated here if omitted).  ``addr_max`` as
    in :func:`check_batch`.  Counts the launch in ``launches`` and its
    route in ``route_launches``."""
    check_batch(words, addr, exp, des, addr_max)
    if not words.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{words.device}")
    S, B, K = addr.shape
    route = route or plan(B, K)[0]
    if route == "smem" and plan(B, K)[0] != "smem":
        raise ValueError(f"the smem route takes at most {SMEM_MAX_K} "
                         f"slots a row and smem_rows(K) rows in shared "
                         f"memory; a [{B}, {K}] round does not fit")
    if route == "global":
        if claim is None:
            claim = claim_scratch(words)
        elif claim.dtype != torch.int32 or claim.shape != words.shape \
                or claim.device != words.device \
                or not claim.is_contiguous():
            raise ValueError("claim must be a contiguous int32 tensor "
                             "shaped and placed like words")
    success = torch.empty((S, B), dtype=torch.bool, device=words.device)
    launch(words, addr, exp, des, success, route=route, claim=claim)
    pmwcas_apply_cuda.launches += 1
    pmwcas_apply_cuda.route_launches[route] += 1
    return success


def reset_counts() -> None:
    """Set the launch count and every route's count to 0."""
    pmwcas_apply_cuda.launches = 0
    pmwcas_apply_cuda.route_launches = dict.fromkeys(ROUTES, 0)


pmwcas_apply_cuda.launches = 0       # launches issued by this process
pmwcas_apply_cuda.route_launches = dict.fromkeys(ROUTES, 0)   # by route
