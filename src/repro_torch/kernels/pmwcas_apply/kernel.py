"""Hopper kernel: batched deterministic MwCAS verdict + in-place apply.

Replaces ``pmwcas_success_pallas`` (``src/repro/kernels/pmwcas_apply/
kernel.py:62``) and the XLA gather/scatter around it (``ops.py:24-34``).
The CUDA C++ source is ``src/repro_torch/csrc/pmwcas_apply.cu``; its
header comment has the design.  In short: one CTA per shard, a claim
table of ``atomicMin`` row indices turns the TPU kernel's O((BK)^2)
pairwise address compare into O(BK), and the gather, the verdict and
the winners' scatter are one launch for all ``S`` shards.

What bounds it on the card: launch latency, then ``B*K`` random 4-byte
gathers and atomics into word tables far larger than one round.  One
launch per wave covers every shard, and only the round's words are
touched.

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

import torch

from .. import _build

SOURCE = _build.CSRC / "pmwcas_apply.cu"
CLAIM_FREE = (1 << 31) - 1          # INT_MAX: an unclaimed word


def build() -> pathlib.Path:
    """Compile the kernel unless this source was built already; returns
    the library path (see :func:`repro_torch.kernels._build.build`)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    lib.pmwcas_apply_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_longlong,
                                        ptr]
    lib.pmwcas_apply_launch.restype = ctypes.c_int
    lib.pmwcas_error_string.argtypes = [ctypes.c_int]
    lib.pmwcas_error_string.restype = ctypes.c_char_p
    return lib


def check_batch(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
                des: torch.Tensor) -> None:
    """Raise on anything the kernel (and its plain version) does not take:
    int32 tensors on one device, ``words [S, W]``, ``addr/exp/des
    [S, B, K]``, contiguous, every valid address ``< W``."""
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
    if addr.numel() and int(addr.max()) >= W:
        # JAX's gather clamps an out-of-range address silently; the port
        # refuses the batch instead
        raise ValueError(f"address {int(addr.max())} out of range for a "
                         f"{W}-word table")


def launch(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
           des: torch.Tensor, claim: torch.Tensor,
           success: torch.Tensor) -> None:
    """Enqueue one launch on the current stream, WITHOUT the input checks
    and without counting it: for timing loops over inputs that
    :func:`pmwcas_apply_cuda` has already accepted.  Raises if the launch
    is refused."""
    S, B, K = addr.shape
    lib = _lib()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.pmwcas_apply_launch(
            words.data_ptr(), addr.data_ptr(), exp.data_ptr(),
            des.data_ptr(), claim.data_ptr(), success.data_ptr(),
            S, B, K, words.shape[1], stream)
    if err:
        raise RuntimeError("pmwcas_apply launch failed: "
                           + lib.pmwcas_error_string(err).decode())


def pmwcas_apply_cuda(words: torch.Tensor, addr: torch.Tensor,
                      exp: torch.Tensor, des: torch.Tensor,
                      claim: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: updates ``words [S, W]`` in place and returns
    ``success bool[S, B]``.  ``claim`` is an ``int32[S, W]`` scratch that
    holds ``CLAIM_FREE`` everywhere before and after the launch."""
    check_batch(words, addr, exp, des)
    if not words.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{words.device}")
    if claim.dtype != torch.int32 or claim.shape != words.shape \
            or claim.device != words.device or not claim.is_contiguous():
        raise ValueError("claim must be a contiguous int32 tensor shaped "
                         "and placed like words")
    success = torch.empty(addr.shape[:2], dtype=torch.bool,
                          device=words.device)
    launch(words, addr, exp, des, claim, success)
    pmwcas_apply_cuda.launches += 1
    return success


pmwcas_apply_cuda.launches = 0       # launches issued by this process
