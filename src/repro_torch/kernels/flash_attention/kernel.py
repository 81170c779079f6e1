"""Hopper kernel: forward flash attention over flattened heads.

Replaces ``flash_attention_flat`` (``src/repro/kernels/flash_attention/
kernel.py:73``).  The CUDA C++ source is
``src/repro_torch/csrc/flash_attention.cu``; its header comment has the
design.  In short: one block of 256 threads per (kv head, 16- or 64-row
q tile) with the ``g`` q heads of a kv head packed into the tile's rows,
a loop over 64-key tiles staged in shared memory, scores and the online
softmax in f32 registers, and fully masked tiles skipped before their
K/V are read.

What bounds it on the card: the f32 products on the CUDA cores in a
prefill (the bound is the bf16 tensor-core rate), the K/V bytes in a
decode step.  Tensor cores, TMA and a split-K decode are left for later.

Build: at first use the source is compiled with ``nvcc`` for ``sm_90a``
by :mod:`repro_torch.kernels._build` and loaded with ``ctypes``.
Nothing is built at import time, so the CPU tests import this module.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build

SOURCE = _build.CSRC / "flash_attention.cu"
NEG_INF = -2.0 ** 20                 # the finite mask fill of the TPU kernel
POS_LIMIT = 2.0 ** 29                # keys at or beyond this position are invalid
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def build() -> pathlib.Path:
    """Compile the kernel unless this source was built already; returns
    the library path (see :func:`repro_torch.kernels._build.build`)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                           i32, i32, i32, i32, i32, i32,
                                           f32, i32, i32, f32, ptr]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, g: int) -> None:
    """Raise on anything the kernel (and its plain version) does not take:
    ``q [H, Sq, hd]``, ``k``/``v [HK, Sk, hd]`` of one dtype (float32 or
    bfloat16) on one device, ``H == HK * g``, ``hd`` a multiple of 8 in
    [8, 256], ``q_pos [Sq]``, ``k_pos [Sk]``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if k.shape[2] != hd:
        raise ValueError(f"k head_dim {k.shape[2]} != q head_dim {hd}")
    if g < 1 or H % g or H // g != HK:
        raise ValueError(f"{H} q heads do not map onto {HK} kv heads with "
                         f"g = {g} (need H == HK * g)")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"need Sq >= 1 and Sk >= 1, got {Sq}, {Sk}")
    if q_pos.shape != (Sq,) or k_pos.shape != (Sk,):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be [{Sq}] / [{Sk}]")


def _positions(pos: torch.Tensor, device) -> torch.Tensor:
    return pos.to(device=device, dtype=torch.float32).contiguous()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, out: torch.Tensor, *,
           g: int, scale: float, causal: bool, window: int,
           attn_cap: float) -> None:
    """Enqueue one launch on the current stream, WITHOUT the input checks
    and without counting it: for timing loops over inputs that
    :func:`flash_attention_cuda` has already accepted (float32
    positions).  Raises if the launch is refused."""
    HK, Sk, hd = k.shape
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), DTYPES[q.dtype], HK, g,
            q.shape[1], Sk, hd, float(scale), int(bool(causal)),
            int(window), float(attn_cap), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                         g: int, scale: float, causal: bool, window: int,
                         attn_cap: float) -> torch.Tensor:
    """Launch the kernel: ``q [H, Sq, hd]``, ``k``/``v [HK, Sk, hd]``
    (q head ``h`` reads kv head ``h // g``) -> ``out [H, Sq, hd]`` in q's
    dtype.  The tensors must be contiguous CUDA tensors, 16-byte aligned."""
    check_inputs(q, k, v, q_pos, k_pos, g)
    if not q.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    qp, kp = _positions(q_pos, q.device), _positions(k_pos, q.device)
    out = torch.empty_like(q)
    launch(q, k, v, qp, kp, out, g=g, scale=scale, causal=causal,
           window=window, attn_cap=attn_cap)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0    # launches issued by this process
