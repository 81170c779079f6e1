"""Hopper kernels: forward flash attention over flattened heads.

Replace ``flash_attention_flat`` (``src/repro/kernels/flash_attention/
kernel.py:73``).  Three CUDA C++ sources under ``src/repro_torch/csrc/``,
one route each; :func:`plan` picks the route from the call's shape and
dtype, and each source's header comment has its design:

- ``decode`` (``flash_attention_decode.cu``): at most 16 q rows per kv
  head (a decode step), f32 or bf16, any head_dim.  Split-K: one CTA per
  (kv head, key split) streams its keys through a cp.async ring, a second
  launch combines the splits (none when there is one split).  Bound by
  the K/V bytes.
- ``tc`` (``flash_attention_tc.cu``): bf16 with head_dim 64, 128 or 256.
  wgmma on the tensor cores fed by TMA, a producer warpgroup and two
  consumer warpgroups per 128 packed q rows.  Bound by the bf16 FLOPs.
- ``simt`` (``flash_attention.cu``): everything else (f32 prefill, other
  head dims): 64-key tiles in shared memory, products on the CUDA cores.

The ``tc`` and ``simt`` routes also write each row's f32 log-sum-exp when
asked (``lse=True``): the training forward, whose recompute backward
reads it.  The ``decode`` route does not, so a call that asks for it is
planned onto ``tc`` or ``simt`` whatever its row count.

Build: at first use a route's source is compiled with ``nvcc`` for
``sm_90a`` by :mod:`repro_torch.kernels._build` and loaded with
``ctypes``.  Nothing is built at import time, so the CPU tests import
this module.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build

SOURCES = {"tc": _build.CSRC / "flash_attention_tc.cu",
           "decode": _build.CSRC / "flash_attention_decode.cu",
           "simt": _build.CSRC / "flash_attention.cu"}
ROUTES = tuple(SOURCES)
NEG_INF = -2.0 ** 20                 # the finite mask fill of the TPU kernel
POS_LIMIT = 2.0 ** 29                # keys at or beyond this position are invalid
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
DECODE_ROWS = 16                     # q rows per kv head on the decode route
TC_HEAD_DIMS = (64, 128, 256)
SPLIT_QUANTUM = 64                   # a decode split is a whole number of these keys
MAX_SPLIT_KEYS = 65536               # the split kernel keeps per-tile flags in smem


def decode_splits(Sk: int, HK: int, n_sms: int) -> int:
    """The decode route's split count: one CTA per SM at most (``HK *
    splits <= n_sms``), at least 128 keys a split, at least one split,
    and no split longer than ``MAX_SPLIT_KEYS``.  At the serve cell (HK =
    104, Sk = 2080, 132 SMs) that is 1: the split kernel then writes the
    output itself and the combine launch is skipped, which measured
    fastest on the H100 (``PERF.md`` §6); more CTAs than SMs only add
    combine work and a partial last wave."""
    return max(1, min(Sk // 128, n_sms // HK), -(-Sk // MAX_SPLIT_KEYS))


def split_chunk(Sk: int, splits: int) -> tuple:
    """``(chunk, splits)``: the keys of each split, a multiple of
    ``SPLIT_QUANTUM``, and the number of splits that covers ``Sk`` with
    it (at most the ``splits`` asked for; the pair is a fixed point)."""
    quanta = -(-Sk // SPLIT_QUANTUM)
    per = -(-quanta // max(1, min(splits, quanta)))
    return per * SPLIT_QUANTUM, -(-quanta // per)


def plan(dtype: torch.dtype, hd: int, rows_per_kv_head: int, Sk: int,
         HK: int, n_sms: int, splits: int | None = None,
         lse: bool = False) -> tuple:
    """``(route, splits)`` for one call: ``decode`` when a kv head has at
    most 16 q rows (``g * Sq``), any dtype and head_dim, and the call
    does not ask for the log-sum-exp (``lse``); else ``tc`` for bf16 at
    head_dim 64, 128 or 256; else ``simt`` (every f32 prefill: wgmma has
    no f32 product, and TF32 would break the f32 tolerance).  ``splits``
    forces the decode route's split count (the tests do); the count
    returned is the one that launches."""
    if rows_per_kv_head <= DECODE_ROWS and not lse:
        want = decode_splits(Sk, HK, n_sms) if splits is None else splits
        return "decode", split_chunk(Sk, want)[1]
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tc", 1
    return "simt", 1


def build(route: str = "simt") -> pathlib.Path:
    """Compile one route's source unless it was built already; returns
    the library path (see :func:`repro_torch.kernels._build.build`)."""
    return _build.build(SOURCES[route])


@functools.lru_cache(maxsize=None)
def _lib(route: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(route)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    name = {"simt": "flash_attention", "tc": "flash_attention_tc",
            "decode": "flash_attention_decode"}[route]
    fn = getattr(lib, name + "_launch")
    if route == "simt":       # q k v qp kp out lse dtype HK G Sq Sk hd ...
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [f32, i32, i32, f32, ptr]
    elif route == "tc":       # q k v qp kp out lse HK G Sq Sk hd ...
        fn.argtypes = [ptr] * 7 + [i32] * 5 + [f32, i32, i32, f32, ptr]
    else:                     # q k v qp kp out ws dtype HK G Sq Sk hd ...
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [f32, i32, i32, f32, i32,
                                               i32, ptr]
    fn.restype = ctypes.c_int
    err = getattr(lib, name + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.launch, lib.error_string = fn, err
    return lib


@functools.lru_cache(maxsize=None)
def n_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def workspace_floats(HK: int, splits: int, rows: int, hd: int) -> int:
    """f32 words of the decode route's workspace: ``m``, ``l`` and
    ``acc[hd]`` for every (kv head, split, row)."""
    return HK * splits * rows * (hd + 2)


def needs_workspace(dtype: torch.dtype, hd: int, splits: int) -> bool:
    """Whether a decode call needs the f32 workspace: every call but one
    split of the mma kernel (bf16 at head_dim 64, 128 or 256), whose CTA
    writes the output itself."""
    return splits > 1 or not (dtype == torch.bfloat16
                              and hd in TC_HEAD_DIMS)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, out: torch.Tensor, *,
           g: int, scale: float, causal: bool, window: int,
           attn_cap: float, splits: int | None = None,
           workspace: torch.Tensor | None = None,
           lse: torch.Tensor | None = None) -> tuple:
    """Enqueue one call on the current stream along the route that
    :func:`plan` picks, WITHOUT the input checks and without counting it:
    for timing loops over inputs that :func:`flash_attention_cuda` has
    already accepted (float32 positions).  Where the decode route needs a
    workspace (:func:`needs_workspace`) it allocates one unless one of at
    least :func:`workspace_floats` f32 words is given.  ``lse`` (f32
    ``[H, Sq]``) receives the rows' log-sum-exp; without it the kernel
    gets a null pointer and writes none.  Returns ``(route, splits)``;
    raises if a launch is refused."""
    HK, Sk, hd = k.shape
    Sq = q.shape[1]
    route, n = plan(q.dtype, hd, g * Sq, Sk, HK, n_sms(q.device.index or 0),
                    splits, lse=lse is not None)
    lib = _lib(route)
    common = (float(scale), int(bool(causal)), int(window), float(attn_cap))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr())
    lse_ptr = None if lse is None else lse.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "simt":
            err = lib.launch(*ptrs, lse_ptr, DTYPES[q.dtype], HK, g, Sq, Sk,
                             hd, *common, stream)
        elif route == "tc":
            err = lib.launch(*ptrs, lse_ptr, HK, g, Sq, Sk, hd, *common,
                             stream)
        else:
            need = workspace_floats(HK, n, g * Sq, hd)
            if not needs_workspace(q.dtype, hd, n):
                workspace = None
            elif workspace is None:
                workspace = torch.empty(need, dtype=torch.float32,
                                        device=q.device)
            elif workspace.numel() < need or \
                    workspace.dtype != torch.float32:
                raise ValueError(f"decode workspace needs {need} f32 words")
            ws = None if workspace is None else workspace.data_ptr()
            err = lib.launch(*ptrs, ws, DTYPES[q.dtype], HK, g, Sq, Sk, hd,
                             *common, n, split_chunk(Sk, n)[0], stream)
    if err:
        raise RuntimeError(f"flash_attention {route} launch failed: "
                           + lib.error_string(err).decode())
    return route, n


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                         g: int, scale: float, causal: bool, window: int,
                         attn_cap: float, splits: int | None = None,
                         lse: bool = False):
    """Launch the route :func:`plan` picks: ``q [H, Sq, hd]``, ``k``/``v
    [HK, Sk, hd]`` (q head ``h`` reads kv head ``h // g``) -> ``out [H,
    Sq, hd]`` in q's dtype, or with ``lse=True`` ``(out, lse)``, ``lse``
    the rows' f32 log-sum-exp ``[H, Sq]`` (never on the decode route).
    The tensors must be contiguous CUDA tensors, 16-byte aligned.
    ``splits`` forces the decode route's split count.  Counts the call in
    ``launches`` and its route in ``route_launches``."""
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
    lse_out = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
               if lse else None)
    route, _ = launch(q, k, v, qp, kp, out, g=g, scale=scale, causal=causal,
                      window=window, attn_cap=attn_cap, splits=splits,
                      lse=lse_out)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[route] += 1
    return (out, lse_out) if lse else out


def reset_counts() -> None:
    """Set the call count and every route's count to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.route_launches = dict.fromkeys(ROUTES, 0)


flash_attention_cuda.launches = 0    # calls launched by this process
flash_attention_cuda.route_launches = dict.fromkeys(ROUTES, 0)   # by route
