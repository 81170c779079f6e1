"""The bf16 checks that ``chip_smoke.py`` holds the flash kernels to, put
to faults planted on the CPU.

On the card, a bf16 flash output is held against the plain version by
``chip_smoke.fa_close`` (2e-2 element-wise and ``FA_ROW_TOL`` per row),
and the bf16 small serve against the CPU's by ``serve_logits_agree`` at
``SERVE_BF16_TOL`` (absolute).  Here the plain version stands in for a
kernel: with p rounded to bf16, as the tensor-core kernels round it, it
must pass; with a fault a kernel could make planted in its inputs (a key
tile skipped, a stale ring slot, the last row's own tile skipped; in the
serve, the newest key dropped, causal off by one, one key masked, a stale
V tile) it must fail.  Run as a script, it prints the readings::

    PYTHONPATH=src python tests/test_torch_flash_faults.py
"""
import math
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CPU = torch.device("cpu")
BF16 = torch.bfloat16
# cases on a bf16 kernel's route whose keys span more tiles than its ring
# holds, with no window (so the middle tile is visible) and a row that
# sees keys
LONG_CASES = [c for c in chip_smoke.FA_CHECK_CASES if c.route != "simt"
              and not c.empty and c.window == 0
              and c.Sk > math.prod(chip_smoke.route_tile(c.route, c.hd))]


def rounded_p(q, k, v, q_pos, k_pos, *, g, scale, causal, window, attn_cap):
    """The plain version with p rounded to bf16 before P.V (the sum l of
    the unrounded p), as the tensor-core kernels do."""
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    s = torch.einsum("kgqd,kcd->kgqc", q.reshape(HK, g, Sq, hd).float(),
                     k.float()) * scale
    if attn_cap > 0.0:
        s = torch.tanh(s / attn_cap) * attn_cap
    s = s.masked_fill(~fa_ref._visible(q_pos, k_pos, causal, window, CPU),
                      fa_ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("kgqc,kcd->kgqd", p.to(BF16).float(), v.float())
    return (out / p.sum(-1, keepdim=True)).to(q.dtype).reshape(H, Sq, hd)


@pytest.mark.parametrize("case", chip_smoke.FA_CHECK_CASES,
                         ids=[c.name for c in chip_smoke.FA_CHECK_CASES])
def test_bf16_check_passes_p_rounded_to_bf16(case):
    args, kw = chip_smoke.fa_case_inputs(case, BF16, CPU, seed=7)
    want = fa_ref.flash_attention_flat(*args, **kw)
    ok, err = chip_smoke.fa_close(rounded_p(*args, **kw), want, BF16)
    assert ok, f"max abs err {err}"


def fault_errs(case):
    args, kw = chip_smoke.fa_case_inputs(case, BF16, CPU, seed=7)
    want = fa_ref.flash_attention_flat(*args, **kw)
    return chip_smoke.fa_fault_errs(fa_ref, args, kw, want,
                                    *chip_smoke.route_tile(case.route,
                                                           case.hd))


@pytest.mark.parametrize("case", LONG_CASES, ids=[c.name for c in LONG_CASES])
def test_bf16_row_check_catches_planted_faults(case):
    errs = fault_errs(case)
    assert min(errs.values()) > chip_smoke.FA_ROW_TOL, errs


def _masked(kp, keys):
    return torch.where(keys, torch.tensor(2.0 ** 30), kp.float())


def drop_newest(q, k, v, qp, kp, **kw):
    """A decode call skips the key at its own position."""
    if q.shape[0] // k.shape[0] * q.shape[1] <= 16:
        kp = _masked(kp, kp == qp.max())
    return PLAIN(q, k, v, qp, kp, **kw)


def causal_off_by_one(q, k, v, qp, kp, **kw):
    """A prefill row does not see its own key."""
    if q.shape[1] > 1:
        qp = qp.float() - 1
    return PLAIN(q, k, v, qp, kp, **kw)


def one_key_masked(q, k, v, qp, kp, **kw):
    """The key at position 3 is skipped by every call."""
    return PLAIN(q, k, v, qp, _masked(kp, kp == 3), **kw)


def stale_v(q, k, v, qp, kp, **kw):
    """Keys 8..15 are served with the values of keys 0..7."""
    v = v.clone()
    v[:, 8:16] = v[:, 0:8]
    return PLAIN(q, k, v, qp, kp, **kw)


PLAIN = fa_ref.flash_attention_flat
SERVE_FAULTS = [drop_newest, causal_off_by_one, one_key_masked, stale_v]


def bf16_serves(fault):
    """The bf16 small serve of ``chip_smoke.small_serve_bf16`` on the CPU,
    sound and with ``fault`` in place of the plain flash op."""
    cfg = chip_smoke.small_serve_config(get_config, "bfloat16",
                                        chip_smoke.SERVE_BF16_HEAD_DIM)
    model = build_model(cfg, device="cpu", seed=0)
    kw = chip_smoke.small_serve_kwargs(0)
    sound = serve_mod.serve(cfg, device="cpu", model=model, **kw)
    fa_ref.flash_attention_flat = fault
    try:
        faulty = serve_mod.serve(cfg, device="cpu", model=model, **kw)
    finally:
        fa_ref.flash_attention_flat = PLAIN
    return faulty, sound


@pytest.mark.parametrize("fault", SERVE_FAULTS,
                         ids=[f.__name__ for f in SERVE_FAULTS])
def test_bf16_serve_check_catches_planted_faults(fault):
    faulty, sound = bf16_serves(fault)
    assert faulty.logits_finite
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.serve_logits_agree(faulty, sound,
                                      chip_smoke.SERVE_BF16_TOL, 0.0)


def first_parting(faulty, sound) -> float:
    """Max abs logit difference at the first step where the runs differ."""
    for a, b in zip(faulty.logits, sound.logits):
        d = float((a.float() - b.float()).abs().max())
        if d > 0:
            return d
    return 0.0


if __name__ == "__main__":
    for case in chip_smoke.FA_CHECK_CASES:
        args, kw = chip_smoke.fa_case_inputs(case, BF16, CPU, seed=7)
        want = fa_ref.flash_attention_flat(*args, **kw)
        got = rounded_p(*args, **kw)
        line = (f"{case.name}: p rounded to bf16: row err "
                f"{chip_smoke.fa_row_err(got, want):.3e}, max abs err "
                f"{chip_smoke.fa_close(got, want, BF16)[1]:.3e}")
        if case in LONG_CASES:
            line += "; planted faults, row err " + str(
                {n: round(e, 4) for n, e in fault_errs(case).items()})
        print(line)
    for fault in SERVE_FAULTS:
        print(f"bf16 small serve, {fault.__name__}: max abs logit "
              f"difference where the runs first differ "
              f"{first_parting(*bf16_serves(fault)):.4f} (limit "
              f"{chip_smoke.SERVE_BF16_TOL})")
