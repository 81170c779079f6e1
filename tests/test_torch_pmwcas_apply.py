"""The port's batched MwCAS primitive against the JAX reference.

The plain PyTorch versions (what a CPU tensor runs) must be
bit-identical to ``repro``'s Pallas kernel (interpret mode) and its
pure-jnp oracle over the ``tests/test_kernels.py`` sweeps and corner
cases.  The hand-written CUDA kernel is held against the plain version
by the ``requires_cuda`` tests in ``tests/test_torch_cuda.py``, which
import no JAX so that they run on a machine with a card.
Inputs are made with numpy from fixed seeds and handed to both
packages.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.pmwcas as ref_pm
from repro.structures import TOMBSTONE as REF_TOMBSTONE
from repro_torch.pmwcas import (KernelBackend, MwCASOp, make_backend,
                                pmwcas_apply,
                                pmwcas_apply_ref, pmwcas_apply_stacked,
                                pmwcas_apply_stacked_ref, pmwcas_success_ref,
                                reserve_slots, sequential_oracle,
                                tensor_to_words, words_to_tensor)
from repro_torch.structures import TOMBSTONE, HashMap

REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(arr, device="cpu"):
    return words_to_tensor(np.asarray(arr), device)


def _random_case(rng, W, B, K, pad_frac=0.1, val_range=4):
    words = rng.integers(0, val_range, W).astype(np.uint32)
    addr = np.stack([rng.choice(W, K, replace=False) for _ in range(B)])
    addr = np.sort(addr, axis=1).astype(np.int32)
    addr[rng.random((B, K)) < pad_frac] = -1
    exp = rng.integers(0, val_range, (B, K)).astype(np.uint32)
    des = (exp + 1).astype(np.uint32)
    return words, addr, exp, des


def _port_apply(words, addr, exp, des):
    w = _t(words)
    _, succ = pmwcas_apply(w, _t(addr), _t(exp), _t(des))
    return tensor_to_words(w), succ.numpy()


def _ref_apply(words, addr, exp, des):
    new, succ = ref_pm.pmwcas_apply_ref(jnp.asarray(words), jnp.asarray(addr),
                                        jnp.asarray(exp), jnp.asarray(des))
    return np.asarray(new), np.asarray(succ)


# ---------------------------------------------------------------------------
# verdicts: plain version == Pallas kernel (interpret) == jnp oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,B,K,tb", [
    (32, 8, 1, 4), (64, 32, 3, 8), (128, 64, 4, 16), (64, 17, 2, 8),
    (16, 40, 4, 8), (256, 7, 8, 4),
])
def test_success_matches_pallas_and_oracle(W, B, K, tb):
    rng = np.random.default_rng(42 + W + B + K)
    words, addr, exp, _ = _random_case(rng, W, B, K)
    cur = words[np.maximum(addr, 0)]
    s_pallas = np.asarray(ref_pm.pmwcas_success_pallas(
        jnp.asarray(addr), jnp.asarray(cur), jnp.asarray(exp), tb=tb,
        interpret=True))
    s_oracle = np.asarray(ref_pm.pmwcas_success_ref(
        jnp.asarray(addr), jnp.asarray(cur), jnp.asarray(exp)))
    s_port = pmwcas_success_ref(_t(addr), _t(cur), _t(exp)).numpy()
    np.testing.assert_array_equal(s_port, s_pallas)
    np.testing.assert_array_equal(s_port, s_oracle)


def _check_apply_invariants(seed, B, K, W):
    """Bit-identical to the reference, plus the conservative-batch
    invariants against the sequential oracle: containment, winners'
    writes match, losers leave words untouched, no double write."""
    rng = np.random.default_rng(seed)
    K = min(K, W)
    words, addr, exp, des = _random_case(rng, W, B, K)
    new, succ = _port_apply(words, addr, exp, des)
    want_new, want_succ = _ref_apply(words, addr, exp, des)
    np.testing.assert_array_equal(succ, want_succ)
    np.testing.assert_array_equal(new, want_new)
    seq_new, s_seq = sequential_oracle(words, addr, exp, des)
    ref_seq_new, ref_s_seq = ref_pm.sequential_oracle(words, addr, exp, des)
    np.testing.assert_array_equal(s_seq, ref_s_seq)
    np.testing.assert_array_equal(seq_new, ref_seq_new)
    assert (~succ | s_seq).all()
    touched = {}
    for i in range(B):
        for k in range(K):
            a = addr[i, k]
            if a >= 0 and succ[i]:
                assert a not in touched, "double write"
                touched[a] = des[i, k]
    for a in range(W):
        assert new[a] == touched.get(a, words[a])


@pytest.mark.parametrize("seed,B,K,W", [
    (0, 1, 1, 16), (1, 40, 4, 16), (2, 17, 2, 64), (3, 32, 3, 256),
    (4, 8, 4, 16), (5, 25, 1, 64), (6, 64, 8, 64), (7, 33, 2, 8),
])
def test_apply_matches_reference_and_oracle(seed, B, K, W):
    _check_apply_invariants(seed, B, K, W)


def test_apply_full_uint32_range():
    """Words at and above 2**31 (TOMBSTONE included) compare and move as
    uint32 values even though the table holds int32 bit patterns."""
    big = np.asarray([0, 1, 2**31, 2**31 + 5, 2**32 - 1, 7], np.uint32)
    addr = np.asarray([[2, 4], [3, -1], [4, 5], [0, 1]], np.int32)
    exp = np.asarray([[2**31, 2**32 - 1], [2**31 + 5, 0], [2**32 - 1, 7],
                      [1, 1]], np.uint32)
    des = np.asarray([[2**32 - 1, 2**31], [9, 0], [1, 1], [2**32 - 2, 3]],
                     np.uint32)
    new, succ = _port_apply(big, addr, exp, des)
    want_new, want_succ = _ref_apply(big, addr, exp, des)
    np.testing.assert_array_equal(succ, want_succ)
    np.testing.assert_array_equal(new, want_new)
    assert new.dtype == np.uint32 and new[2] == 2**32 - 1


@pytest.mark.parametrize("S,B,K,W", [(1, 8, 2, 32), (3, 16, 4, 64),
                                     (4, 7, 1, 16)])
def test_apply_stacked_matches_reference(S, B, K, W):
    rng = np.random.default_rng(100 + S * B + K)
    cases = [_random_case(rng, W, B, K) for _ in range(S)]
    words, addr, exp, des = (np.stack(x) for x in zip(*cases))
    w = _t(words)
    _, succ = pmwcas_apply_stacked(w, _t(addr), _t(exp), _t(des))
    want_new, want_succ = ref_pm.pmwcas_apply_stacked(
        jnp.asarray(words), jnp.asarray(addr), jnp.asarray(exp),
        jnp.asarray(des), use_kernel=True, interpret=True)
    np.testing.assert_array_equal(succ.numpy(), np.asarray(want_succ))
    np.testing.assert_array_equal(tensor_to_words(w), np.asarray(want_new))


def test_apply_updates_in_place_and_plain_versions_agree():
    rng = np.random.default_rng(11)
    words, addr, exp, des = _random_case(rng, 32, 12, 3)
    w = _t(words)
    out, succ = pmwcas_apply(w, _t(addr), _t(exp), _t(des))
    assert out is w                       # the port updates in place
    w2 = _t(words)
    _, succ2 = pmwcas_apply_ref(w2, _t(addr), _t(exp), _t(des))
    w3 = _t(words)[None]
    _, succ3 = pmwcas_apply_stacked_ref(w3, _t(addr)[None], _t(exp)[None],
                                        _t(des)[None])
    assert torch.equal(succ, succ2) and torch.equal(succ, succ3[0])
    assert torch.equal(w, w2) and torch.equal(w, w3[0])


def test_duplicate_id_in_winning_row_keeps_last_slot():
    """A winning row naming one word twice writes the LAST slot's des
    (the kernel writes a row's slots in order)."""
    words = np.zeros(4, np.uint32)
    addr = np.asarray([[1, 1, 2]], np.int32)
    exp = np.zeros((1, 3), np.uint32)
    des = np.asarray([[5, 6, 7]], np.uint32)
    new, succ = _port_apply(words, addr, exp, des)
    assert succ.tolist() == [True]
    assert new.tolist() == [0, 6, 7, 0]


# ---------------------------------------------------------------------------
# reserve_slots corner cases (tests/test_kernels.py) against both
# reference paths
# ---------------------------------------------------------------------------

def _reserve_all(free, reqs):
    free = np.asarray(free, np.uint32)
    reqs = np.asarray(reqs, np.int32)
    mask = _t(free)
    _, granted = reserve_slots(mask, _t(reqs))
    got_mask, got = tensor_to_words(mask), granted.numpy()
    for use_kernel in (True, False):
        want_mask, want = ref_pm.reserve_slots(
            jnp.asarray(free), jnp.asarray(reqs), use_kernel=use_kernel)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    return got_mask, got


def test_reserve_slots_grants_disjoint():
    rng = np.random.default_rng(7)
    reqs = np.stack([np.sort(rng.choice(64, 4, replace=False))
                     for _ in range(16)])
    new, granted = _reserve_all(np.ones(64), reqs)
    claimed = [int(c) for i in range(16) if granted[i] for c in reqs[i]]
    assert len(claimed) == len(set(claimed))
    assert all(new[c] == 0 for c in claimed)
    rest = sorted(set(range(64)) - set(claimed))
    assert all(new[rest] == 1)


def test_reserve_slots_duplicate_ids_within_request():
    new, granted = _reserve_all(np.ones(8), [[3, 3, 5, -1]])
    assert granted[0]
    assert new[3] == 0 and new[5] == 0
    assert new[[0, 1, 2, 4, 6, 7]].sum() == 6


def test_reserve_slots_all_padded_request():
    new, granted = _reserve_all(np.ones(8), [[-1, -1, -1], [0, 1, -1]])
    assert granted[0] and granted[1]
    assert new[0] == 0 and new[1] == 0
    assert new[2:].sum() == 6


def test_reserve_slots_contention_lower_index_wins():
    reqs = [[0, 1, 2, 3], [3, 4, 5, 6], [7, 8, 9, 10], [4, 5, 11, 12]]
    new, granted = _reserve_all(np.ones(16), reqs)
    assert granted.tolist() == [True, False, True, False]
    assert all(new[s] == 0 for s in [0, 1, 2, 3, 7, 8, 9, 10])
    assert all(new[s] == 1 for s in [4, 5, 6, 11, 12, 13, 14, 15])


def test_reserve_slots_already_claimed_slot_fails():
    free = np.ones(8)
    free[2] = 0
    new, granted = _reserve_all(free, [[1, 2, -1]])
    assert not granted[0]
    assert new[1] == 1


# ---------------------------------------------------------------------------
# input checks, devices, word dtype
# ---------------------------------------------------------------------------

def test_out_of_range_address_raises():
    """JAX's gather clamps an out-of-range address silently; the port
    refuses the batch and leaves the table untouched."""
    w = _t(np.zeros(8, np.uint32))
    addr = _t(np.asarray([[1, 8]], np.int32))
    zeros = _t(np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="out of range"):
        pmwcas_apply(w, addr, zeros, zeros + 1)
    assert not w.any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows"])
def test_malformed_batch_raises(bad):
    w = torch.zeros(1, 8, dtype=torch.int32)
    addr = torch.zeros(1, 2, 2, dtype=torch.int32)
    exp = torch.zeros_like(addr)
    if bad == "dtype":
        exp = exp.to(torch.int64)
        err = TypeError
    elif bad == "shape":
        exp = torch.zeros(1, 2, 3, dtype=torch.int32)
        err = ValueError
    else:
        addr = torch.zeros(2, 2, 2, dtype=torch.int32)
        exp = torch.zeros_like(addr)
        err = ValueError
    with pytest.raises(err):
        pmwcas_apply_stacked(w, addr, exp, torch.zeros_like(addr))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the raise cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        KernelBackend(n_words=8)          # device defaults to "cuda"


def test_unported_backend_kinds_raise():
    # every backend kind of the reference is ported: the simulator's
    # backend runs its plain version on the CPU
    assert make_backend("sim", n_words=8, device="cpu").name == "sim"
    # the durable backend is ported: host code, no device
    assert make_backend("durable", n_words=8).name == "durable"
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("nope", n_words=8)


def test_tombstone_round_trips_through_kernel_backend():
    assert TOMBSTONE == REF_TOMBSTONE == 4294967295
    b = KernelBackend(values=[0, TOMBSTONE, 5, 2**31], device="cpu")
    assert b.word_table().dtype == torch.int32
    assert b.read(1) == TOMBSTONE and b.read(3) == 2**31
    vals = b.values()
    assert vals.dtype == np.uint32 and vals.tolist() == [0, TOMBSTONE, 5,
                                                         2**31]
    (res,) = b.execute([MwCASOp([(1, TOMBSTONE, 9), (2, 5, TOMBSTONE)])])
    assert res.success
    assert b.values().tolist() == [0, 9, TOMBSTONE, 2**31]
    vals[0] = 3                           # values() is a copy
    assert b.read(0) == 0
    # the hash map's snapshot sees TOMBSTONE as uint32, not -1
    m = HashMap(b, 2)
    assert int(m.snapshot()[2]) == TOMBSTONE


# ---------------------------------------------------------------------------
# isolation: the port never imports jax or the reference
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert files, "src/repro_torch has no python files"
    return files + [REPO / "chip_smoke.py",
                    REPO / "scripts" / "mesh_cell.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(n, node.lineno) for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
