"""The PMwCAS kernel's route plan and its shared-memory claims, on the
CPU.

``kernel.plan(B, K)`` decides from the round's shape alone which route a
launch takes (``smem`` or ``global``) and how much shared memory the
``smem`` route asks for; these tests need no card.  ``_hash_claim`` below
mirrors the ``smem`` route's algorithm in plain numpy: the slots of
(a)-passing rows store their ids into a tag table (the last store stays),
a slot that reads another's id marks its bucket contested, and only the
slots of contested buckets insert their address into an open-addressing
hash (linear probing) and claim it with their row by minimum; slots and
rows are visited in any order, winners write in slot order.  It must give
bit-identical verdicts and tables to the port's plain version and to the
JAX reference (its jnp oracle and its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) over the existing sweeps, under
adversarial collisions (every address in one tag bucket and one home
bucket), in a full hash, with duplicate ids and all-padded rows.  Inputs
are made with numpy from fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.pmwcas as ref_pm
from repro_torch.kernels.pmwcas_apply import kernel, ref
from repro_torch.pmwcas import tensor_to_words, words_to_tensor


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _bytes(tag, cap):
    return 8 * (1 << cap) + 2 * (1 << tag)


@pytest.mark.parametrize("B,K,route,cap", [
    (1024, 2, "smem", 12),                     # a ycsb wave's shard
    (128, 9, "smem", 12),                      # serve's page grants
    (1, 1, "smem", 1),
    (7, 2, "smem", 5),
    (1024, 4, "smem", 13),                     # 4,096 slots, the most
    (512, 8, "smem", 13),
    (256, 16, "smem", 13),
    (1025, 2, "global", None),                 # one row more than 1024
    (513, 8, "global", None),
    (257, 9, "global", None),
    (4, 17, "global", None),                   # 17 slots a row
    (3000, 2, "global", None),
])
def test_plan_route_and_shared_memory(B, K, route, cap):
    want = _bytes(16, cap) if route == "smem" else 0
    assert kernel.plan(B, K) == (route, want)
    if route == "smem":
        assert kernel.table_bits(B, K) == (16, cap)
        assert kernel.smem_bytes(B, K) == want <= kernel.SMEM_LIMIT


def test_plan_rows_slots_and_load_factors():
    """The smem route takes every K <= 16 up to its row limit, its tables
    always fit, the hash stays at a load factor of at most 1/2, and every
    slot id fits a two-byte tag."""
    for K in range(1, kernel.SMEM_MAX_K + 2):
        rows = kernel.smem_rows(K)
        if K <= kernel.SMEM_MAX_K:
            assert rows == (1024 if K <= 4 else 512 if K <= 8 else 256)
        for B in sorted({1, 2, 31, 127, 255, 256, 257, 511, 512, 513, 1023,
                         1024, 1025, 3000}):
            route, nbytes = kernel.plan(B, K)
            fits = K <= kernel.SMEM_MAX_K and B <= rows
            assert route == ("smem" if fits else "global")
            if not fits:
                continue
            tag, cap = kernel.table_bits(B, K)
            assert 2 * B * K <= (1 << cap) < max(4, 4 * B * K)
            assert tag == kernel.TAG_BITS and B * K < (1 << tag) - 1
            assert 0 < nbytes == _bytes(tag, cap) <= kernel.SMEM_LIMIT


def test_hash_bucket_is_the_kernels_formula():
    addr = np.asarray([0, 1, 2, 3, 1023, 2047, 1 << 20, (1 << 31) - 1])
    for bits in (1, 5, 12, 14):
        want = [((int(a) * kernel.HASH_MULT) % 2**32) >> (32 - bits)
                for a in addr]
        got = kernel.hash_bucket(addr, bits)
        assert got.tolist() == want
        assert (got < (1 << bits)).all()


# ---------------------------------------------------------------------------
# the smem route's algorithm, mirrored in numpy
# ---------------------------------------------------------------------------

INT_MAX = (1 << 31) - 1


def _hash_claim(words, addr, exp, des, *, tag_bits=None, cap_bits=None,
                tag_home=None, home=None, rng=None):
    """The smem route on one shard: ``words`` uint32[W] (a new table is
    returned), ``addr`` int32[B, K] (<0 pad), ``exp``/``des`` uint32
    [B, K].  ``tag_bits``/``cap_bits`` size the tag table and the hash
    (default: the plan's), ``tag_home``/``home`` map an address to its
    tag bucket and its first hash bucket (default: the kernel's hash),
    ``rng`` permutes the order in which slots store their tags, insert
    and claim (the card's threads run in no order).  Returns ``(words,
    success, keys, pos)``: ``pos`` is each slot's hash entry, -1 for a
    slot that took no claim."""
    B, K = addr.shape
    d_tag, d_cap = kernel.table_bits(B, K)
    tag_bits = d_tag if tag_bits is None else tag_bits
    cap_bits = d_cap if cap_bits is None else cap_bits
    cap = 1 << cap_bits
    tag_home = tag_home or (lambda a: int(kernel.hash_bucket(a, tag_bits)))
    home = home or (lambda a: int(kernel.hash_bucket(a, cap_bits)))
    flat_a = addr.reshape(-1)
    cur = np.where(flat_a >= 0, words[np.maximum(flat_a, 0)],
                   exp.reshape(-1))
    passing = (cur == exp.reshape(-1)).reshape(B, K).all(1)
    slots = [j for j in range(B * K) if flat_a[j] >= 0 and passing[j // K]]
    order = (list(rng.permutation(slots)) if rng is not None
             else slots)
    tag = {}
    for j in order:                          # plain stores, the last stays
        tag[tag_home(int(flat_a[j]))] = j
    contested = {tag_home(int(flat_a[j])) for j in slots
                 if tag[tag_home(int(flat_a[j]))] != j}
    keys = np.full(cap, -1, np.int64)
    claim = np.full(cap, INT_MAX, np.int64)
    pos = np.full(B * K, -1, np.int64)
    for j in order:                          # contested slots claim
        a = int(flat_a[j])
        if tag_home(a) not in contested:
            continue
        p = home(a)
        for _ in range(cap):                 # linear probing
            if keys[p] in (-1, a):
                break
            p = (p + 1) & (cap - 1)
        else:
            raise AssertionError("no free bucket: the hash overflowed")
        keys[p] = a
        pos[j] = p
        claim[p] = min(claim[p], j // K)
    new = np.array(words, np.uint32, copy=True)
    success = passing.copy()
    rows = rng.permutation(B) if rng is not None else np.arange(B)
    for i in rows:                           # the verdict, winners write
        p_row = pos[i * K:(i + 1) * K]
        success[i] &= not any(p >= 0 and claim[p] < i for p in p_row)
        if success[i]:
            for k in range(K):
                if addr[i, k] >= 0:
                    new[addr[i, k]] = des[i, k]
    return new, success, keys, pos


def _t(arr):
    return words_to_tensor(np.asarray(arr), "cpu")


def _plain(words, addr, exp, des):
    w = _t(words)[None]
    _, succ = ref.pmwcas_apply_stacked(w, _t(addr)[None], _t(exp)[None],
                                       _t(des)[None])
    return tensor_to_words(w[0]), succ[0].numpy()


def _check(words, addr, exp, des, orders=3, pallas_tb=None, **kw):
    """The mirror, in several orders, against the port's plain version
    and the JAX reference's oracle (and its Pallas kernel in interpret
    mode where ``pallas_tb`` is given): verdicts and tables bit for bit;
    every claimed address sits in the hash once, where its slots point."""
    want_new, want_succ = _plain(words, addr, exp, des)
    j_new, j_succ = ref_pm.pmwcas_apply_ref(
        jnp.asarray(words), jnp.asarray(addr), jnp.asarray(exp),
        jnp.asarray(des))
    cur = words[np.maximum(addr, 0)]
    j_oracle = ref_pm.pmwcas_success_ref(jnp.asarray(addr), jnp.asarray(cur),
                                         jnp.asarray(exp))
    np.testing.assert_array_equal(want_succ, np.asarray(j_succ))
    np.testing.assert_array_equal(want_succ, np.asarray(j_oracle))
    if not any(len(set(r[r >= 0].tolist())) < (r >= 0).sum()
               for r in addr):      # XLA leaves duplicates' order free
        np.testing.assert_array_equal(want_new, np.asarray(j_new))
    if pallas_tb is not None:
        j_pallas = ref_pm.pmwcas_success_pallas(
            jnp.asarray(addr), jnp.asarray(cur), jnp.asarray(exp),
            tb=pallas_tb, interpret=True)
        np.testing.assert_array_equal(want_succ, np.asarray(j_pallas))
    valid = addr.reshape(-1) >= 0
    for o in range(orders):
        rng = np.random.default_rng(o) if o else None
        new, succ, keys, pos = _hash_claim(words, addr, exp, des, rng=rng,
                                           **kw)
        np.testing.assert_array_equal(succ, want_succ)
        np.testing.assert_array_equal(new, want_new)
        claimed = pos >= 0
        assert not (claimed & ~valid).any()
        np.testing.assert_array_equal(keys[pos[claimed]],
                                      addr.reshape(-1)[claimed])
        stored = keys[keys >= 0]
        assert len(stored) == len(set(stored.tolist())) == len(
            set(addr.reshape(-1)[claimed].tolist()))
    return want_succ


def _random_case(rng, W, B, K, pad_frac=0.1, val_range=4, distinct=True):
    words = rng.integers(0, val_range, W).astype(np.uint32)
    if distinct:
        addr = np.stack([np.sort(rng.choice(W, K, replace=False))
                         for _ in range(B)]).astype(np.int32)
    else:
        addr = rng.integers(0, W, (B, K)).astype(np.int32)
    addr[rng.random((B, K)) < pad_frac] = -1
    exp = rng.integers(0, val_range, (B, K)).astype(np.uint32)
    des = rng.integers(0, 1 << 32, (B, K), dtype=np.uint64).astype(np.uint32)
    return words, addr, exp, des


# the W, B, K, tb sweep of tests/test_torch_pmwcas_apply.py (after
# tests/test_kernels.py), through the Pallas kernel too
@pytest.mark.parametrize("W,B,K,tb", [
    (32, 8, 1, 4), (64, 32, 3, 8), (128, 64, 4, 16), (64, 17, 2, 8),
    (16, 40, 4, 8), (256, 7, 8, 4),
])
def test_hash_claim_matches_plain_and_pallas(W, B, K, tb):
    rng = np.random.default_rng(42 + W + B + K)
    _check(*_random_case(rng, W, B, K), pallas_tb=tb)


# the apply sweep, and the same shapes with duplicate ids inside rows
@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("seed,B,K,W", [
    (0, 1, 1, 16), (1, 40, 4, 16), (2, 17, 2, 64), (3, 32, 3, 256),
    (4, 8, 4, 16), (5, 25, 1, 64), (6, 64, 8, 64), (7, 33, 2, 8),
])
def test_hash_claim_matches_plain_and_reference(seed, B, K, W, distinct):
    rng = np.random.default_rng(seed)
    _check(*_random_case(rng, W, B, min(K, W), distinct=distinct))


def test_hash_claim_at_the_service_shape():
    """A [1024, 2] round (a ycsb wave's shard) of bucket-pair addresses,
    expected values mostly current, against a 4,096-word table."""
    rng = np.random.default_rng(5)
    W = 4096
    words = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    bucket = rng.integers(0, W // 2, 1024)
    addr = np.stack([2 * bucket, 2 * bucket + 1], 1).astype(np.int32)
    addr[rng.random(1024) < 0.05] = -1
    exp = words[np.maximum(addr, 0)]
    exp[rng.random((1024, 2)) < 0.05] += 1
    des = rng.integers(0, 1 << 32, (1024, 2), dtype=np.uint64).astype(
        np.uint32)
    succ = _check(words, addr, exp, des, orders=2)
    assert succ.any() and not succ.all()


@pytest.mark.parametrize("home", ["one_bucket", "colliding_addresses"])
def test_hash_claim_under_adversarial_collisions(home):
    """Every address in one tag bucket and one home bucket, so every
    passing slot is contested and probes run the length of the hash: a
    mirror whose home functions send all to bucket 0, and real addresses
    that the kernel's hash sends there."""
    rng = np.random.default_rng(9)
    B, K = 96, 2
    tag_bits, cap_bits = kernel.table_bits(B, K)
    if home == "one_bucket":
        W, pool = 256, np.arange(256)
        kw = dict(tag_home=lambda a: 0, home=lambda a: 0)
    else:
        W = 1 << 22
        pool = np.flatnonzero(kernel.hash_bucket(np.arange(W), tag_bits)
                              == 0)
        assert len(pool) >= 64
        assert (kernel.hash_bucket(pool, cap_bits) == 0).all()
        kw = {}
    words = rng.integers(0, 2, W).astype(np.uint32)
    addr = rng.choice(pool[:64], (B, K)).astype(np.int32)  # shared too
    addr[rng.random((B, K)) < 0.1] = -1
    exp = rng.integers(0, 2, (B, K)).astype(np.uint32)
    des = rng.integers(0, 1 << 32, (B, K), dtype=np.uint64).astype(np.uint32)
    _check(words, addr, exp, des, **kw)
    _, succ, keys, pos = _hash_claim(words, addr, exp, des, **kw)
    n_keys = len(set(addr.reshape(-1)[pos >= 0].tolist()))
    assert n_keys > 16 and succ.any() and not succ.all()
    assert (keys[:n_keys] >= 0).all() and (keys[n_keys:] == -1).all()


def test_hash_claim_in_a_full_hash():
    """As many hash entries as contested addresses: every entry ends up
    full and every probe still finds its key."""
    rng = np.random.default_rng(12)
    W, B, K = 64, 16, 2
    addr = rng.permutation(W)[:B * K].reshape(B, K).astype(np.int32)
    addr[3] = addr[2]                              # rows that share words
    addr[7, 1] = addr[7, 0]                        # a duplicate id
    bits = len(set(addr.reshape(-1).tolist())).bit_length() - 1
    keep = np.unique(addr)[:1 << bits]             # 2^bits distinct keys
    addr = np.where(np.isin(addr, keep), addr, -1).astype(np.int32)
    words = rng.integers(0, 2, W).astype(np.uint32)
    exp = words[np.maximum(addr, 0)]
    des = rng.integers(0, 1 << 32, (B, K), dtype=np.uint64).astype(np.uint32)
    kw = dict(cap_bits=bits, tag_home=lambda a: 0)
    _check(words, addr, exp, des, **kw)
    _, _, keys, _ = _hash_claim(words, addr, exp, des, **kw)
    assert (keys >= 0).all()


def test_hash_claim_duplicates_padding_and_blocking():
    """Duplicate ids keep the last slot's des, all-padded rows win
    vacuously, a row that passes (a) and loses still blocks."""
    words = np.zeros(16, np.uint32)
    addr = np.asarray([[0, 3], [3, 4], [4, 5], [6, 7], [-1, -1], [9, 9],
                       [-1, 10], [10, 10]], np.int32)
    exp = np.zeros_like(addr, dtype=np.uint32)
    exp[3, 1] = 9                                   # row 3 fails (a)
    des = np.arange(1, addr.size + 1, dtype=np.uint32).reshape(addr.shape)
    succ = _check(words, addr, exp, des, orders=4)
    assert succ.tolist() == [True, False, False, False, True, True, True,
                             False]
    new, _, _, _ = _hash_claim(words, addr, exp, des)
    assert new[9] == des[5, 1] and new[10] == des[6, 1]


@pytest.mark.parametrize("case", [
    ([[3, 3, 5, -1]], None, [True]),                    # duplicate ids
    ([[-1, -1, -1], [0, 1, -1]], None, [True, True]),   # all-padded
    ([[0, 1, 2, 3], [3, 4, 5, 6], [7, 8, 9, 10], [4, 5, 11, 12]], None,
     [True, False, True, False]),                      # lower index wins
    ([[1, 2, -1]], 2, [False]),                         # already claimed
])
def test_hash_claim_reserve_slots_corner_cases(case):
    reqs, taken, want = case
    free = np.ones(16, np.uint32)
    if taken is not None:
        free[taken] = 0
    reqs = np.asarray(reqs, np.int32)
    ones = np.ones(reqs.shape, np.uint32)
    succ = _check(free, reqs, ones, np.zeros_like(ones), orders=4)
    assert succ.tolist() == want
    j_mask, j_granted = ref_pm.reserve_slots(jnp.asarray(free),
                                             jnp.asarray(reqs),
                                             use_kernel=False)
    new, got, _, _ = _hash_claim(free, reqs, ones, np.zeros_like(ones))
    np.testing.assert_array_equal(got, np.asarray(j_granted))
    np.testing.assert_array_equal(new, np.asarray(j_mask))
