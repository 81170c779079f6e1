"""The port's ``FreeListAllocator`` against the JAX package's.

The same seeded request streams — raw ``reserve`` candidate sets that
overlap, ``alloc`` counts, ``free`` lists — go through
``repro.structures.FreeListAllocator`` (its jnp path, and once the
Pallas kernel in interpret mode) and
``repro_torch.structures.FreeListAllocator(device="cpu")``: the free
masks, the grants, the ``reserve`` verdicts, ``OutOfRegions.requests``
/ ``grants`` and the ``DoubleFree`` refusals must be equal.  Every
check is exact.
"""
import numpy as np
import pytest
import torch

import repro.structures as ref_st
import repro_torch.structures as st


def _pair(n_slots, **kw):
    return (ref_st.FreeListAllocator(n_slots, **kw),
            st.FreeListAllocator(n_slots, device="cpu", **kw))


def _same_mask(ref, port):
    m = port.mask()
    assert m.dtype == np.uint32
    assert np.array_equal(ref.mask(), m)
    assert ref.n_free == port.n_free


def test_mask_lives_on_the_requested_device():
    fl = st.FreeListAllocator(8, device="cpu")
    assert fl._mask.dtype == torch.int32 and fl._mask.device.type == "cpu"
    assert fl.mask().tolist() == [1] * 8 and fl.n_free == 8
    with pytest.raises(ValueError, match="at least one slot"):
        st.FreeListAllocator(0, device="cpu")
    with pytest.raises(ValueError, match="region mapping"):
        fl.region(0)
    if not torch.cuda.is_available():
        # an entry point asked for the card raises without one
        with pytest.raises(RuntimeError, match="cuda"):
            st.FreeListAllocator(8)


@pytest.mark.parametrize("seed", range(6))
def test_reserve_verdicts_and_masks(seed):
    """Overlapping raw candidate sets (some duplicated ids, some already
    claimed): lower batch index wins atomically, in both packages."""
    rng = np.random.default_rng(seed)
    n = 24
    ref, port = _pair(n)
    for _ in range(5):
        cands = [sorted(rng.choice(n, int(rng.integers(1, 5)),
                                   replace=False).tolist())
                 for _ in range(int(rng.integers(1, 9)))]
        if rng.random() < 0.3:
            cands.append([])                    # vacuous request
        assert port.reserve(cands) == ref.reserve(cands)
        _same_mask(ref, port)


@pytest.mark.parametrize("seed", range(6))
def test_alloc_free_stream(seed):
    """Seeded alloc/free interleavings until exhaustion: identical grants,
    identical typed exhaustion (``requests`` and partial ``grants``)."""
    rng = np.random.default_rng(100 + seed)
    ref, port = _pair(32, region_base=7, region_words=5)
    owned = []
    for _ in range(12):
        if owned and rng.random() < 0.35:
            slots = owned.pop(int(rng.integers(len(owned))))
            ref.free(slots)
            port.free(slots)
        else:
            counts = rng.integers(0, 6, int(rng.integers(1, 4))).tolist()
            try:
                want = ref.alloc(counts)
            except ref_st.OutOfRegions as e:
                with pytest.raises(st.OutOfRegions) as got:
                    port.alloc(counts)
                assert got.value.requests == e.requests
                assert got.value.grants == e.grants
                owned += [g for g in e.grants if g]
            else:
                grants = port.alloc(counts)
                assert grants == want
                owned += [g for g in grants if g]
                assert all(port.region(s) == ref.region(s) == 7 + 5 * s
                           for g in grants if g for s in g)
        _same_mask(ref, port)


def test_exhaustion_modes_match():
    """``tests/test_structures.py::test_freelist_exhaustion_is_typed`` on
    both packages: the typed error, the legacy ``None`` grant, and the
    raw contended reservation."""
    for on_exhausted in ("raise", "none"):
        ref, port = _pair(4)
        if on_exhausted == "raise":
            with pytest.raises(ref_st.OutOfRegions) as r:
                ref.alloc([3, 3])
            with pytest.raises(st.OutOfRegions) as p:
                port.alloc([3, 3])
            assert p.value.requests == r.value.requests == (1,)
            assert p.value.grants == r.value.grants
            assert isinstance(p.value, RuntimeError)
        else:
            assert port.alloc([3, 3], on_exhausted="none") == \
                ref.alloc([3, 3], on_exhausted="none")
        _same_mask(ref, port)
        with pytest.raises(ValueError, match="on_exhausted"):
            port.alloc([1], on_exhausted="wait")
    ref, port = _pair(8)
    assert port.reserve([[0, 1], [1, 2], [3, 4]]) == \
        ref.reserve([[0, 1], [1, 2], [3, 4]]) == [True, False, True]
    _same_mask(ref, port)


def test_double_free_refused_and_mask_untouched():
    ref, port = _pair(16, region_base=100, region_words=8)
    grants = port.alloc([2, 3, 0])
    assert grants == ref.alloc([2, 3, 0])
    port.free(grants[1])
    ref.free(grants[1])
    _same_mask(ref, port)
    for slots in (grants[1], grants[0] + grants[1], [grants[0][0]] * 2):
        with pytest.raises(ref_st.DoubleFree):
            ref.free(slots)
        with pytest.raises(st.DoubleFree) as e:
            port.free(slots)
        assert isinstance(e.value, ValueError)
        _same_mask(ref, port)                  # a refused free moves nothing
    port.free([])
    ref.free([])
    _same_mask(ref, port)


def test_reserve_on_the_pallas_kernel():
    """One stream with the reference on its Pallas kernel (interpret
    mode) instead of the jnp path."""
    ref = ref_st.FreeListAllocator(12, use_kernel=True, interpret=True)
    port = st.FreeListAllocator(12, device="cpu")
    cands = [[0, 1, 2], [2, 3], [4, 5], [5, 6, 7], [8]]
    assert port.reserve(cands) == ref.reserve(cands) == \
        [True, False, True, False, True]
    assert port.alloc([2, 1]) == ref.alloc([2, 1])
    port.free([0, 1])
    ref.free([0, 1])
    _same_mask(ref, port)
