"""The port's descriptor-WAL committer against the JAX package's, exactly.

One seeded stream of ``(cid, targets, payloads)`` commits — per op
(``commit``) or per round (``commit_round``), with explicit syncs,
checkpoints and WAL prunes between them — runs through the reference
``repro.Committer`` and ``repro_torch.Committer``, each over its own
``PMemPool`` directory.  Every verdict, every slot version after every
step, ``DurabilityStats.as_row()``, each registry's flush ledger by
``(component, reason)`` and, after a final ``prune_completed``, the
pool's sorted file list and every file's bytes must be equal: the same
integers and the same bytes, no tolerance.  Record timestamps are pinned
so the bytes compare.

Then the crash parity: for every ``N`` up to the stream's persist
count, both pools crash on the N-th persist; ``crash()`` + ``recover()``
must give equal versions, and the recovered state must be the state
after some prefix of the stream's steps (no torn op or round; without
epochs, nothing that returned is lost).

Two deliberate differences, where the reference breaks that invariant
(the last test holds the port to it and shows the reference's answer):
``prune_completed`` inside an open epoch closes the epoch first, and
keeps round/epoch records while a checkpoint image exists.  The parity
streams prune only where neither arises.
"""
import time

import numpy as np
import pytest

import repro
import repro.obs as ref_obs
import repro_torch
import repro_torch.obs as obs

NAMES = [f"s{i}" for i in range(6)]


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    """Records carry ``time.time()``; pin it so both pools' bytes match."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _targets(rng, model, k_max=3):
    names = sorted(rng.choice(NAMES, int(rng.integers(1, k_max + 1)),
                              replace=False).tolist())
    out = []
    for name in names:
        exp = model[name] if rng.random() < 0.85 else model[name] + 1
        des = exp if rng.random() < 0.04 else exp + int(rng.integers(1, 3))
        out.append((name, exp, des))
    return out


def _stream(seed, mode, n_steps, checkpoint_every=0):
    """A seeded step list.  A model of the slot versions keeps most
    expected versions current (so most ops win), with stale expectations,
    non-advancing versions and in-round collisions mixed in."""
    rng = np.random.default_rng(seed)
    model = dict.fromkeys(NAMES, 0)
    steps = []
    for i in range(n_steps):
        if mode == "op":
            targets = _targets(rng, model)
            if all(model[n] == e != d for n, e, d in targets):
                model.update({n: d for n, _e, d in targets})
            steps.append(("op", f"op-{i}", targets, {
                n: f"{n}:{d}:{i}".encode() for n, _e, d in targets}))
        else:
            entries, payloads, claimed = [], {}, set()
            for j in range(int(rng.integers(1, 5))):
                targets = _targets(rng, model, k_max=2)
                names = {n for n, _e, _d in targets}
                if all(model[n] == e != d for n, e, d in targets) \
                        and not names & claimed:
                    claimed |= names
                    model.update({n: d for n, _e, d in targets})
                entries.append((f"r{i}-{j}", targets))
                payloads.update({n: f"{n}:{d}:{i}".encode()
                                 for n, _e, d in targets})
            steps.append(("round", entries, payloads))
        if i % 5 == 4:
            steps.append(("checkpoint",) if checkpoint_every
                         else ("sync",))
            if i % 10 == 9 and not (checkpoint_every and mode == "round"):
                # no epoch is open here, and no image covers the round
                # records (see test_prune_never_tears_where_the_reference_
                # does for both)
                steps.append(("prune",))
    steps.append(("sync",))
    return steps


def _apply(c, step):
    kind = step[0]
    if kind == "op":
        return c.commit(step[1], step[2], step[3])
    if kind == "round":
        return c.commit_round(step[1], step[2])
    if kind == "sync":
        return c.sync()
    if kind == "checkpoint":
        return c.checkpoint()
    return c.prune_completed()


def _run(pkg, root, steps, epoch_rounds=1, checkpoint_every=0,
         committer="Committer"):
    """Drive one package's committer; returns it and the per-step
    (verdict, versions) trace."""
    c = getattr(pkg, committer)(pkg.PMemPool(root),
                                epoch_rounds=epoch_rounds,
                                checkpoint_every=checkpoint_every)
    trace = []
    for step in steps:
        trace.append((_apply(c, step),
                      {n: c.slot_version(n) for n in NAMES}))
    return c, trace


def _ledger(registry):
    """Every counter the commit paths book (the flush ledger by
    ``(component, reason)`` and the committer's own series), and the
    sample count of every histogram; series other code registered in
    this process and left at zero are not part of the ledger."""
    out = {}
    for s in registry.series():
        value = s.count if s.kind == "histogram" else s.value
        if value:
            out[(s.name, tuple(s.labels))] = value
    return out


def _files(pool):
    root = pool.root
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, steps, **kw):
    ref_obs.reset_metrics()
    obs.reset_metrics()
    ref, ref_trace = _run(repro, tmp_path / "ref", steps, **kw)
    port, trace = _run(repro_torch, tmp_path / "port", steps, **kw)
    assert trace == ref_trace
    return ref, port, trace


def _check_equal(ref, port, prune=True):
    assert port.stats.as_row() == ref.stats.as_row()
    assert _ledger(obs.get_registry()) == _ledger(ref_obs.get_registry())
    if prune:
        assert port.prune_completed() == ref.prune_completed()
    files = _files(port.pool)
    assert sorted(files) == sorted(_files(ref.pool))
    assert files == _files(ref.pool)


# ---------------------------------------------------------------------------
# the committer on a clean pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("checkpoint_every", [0, 2])
@pytest.mark.parametrize("epoch_rounds", [1, 4])
@pytest.mark.parametrize("mode", ["op", "round"])
def test_committer_matches_reference(tmp_path, mode, epoch_rounds,
                                     checkpoint_every):
    steps = _stream(11, mode, 40, checkpoint_every)
    ref, port, trace = _both(tmp_path, steps, epoch_rounds=epoch_rounds,
                             checkpoint_every=checkpoint_every)
    verdicts = [v for (v, _), step in zip(trace, steps)
                if step[0] in ("op", "round")]
    flat = [x for v in verdicts for x in (v if mode == "round" else [v])]
    assert any(flat) and not all(flat), "the stream must win and lose"
    _check_equal(ref, port, prune=not (checkpoint_every and mode == "round"))
    redundant = {dict(s.labels)["reason"]: s.value
                 for s in obs.get_registry().series("redundant_fences")
                 if s.value}
    if mode == "op":
        # the per-op protocol's read barrier fences clean slot lines
        assert redundant.get("read_barrier", 0) > 0
    else:
        # the group-commit hot path fences no clean line (hygiene may)
        assert set(redundant) <= {"wal_prune", "checkpoint"}, redundant
        assert port.stats.fences > 0 and port.stats.flushes_saved > 0
    if epoch_rounds > 1 and mode == "round":
        assert port.stats.epochs_closed > 0
    if checkpoint_every:
        assert port.stats.checkpoints > 0


def test_marker_committer_matches_reference(tmp_path):
    steps = [s for s in _stream(5, "op", 40) if s[0] != "checkpoint"]
    ref, port, _ = _both(tmp_path, steps, committer="MarkerCommitter")
    _check_equal(ref, port)
    assert port.stats.flushes_issued > 0
    # the recovery scans markers and replays descriptors alike
    for c in (ref, port):
        c.pool = c.pool.crash()
    assert port.recover() == ref.recover()
    for pkg in (repro, repro_torch):
        with pytest.raises(ValueError, match="epoch"):
            pkg.MarkerCommitter(pkg.PMemPool(tmp_path / "m"),
                                epoch_rounds=2)


def test_commit_error_and_surface():
    assert issubclass(repro_torch.CommitError, Exception)
    assert repro_torch.Committer.supports_rounds is True
    assert repro_torch.MarkerCommitter.supports_rounds is False
    assert repro_torch.checkpoint.data_rel("x", 3) == \
        repro.data_rel("x", 3) == "data/x.v3.bin"
    # one DurabilityStats, shared by the committer and pmwcas surfaces
    assert repro_torch.pmwcas.DurabilityStats is \
        repro_torch.checkpoint.DurabilityStats


# ---------------------------------------------------------------------------
# crash at every persist
# ---------------------------------------------------------------------------

def _crash_run(pkg, root, steps, n, **kw):
    """Run ``steps`` on a pool that crashes on persist ``n``; returns the
    index of the step that crashed (``len(steps)`` if none did) and the
    recovered versions."""
    c = pkg.Committer(pkg.PMemPool(root, crash_after_persists=n), **kw)
    reached = len(steps)
    for i, step in enumerate(steps):
        try:
            _apply(c, step)
        except pkg.SimulatedCrash:
            reached = i
            break
    c2 = pkg.Committer(c.pool.crash(), **kw)
    recovered = c2.recover()
    return reached, {n_: c2.slot_version(n_) for n_ in NAMES}, recovered


CRASH_CASES = {
    "per_op": ("op", dict()),
    "group": ("round", dict()),
    "epoch_ckpt": ("round", dict(epoch_rounds=4, checkpoint_every=2)),
}


@pytest.mark.parametrize("case", sorted(CRASH_CASES))
def test_crash_at_every_persist_matches_reference(tmp_path, case):
    mode, kw = CRASH_CASES[case]
    steps = _stream(3, mode, 10 if mode == "op" else 14,
                    kw.get("checkpoint_every", 0))
    clean, trace = _run(repro_torch, tmp_path / "clean", steps, **kw)
    total = clean.pool.persist_count
    states = [dict.fromkeys(NAMES, 0)] + [v for _, v in trace]
    lossy = kw.get("epoch_rounds", 1) > 1
    seen = set()
    for n in range(total + 1):
        ref = _crash_run(repro, tmp_path / f"r{n}", steps, n, **kw)
        port = _crash_run(repro_torch, tmp_path / f"p{n}", steps, n, **kw)
        assert port == ref, n
        reached, got, _ = port
        # a prefix of the stream's steps (the crashing one whole or not
        # at all), never a torn op or round
        assert got in states[:reached + 2], (n, got)
        if not lossy:
            # nothing that returned is lost: the state after the last
            # completed step, or with the crashing step applied whole
            assert states[reached] == got or \
                (reached < len(steps) and states[reached + 1] == got), n
        seen.add(tuple(sorted(got.items())))
    assert reached == len(steps) and got == states[-1]
    assert len(seen) > 2, "the sweep must see several recovered states"


def _epoch_sweep(pkg, root):
    """The reference's ``tests/test_epoch.py::
    test_epoch_crash_sweep_at_every_persist`` as a function of the
    package: crash at every persist through epoch closes, a checkpoint
    and a final sync; returns every (crash point, recovered x/y,
    allowed states) and the crash point that completed."""
    states = {0: (0, 0), 1: (1, 1), 2: (2, 2), 3: (3, 2)}

    def drive(c):
        c.commit_round([("a", [("x", 0, 1)])], {"x": b"X1"})
        c.commit_round([("b", [("y", 0, 1)])], {"y": b"Y1"})
        yield 1
        c.commit_round([("c", [("x", 1, 2)])], {"x": b"X2"})
        c.commit_round([("d", [("y", 1, 2)])], {"y": b"Y2"})
        yield 2
        c.commit_round([("e", [("x", 2, 3)])], {"x": b"X3"})
        c.sync()
        yield 3

    out = []
    crash_at = 0
    while True:
        pool = pkg.PMemPool(root / f"c{crash_at}",
                            crash_after_persists=crash_at)
        c = pkg.Committer(pool, epoch_rounds=2, checkpoint_every=2)
        reached, crashed = 0, False
        try:
            for reached in drive(c):
                pass
        except pkg.SimulatedCrash:
            crashed = True
        c2 = pkg.Committer(pool.crash(), epoch_rounds=2, checkpoint_every=2)
        c2.recover()
        got = (c2.slot_version("x"), c2.slot_version("y"))
        allowed = [states[k] for k in range(reached, 4)]
        payloads_whole = all(
            c2.pool.read(f"data/{name}.v{ver}.bin") ==
            f"{name.upper()}{ver}".encode()
            for name, ver in zip("xy", got) if ver)
        c3 = pkg.Committer(c2.pool.crash(), epoch_rounds=2,
                           checkpoint_every=2)
        c3.recover()
        fixpoint = (c3.slot_version("x"), c3.slot_version("y")) == got
        out.append((crash_at, got, got in allowed, payloads_whole,
                    fixpoint))
        if not crashed:
            return out, crash_at
        crash_at += 1
        assert crash_at < 60, "sweep did not terminate"


def test_epoch_crash_sweep_at_every_persist_on_the_port(tmp_path):
    """The reference's epoch sweep, run on both packages: the same
    crash points, the same recovered states, and on the port every one
    allowed, whole and a fixpoint of a second crash/recover."""
    ref = _epoch_sweep(repro, tmp_path / "ref")
    port = _epoch_sweep(repro_torch, tmp_path / "port")
    assert port == ref
    rows, last = port
    assert all(ok and whole and fix for _n, _g, ok, whole, fix in rows)
    seen = {got for _n, got, *_ in rows}
    assert rows[-1][1] == (3, 2) and (0, 0) in seen and last > 5


def _pruned_in_epochs(seed, n_rounds):
    """Rounds with a WAL prune after every third one, inside open
    epochs."""
    out = []
    rounds = [s for s in _stream(seed, "round", n_rounds) if s[0] == "round"]
    for i, step in enumerate(rounds):
        out.append(step)
        if i % 3 == 2:
            out.append(("prune",))
    return out + [("sync",)]


PRUNE_FAULTS = {
    # the prune flushes slot lines an unfenced epoch round moved
    "inside_open_epoch": (lambda: _pruned_in_epochs(3, 14),
                          dict(epoch_rounds=4)),
    # the prune drops records above the image; recovery installs the
    # image over the slot lines and replays only what is left
    "under_a_checkpoint_image": (
        lambda: _stream(3, "round", 14) + [("prune",), ("round", [
            ("z", [("s0", 1, 2)])], {"s0": b"z"})],
        dict(epoch_rounds=4, checkpoint_every=2)),
}


def _torn_points(pkg, root, steps, kw):
    """Crash points whose recovered state is no prefix of the steps."""
    clean, trace = _run(pkg, root / "clean", steps, **kw)
    states = [dict.fromkeys(NAMES, 0)] + [v for _, v in trace]
    torn = []
    for n in range(clean.pool.persist_count + 1):
        reached, got, _ = _crash_run(pkg, root / f"c{n}", steps, n, **kw)
        if got not in states[:reached + 2]:
            torn.append(n)
    return torn


@pytest.mark.parametrize("fault", sorted(PRUNE_FAULTS))
def test_prune_never_tears_where_the_reference_does(tmp_path, fault):
    """A WAL prune inside an open epoch, or under a checkpoint image:
    the port recovers a prefix of the steps at every crash point; the
    reference's answer at some of them is a torn or regressed state
    (recorded in ROADMAP Queue 3)."""
    make, kw = PRUNE_FAULTS[fault]
    steps = make()
    assert _torn_points(repro_torch, tmp_path / "port", steps, kw) == []
    assert _torn_points(repro, tmp_path / "ref", steps, kw) != []
