"""The simulator kernel's route plan, its shared-memory layout and its
record and output layouts, on the CPU.

``kernels/pmwcas_sim/kernel.py::plan(jobs)`` decides from the jobs'
configs alone which route a launch takes (``smem``: every simulation's
per-thread state in shared memory; ``global``: the state in device
memory) and how much shared memory the ``smem`` route asks for.  These
tests need no card: they hold the plan to the configs the port runs (the
Figs. 9-10 grid, ``chip_smoke.SIM_CASES``, the crash sweeps, the
``SimBackend`` rounds), the shared-memory size to the state fields'
``nbytes`` from ``core.model.field_shapes``, and the Python constants to
the CUDA source's enums, read from its text.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch import pmwcas as pm
from repro_torch.core.model import FIELDS, field_dtype, field_shapes
from repro_torch.kernels.pmwcas_sim import kernel

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SOURCE = kernel.SOURCE.read_text()
GRID = chip_smoke.fig_specs(core, pm)
CRASH_CFGS = [core.SimConfig(algorithm=alg, k=k, **chip_smoke.CRASH_KW)
              for alg, k in chip_smoke.CRASH_ALGS]
# check_sim_crash_sweep's configs at tests/test_torch_cuda.py's batch: one
# thread an op, one op each
SWEEP_CFGS = [core.SimConfig(algorithm=alg, n_threads=4, n_words=16,
                             k=1 if alg == "pcas" else 2, max_ops=1,
                             n_steps=400)
              for alg in ("ours", "ours_df", "original", "pcas")]


def _job(cfg):
    return kernel.SimJob(cfg, {}, np.zeros(0, np.int32))


def _cfg(T, k, alg="ours"):
    return core.SimConfig(algorithm=alg, n_threads=T, k=k, n_words=1 << 12,
                          max_ops=4, n_steps=16)


_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_}


def _moved_nbytes(cfg):
    """The summed nbytes of the state fields the smem route moves, by
    allocating each at its shape and dtype."""
    shapes = field_shapes(cfg)
    return sum(np.empty(shapes[f], _NP[field_dtype(f)]).nbytes
               for f in kernel.SMEM_FIELDS)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n, _ in GRID])
def test_plan_takes_smem_for_every_grid_cell(name):
    cfg = dict(GRID)[name][0]
    assert kernel.plan([_job(cfg)]) == ("smem", kernel.smem_bytes(cfg))


def test_plan_takes_smem_for_the_whole_grid():
    """One launch runs the grid: its largest state decides."""
    cfgs = [spec[0] for _, spec in GRID]
    need = max(kernel.smem_bytes(c) for c in cfgs)
    assert kernel.plan([_job(c) for c in cfgs]) == ("smem", need)
    # t = 56, k = 3 is the largest: 4,096 schedule bytes + 56 x 250
    assert need == 2 * kernel.SCHED_CHUNK * 4 + 56 * 250 == 18_096


@pytest.mark.parametrize("case", range(len(chip_smoke.SIM_CASES)),
                         ids=lambda i: "{}-{}".format(
                             chip_smoke.SIM_CASES[i][0], i))
def test_plan_takes_smem_for_sim_cases(case):
    alg, kw = chip_smoke.SIM_CASES[case]
    cfg = core.SimConfig(algorithm=alg, **kw)
    route, nbytes = kernel.plan([_job(cfg)])
    assert route == "smem" and nbytes == kernel.smem_bytes(cfg)


@pytest.mark.parametrize("cfg", CRASH_CFGS + SWEEP_CFGS
                         + [core.SimConfig(**chip_smoke.PIN_CFG)],
                         ids=lambda c: f"{c.algorithm}-T{c.n_threads}-k{c.k}")
def test_plan_takes_smem_for_the_crash_sweeps(cfg):
    assert kernel.plan([_job(cfg)] * 399)[0] == "smem"


@pytest.mark.parametrize("T,k,route", [
    (4096, 3, "global"),                 # 4,096 threads of k = 3
    (1024, 3, "global"),                 # chip_smoke's wide SimBackend round
    (1024, 2, "smem"),                   # a [1024, 2] differential round
    (512, 32, "global"),                 # a [512, 32] differential round
    (64, 3, "smem"),
    (1, 1, "smem"),
])
def test_plan_route_by_size(T, k, route):
    cfg = _cfg(T, k)
    want = (route, kernel.smem_bytes(cfg) if route == "smem" else 0)
    assert kernel.plan([_job(cfg)]) == want
    assert (kernel.smem_bytes(cfg) <= kernel.SMEM_LIMIT) == (route == "smem")


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_plan_boundary(k):
    """The most threads the smem route takes at ``k``, and one more."""
    per_thread = kernel.smem_bytes(_cfg(2, k)) - kernel.smem_bytes(_cfg(1, k))
    base = kernel.smem_bytes(_cfg(1, k)) - per_thread
    most = (kernel.SMEM_LIMIT - base) // per_thread
    assert kernel.plan([_job(_cfg(most, k))])[0] == "smem"
    assert kernel.plan([_job(_cfg(most + 1, k))]) == ("global", 0)


@pytest.mark.parametrize("order", ["small_first", "large_first"])
def test_plan_of_a_mixed_launch_takes_its_largest_state(order):
    small, mid, large = _cfg(8, 3), _cfg(512, 2), _cfg(4096, 3)
    pair = [small, mid] if order == "small_first" else [mid, small]
    assert kernel.plan([_job(c) for c in pair]) == (
        "smem", kernel.smem_bytes(mid))
    trio = pair + [large] if order == "small_first" else [large] + pair
    assert kernel.plan([_job(c) for c in trio]) == ("global", 0)


def test_plan_of_no_job():
    assert kernel.plan([]) == ("smem", 0)


# ---------------------------------------------------------------------------
# the shared-memory layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,k,alg", [(56, 3, "ours"), (1, 1, "pcas"),
                                     (8, 2, "original"), (1024, 2, "ours"),
                                     (4, 32, "ours_df"), (300, 5, "ours")])
def test_smem_bytes_is_the_moved_fields_nbytes(T, k, alg):
    """The moved fields' nbytes, the schedule's two stages, the descriptor
    lines' owners and the staged op (k addresses, k desired values)."""
    cfg = _cfg(T, k, alg)
    extra = (2 * kernel.SCHED_CHUNK * 4 + 4 * T * cfg.desc_lines
             + 8 * T * k)
    assert kernel.smem_bytes(cfg) == _moved_nbytes(cfg) + extra
    # T x (134 + 28 k) bytes of state fields
    assert _moved_nbytes(cfg) == T * (134 + 28 * k)


def test_smem_fields_are_the_per_thread_fields():
    """Every field but the words, their lines' owners and the ops moves;
    each moved field's first dimension is the thread count."""
    stay = {"cache", "pmem", "line_owner", "ops", "ops_des"}
    assert set(kernel.SMEM_FIELDS) == set(FIELDS) - stay
    assert len(set(kernel.SMEM_FIELDS)) == len(kernel.SMEM_FIELDS)
    shapes = field_shapes(_cfg(7, 3))
    assert all(shapes[f][0] == 7 for f in kernel.SMEM_FIELDS)


def test_smem_fields_match_the_source_layout():
    """The source's bind_smem counts N_T32 [T] int32 fields, N_TK [T, k]
    fields and N_T8 [T] bool fields besides the counters."""
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"(N_T32|N_TK|N_T8) = (\d+)", SOURCE)}
    shapes = field_shapes(_cfg(5, 3))
    kinds = {"t32": 0, "tk": 0, "t8": 0}
    for f in kernel.SMEM_FIELDS:
        if f == "counters":
            continue
        if field_dtype(f) == torch.bool:
            kinds["t8"] += 1
        elif shapes[f] == (5, 3):
            kinds["tk"] += 1
        else:
            assert shapes[f] == (5,)
            kinds["t32"] += 1
    assert consts == {"N_T32": kinds["t32"], "N_TK": kinds["tk"],
                      "N_T8": kinds["t8"]}
    for f in kernel.SMEM_FIELDS:
        member = "cnt" if f == "counters" else f
        assert re.search(rf"move_field\(s\.{member}, g\.{member},", SOURCE)


# ---------------------------------------------------------------------------
# the record and output layouts against the source
# ---------------------------------------------------------------------------

def _enum(first: str) -> list:
    """The names of the source's enum that starts with ``first``."""
    m = re.search(r"enum : int \{\s*(" + first + r"\b[^}]*)\}", SOURCE)
    names = [part.split("=")[0].strip() for part in m.group(1).split(",")]
    return [n for n in names if n]


def test_record_layout_matches_source():
    rec = _enum("R_ALG")
    assert rec == ["R_ALG", "R_T", "R_K", "R_NWORDS", "R_WPL", "R_NWL",
                   "R_DL", "R_MAXOPS", "R_BINIT", "R_BCAP", "R_COST",
                   "R_MODE", "R_NSCHED", "R_CUT", "R_DRAIN", "R_CAP",
                   "R_SCHED", "R_FIELD"]
    assert re.search(r"R_COST = 10, R_MODE = 20", SOURCE)
    for name in rec:
        if name not in ("R_COST", "R_MODE", "R_FIELD"):
            assert isinstance(getattr(kernel, name), int), name
    assert (kernel.R_COST, kernel.R_MODE, kernel.R_SCHED,
            kernel.R_FIELD) == (10, 20, 25, 26)
    fields = _enum("F_CACHE")
    assert fields == ["F_" + f.upper() for f in FIELDS] + ["N_FIELDS"]
    assert kernel.REC_LEN == kernel.R_FIELD + len(FIELDS)


def test_output_layout_matches_source():
    assert _enum("O_ROUNDS") == ["O_ROUNDS", "O_ERR", "O_ERR_THREAD",
                                 "O_STEPS", "O_NS", "OUT_LEN"]
    assert (kernel.O_ROUNDS, kernel.O_ERR, kernel.O_ERR_THREAD,
            kernel.O_STEPS, kernel.O_NS, kernel.OUT_LEN) == tuple(range(6))


@pytest.mark.parametrize("name,pattern", [
    ("SCHED_CHUNK", r"constexpr int SCHED_CHUNK = (\d+);"),
    ("MAX_DRAIN_ROUNDS", r"kMaxDrainRounds = (\d+);"),
    ("MODE_BACKEND", r"MODE_BACKEND = (\d+);"),
    ("ERR_READ_PHASE", r"ERR_READ_PHASE = (\d+),"),
    ("ERR_ATTEMPT", r"ERR_ATTEMPT = (\d+),"),
    ("ERR_SMEM", r"ERR_SMEM = (\d+);"),
])
def test_constants_match_source(name, pattern):
    assert int(re.search(pattern, SOURCE).group(1)) == getattr(kernel, name)


# ---------------------------------------------------------------------------
# counts and routes off the card
# ---------------------------------------------------------------------------

def test_reset_counts_clears_route_launches():
    w = kernel.pmwcas_sim_cuda
    saved = (w.launches, dict(w.route_launches))
    try:
        w.launches = 5
        w.route_launches["smem"] += 3
        w.route_launches["global"] += 2
        kernel.reset_counts()
        assert w.launches == 0
        assert w.route_launches == {"smem": 0, "global": 0}
    finally:
        w.launches, w.route_launches = saved[0], saved[1]


@pytest.mark.parametrize("route", kernel.ROUTES)
def test_cpu_states_take_no_route(route):
    """The CPU runs only the plain version: a forced route raises there,
    and the kernel's wrapper refuses CPU tensors."""
    cfg = core.SimConfig(n_threads=2, n_words=16, k=1, max_ops=2,
                         n_steps=8)
    job = kernel.SimJob(cfg, core.init_state(cfg, device="cpu"),
                        core.generate_schedule(cfg))
    with pytest.raises(ValueError, match="plain version"):
        core.sim.run_jobs([job], route=route)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.pmwcas_sim_cuda([job], route)
    out = core.sim.run_jobs([job])
    assert out.shape == (1, kernel.OUT_LEN) and out[0, kernel.O_NS] == 0
