"""The ranks of ``tests/test_torch_multicard.py`` and
``tests/test_torch_multicard_moe.py``: one process a device of a mesh over
gloo on the CPU, each running cell programs' prefill and decode steps on
its shards.  This module imports no JAX and nothing of the reference (a
rank process imports it to find its entry point), so the ranks never do.

:func:`run_mesh_jobs` starts the ranks (the ``spawn`` context, a
``FileStore`` in the caller's directory), joins them within a timeout
(terminating them and raising on it) and returns rank by rank what each
wrote: for every job (a config, its weights and its planted faults) and
each of ``prefill`` and ``decode``, the logits and the cache gathered
whole, the write index, ``held_bytes()`` beside ``argument_bytes()``,
the collectives the step issued, and the gathered logits under each of
the job's ``chip_smoke.py`` faults (``plant_mesh_fault``); and the
results of the three collectives on a known tensor.  :func:`run_mesh`
runs one job.
"""
from __future__ import annotations

import pathlib
import pickle
import sys
import time

import numpy as np
import torch

from repro_torch.launch.steps import build_cell
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.collectives import Collectives
from repro_torch.parallel.group import (destroy_mesh_group, gather_full,
                                        init_mesh_group, local_shard)
from repro_torch.parallel.sharding import P, leaves, param_blocks

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the planted faults; imports no JAX)

JOIN_TIMEOUT_S = 120.0
FAULTS = chip_smoke.MESH_FAULTS


def fill_cache(cell, cache, seed: int, group=None) -> None:
    """The cache's global K/V drawn with numpy from ``seed``, leaf by leaf
    in ``leaves`` order (the same on every mesh), and this rank's shard
    of each (the whole of it without ``group``) copied in; the index at
    the last position."""
    rng = np.random.default_rng(seed)
    mine = dict(leaves(cache))
    for path, t in leaves(cell.args["cache"]):
        x = torch.from_numpy(rng.standard_normal(tuple(t.shape),
                                                 dtype=np.float32))
        if group is not None:
            x = local_shard(x, cell.specs["cache"][path], group)
        mine[path].copy_(x)
    cache["index"] = cell.shape.seq_len - 1


def logits_spec(cell) -> P:
    """The spec of a serving step's ``[B, V]`` logits (the ``logits``
    hint without its sequence entry)."""
    hint = cell.hints["logits"]
    return P(hint[0], hint[2])


def _step(cell, state, group, seed):
    gather = Collectives(group)
    state.model.par.coll.reset()
    if cell.mode == "decode":
        fill_cache(cell, state.args["cache"], seed + 1, group)
    else:                       # a prefill starts from the cache's states
        for _, t in leaves(state.args["cache"]):
            t.zero_()
        state.args["cache"]["index"] = 0
    logits, cache = cell.run(state)
    records = list(state.model.par.coll.records)
    full = gather_full(logits, logits_spec(cell), gather).numpy()
    return full, cache, records


def _collectives_probe(group) -> dict:
    """all-gather over ``data`` along dimension 1, all-reduce over
    ``model``, reduce-scatter over every axis along dimension 0, of a
    tensor that holds the rank's number."""
    coll = Collectives(group)
    names = group.mesh.axis_names
    x = torch.full((4, 2), float(group.rank)) + torch.arange(8.).view(4, 2)
    return {"gather": coll.all_gather(x, ("data",), 1).numpy(),
            "reduce": coll.all_reduce(x.clone(), ("model",)).numpy(),
            "scatter": coll.reduce_scatter(x.clone(), names, 0).numpy(),
            "records": coll.records}


def _job(cell_of, full, faults, group, seed) -> dict:
    """Every step of one job on this rank (``cell_of``: mode -> cell), and
    the names of the parameters that do not gather back to ``full``'s."""
    out = {}
    for mode, cell in cell_of.items():
        state = cell.materialize("cpu", seed, model=full, group=group)
        gather = Collectives(group)
        if "gathered_differ" not in out:
            whole = dict(full.named_parameters())
            out["gathered_differ"] = [
                name for name, t in state.model.named_parameters()
                if not torch.equal(gather_full(
                    t, cell.specs["params"][name], gather,
                    blocks=param_blocks(name)), whole[name])]
        logits, cache, records = _step(cell, state, group, seed)
        res = {"logits": logits, "index": cache["index"],
               "records": records, "held": state.held_bytes(),
               "want": cell.argument_bytes(),
               "cache": {path: gather_full(
                   t, cell.specs["cache"][path], gather).float().numpy()
                   for path, t in leaves(cache)},
               "faults": {}}
        for fault in faults:
            undo = chip_smoke.plant_mesh_fault(state.model, fault,
                                               group.rank)
            res["faults"][fault] = _step(cell, state, group, seed)[0]
            undo()
        out[mode] = res
    return out


def rank_main(rank: int, mesh, jobs: dict, store_path: str, out_dir: str,
              seed: int) -> None:
    """``jobs``: tag -> (config, shapes by mode, the weights' pickle,
    faults)."""
    torch.set_num_threads(1)
    group = init_mesh_group(mesh, rank, store_path, device="cpu")
    try:
        out = {"rank": rank, "coords": group.coords,
               "probe": _collectives_probe(group)}
        for tag, (cfg, shapes, weights_path, faults) in jobs.items():
            with open(weights_path, "rb") as f:
                full = params_from_numpy(pickle.load(f), cfg, device="cpu")
            out[tag] = _job({mode: build_cell(cfg, shape, mesh)
                             for mode, shape in shapes.items()},
                            full, faults, group, seed)
        with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        destroy_mesh_group()


def run_mesh(mesh, cfg, shapes: dict, tree, tmp: pathlib.Path,
             seed: int = 0) -> list:
    """One job, ``chip_smoke.MESH_FAULTS`` planted, on every rank of
    ``mesh`` (``tree``: the reference's parameters as numpy); returns
    each rank's results, the job's by mode beside the probe's."""
    out = run_mesh_jobs(mesh, {"": (cfg, shapes, tree, FAULTS)}, tmp, seed)
    return [dict(r, **r.pop("")) for r in out]


def run_mesh_jobs(mesh, jobs: dict, tmp: pathlib.Path,
                  seed: int = 0) -> list:
    """Run :func:`rank_main` on every rank of ``mesh``; ``jobs``: tag ->
    (config, shapes by mode, the reference's parameters as numpy, the
    faults to plant).  Returns each rank's results by tag."""
    import torch.multiprocessing as mp
    tmp.mkdir(parents=True, exist_ok=True)
    pickled = {}
    for i, (tag, (cfg, shapes, tree, faults)) in enumerate(jobs.items()):
        weights = tmp / f"weights{i}.pkl"
        with open(weights, "wb") as f:
            pickle.dump(tree, f)
        pickled[tag] = (cfg, shapes, str(weights), tuple(faults))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(
        r, mesh, pickled, str(tmp / "store"), str(tmp), seed))
        for r in range(mesh.size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
    if alive:
        raise TimeoutError(f"{len(alive)} ranks of {mesh.shape} still ran "
                           f"after {JOIN_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks of {mesh.shape} exited {codes}")
    out = []
    for r in range(mesh.size):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
