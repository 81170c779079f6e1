#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. card and build — the card's name and power limit, then the five
   Hopper sources built from ``src/repro_torch/csrc/{pmwcas_apply,
   flash_attention_tc, flash_attention_decode, flash_attention,
   pmwcas_sim}.cu``, one nvcc each in parallel (seconds, ptxas
   registers/spills);
2. kernels vs plain — the PMwCAS kernel's verdicts and tables held bit
   for bit against its plain PyTorch version on both routes (``smem``,
   where its hash fits, and ``global``) over seeded ``[S, B, K]``
   batches (S in {1, 4}, B in {1, 7, 1024}, K in {1, 2, 8}, serve's
   ``[1, 128, 9]`` and a ``global``-sized ``[2, 4500, 2]``; uniform and
   Zipf-hot addresses; all-padded rows, duplicate ids, (a)-passing rows
   that lose and still block), over batches whose every address the
   smem hash sends to one home bucket, and over ``global`` rounds at the
   range index's widths (``WIDE_CASES``: split and GC ops of 132-390
   words among narrow ones, up to 65 rows, rows sharing words, repeated
   ids within a row, random desired values); ``reserve_slots``' corner cases
   on both routes and ``sequential_oracle`` containment, and the service
   on the card against the service on the CPU; then the flash op against
   its plain version over ``FA_CHECK_CASES`` in f32 (2e-5) and bf16
   (2e-2, and ``FA_ROW_TOL`` per row), each call on the route the plan
   gives it (``tc``, ``decode`` or ``simt``), and two small serves
   (llama3-8b smoke config: f32 within 1e-3, and bf16 at head_dim 128,
   which runs the ``tc`` and ``decode`` routes, within
   ``SERVE_BF16_TOL``) on the card against the CPU;
3. the KV slice at full size — ``KVService(n_shards=4, round_cap=1024)``
   with 1,048,576 records (4 x 1,048,576-word tables on the card, the
   rows of one persistent ``[4, W]`` tensor), loaded, then driven by
   YCSB core workload A (50% read, 50% update, Zipfian 0.99) from 8
   clients in bounded windows; integrity, the acknowledged writes read
   back, ``conflict_rate == 0``, every wave one launch on the ``smem``
   route, and the tables still rows of that tensor are checked;
4. PMwCAS timings — the device time per wave of a profiled window by op
   name (the dispatch's kernel, upload and verdict copy; the rest), the
   kernel's time per launch on both routes and the plain version's at
   the slice's shape beside the byte bound and the latency floor (an
   empty launch plus three dependent 4-byte loads), the per-wave host
   split of a traced window, ops/s and p50/p99 latency;
5. the LM serve slice at full width — ``repro_torch.launch.serve.serve``
   on llama3-8b (32 layers, bf16 weights drawn on the card from the
   seed, ``attn_impl="pallas"``): 128 proposed requests of 2048 prompt
   tokens and 32 greedy decode steps, KV pages of 256 tokens out of 1024;
   admission equals the plain ``reserve_slots``, logits are finite, and
   the flash op runs exactly 32 x (1 + 32) times on the path: 32 on the
   ``tc`` route (prefill), 1,024 on the ``decode`` route;
6. flash timings — kernel against plain at the slice's prefill and
   decode shapes in f32 (2e-5) and bf16 (2e-2 and ``FA_ROW_TOL`` per
   row), faults planted in the plain version's inputs read above the row
   limit, the route and split count, the stream time per call (CUDA
   events) of the kernel, the plain version and SDPA beside the bound and
   the achieved TFLOP/s or TB/s, at the decode shape also their device
   time from replayed CUDA graphs (kernel and SDPA in turns); then
   one prefill and a window of decode steps profiled: the device idle
   share, the device time by kernel group (flash, matrix products, the
   rest), and the flash time per prefill launch in the model against
   alone;
7. the durable slice (the paper's persistence; host code over a
   ``PMemPool`` per shard in the temporary directory, on the machine's
   disk; its filesystem is printed) — ``run_differential`` holds the
   simulator kernel, the PMwCAS kernel and the durable committer against
   each other on seeded increment batches ``[B, K]`` of ``DIFF_SHAPES``
   (both routes, one simulator launch a batch; counts zeroed before,
   read after);
   YCSB-A (50% read, 50% update, Zipfian 0.99) from 8 clients over 4
   durable hash-map shards of 1,024 records with group commit, epochs of
   4 rounds, a checkpoint every 4 epochs and a WAL prune every 16 waves:
   integrity, the acknowledged writes read back, no held ack left,
   ``redundant_fences == 0`` and the WAL under its cap, then again after
   ``crash()``, and once more after a crash with an epoch open; ops/s,
   p50/p99, the persist share, flushes and fences per commit, recovery
   ms, the per-wave host split and the filesystem; last, the reference
   bench's window for the per-op protocol, group commit and the marker
   baseline (flushes per commit, fences);
8. the range index — ``KVService(n_shards=4, structure="bztree",
   leaf_cap=64, root_cap=64, round_cap=1024)`` on kernel shards
   (``TREE_RECORDS`` records, ``n_regions`` a sixteenth of a shard's),
   loaded and then driven by YCSB core workload E (95% scan, 5% insert,
   Zipfian 0.99) from 8 closed-loop clients with 4,096 ops outstanding;
   integrity, the acknowledged inserts read back, scans equal to a
   sorted count of the acknowledged keys, ``conflict_rate == 0``, height
   3 on every shard, launches by route equal to what the code issues
   (every wave ``smem``; every split one ``global`` wide op and three
   ``smem`` launches), then ``gc_regions`` (one ``global`` and one
   ``smem`` launch a freed region) and integrity again; ops/s, p50/p99,
   splits, the per-wave host split and the device idle share of the load
   and the run; the ``global`` route at the tree's widths (132, 390)
   against the plain version with its time; ``run_struct_differential``
   (bztree) on the card against durable shards, its rounds replayed on a
   CPU ``KernelBackend`` and on the simulator kernel (one launch a
   checked round, counted here), and its table equal to a CPU tree's; and the
   raw-op ``BatchScheduler`` on 4 card shards against 4 CPU shards;
9. the cycle-accurate simulator (``csrc/pmwcas_sim.cu``, many
   simulations a launch, on two routes: ``smem``, the state in shared
   memory, and ``global``, in device memory) — (a) the kernel on each
   route against its plain version bit for bit on the whole state, the
   four algorithms over ``SIM_CASES`` (drained and cut) in one mixed
   launch, and alone == batched; (b) every crash point 1-399 of
   ``test_crash_exhaustive_prefix``'s schedule for the four algorithms in
   one launch a route, each recovering consistently and held to the plain
   version, and the pinned ORIGINAL crash (seed 8016, step 365) on each
   route and raising the reference's RecoveryError through
   ``SimSession.crash_at`` on the card; ``SimBackend``'s mode on each
   route against the plain version (outputs and state, the attempt-cap
   exits too), and a round too wide for shared memory on ``global`` by
   the plan; (c) ``run_struct_differential(hashmap, algorithm="ours")``
   with every round replayed on the simulator kernel; (d) the Figs. 9-10
   grid (``benchmarks/bench_threads.py``: 84 drained cells at 1,000,000
   words, 60,000 steps, ``max_ops`` 512, seed 11) in ONE launch a route:
   modeled Mops at 2 GHz, CAS / flush / invalidations per op and p99 per
   cell, the zero-conflict CAS counts at one thread, the ours/original
   ratio at t = 56, alpha = 1, four full-size cells held to the plain
   version (its time per step extrapolated to the grid) and each route
   held to them, the five slowest cells of each route (their own
   nanoseconds from the kernel), the grid's latency bound beside its
   bytes bound, and one cell alone on each route for the time per step
   beside the latency floor;
10. chaos (``repro_torch.chaos``) — (a) ``default_scenarios(seed, 60)``
   with ``device="cuda"`` under the span tracer: the six durable
   families at 60 waves and ``sim_native`` at 30, at the families' own
   sizes (32 keys, 2-3 shards, 6 clients, ``round_cap`` 8), the pools in
   the temporary directory, with ``benchmarks/bench_chaos.py``'s
   assertions as checks (every history linearizable, at least 2 crashes,
   WAL records pruned and fewer than the ops, every SLO block valid and
   evaluated, every crash a ``chaos.fault`` instant) and one real
   history tampered and rejected; (b) ``hot_key_storm`` on kernel
   shards with only its shard storm: card == CPU (trace, items,
   integers, checker), every launch on the ``smem`` route, one a
   dispatch; (c) ``sim_native``: card == CPU, one simulator launch a
   shard round; one line a family (ops/s, p99, waves, ops, crashes,
   faults, checker counts, SLO verdict, WAL records/pruned, wall s) and
   the device busy share of (b) and (c) (device time from a profiled
   rerun over the wall time of the unprofiled run);
11. training (``TrainModel.train_loss``, ``optim.adamw``, the
   ``Trainer``) — (a) the flash kernel's training launch, which also
   writes the rows' log-sum-exp, against its plain version over
   ``FA_CHECK_CASES`` and the cell's training shape in f32 and bf16,
   every call on ``tc`` or ``simt`` (never ``decode``), ``out`` to
   phase 2's limits and ``lse`` to ``FA_LSE_TOL``, and each serving
   launch (a null lse pointer) on the same route equal to it bit for
   bit; (b) the llama3-8b smoke config trained on the card and on the
   CPU from the same f32 masters, in f32 (``simt``) and bf16 at head_dim
   128 (``tc``), the loss and every gradient held to ``SMALL_TOL``,
   limits that planted faults in the CPU's attention backward (the lse
   off by log 2, ``delta`` dropped) exceed; (c) the cell
   ``train_llama3_8b_L8_s4096`` (llama3-8b's widths at 8 layers, f32
   masters drawn on the card, bf16 compute, batch 2 x 4,096 tokens,
   remat, AdamW with clipping): one warm-up and 4 timed steps, exactly
   80 flash launches all on ``tc``, finite losses, every master changed;
   step ms, tokens/s, MFU, peak memory, a profiled step's device split
   (flash forward, attention backward, matrix products, cross-entropy,
   AdamW, the rest) and idle share; the flash op at the training shape
   with and without the log-sum-exp, its plain version, the port's plain
   backward and SDPA forward and backward; (d) ``Trainer`` at the smoke
   config crashed at step 24 of 40 (checkpoints every 10, in the
   temporary directory) and restarted: the restore equals what the
   step-20 save committed, bit for bit, the resumed run's final params
   are held to an uninterrupted run's, and an async-checkpointed run
   restores at step 40;
12. the MoE sublayer (``models/moe.py``; granite-moe-3b-a800m) — (a)
   ``moe.route`` on the card against the CPU on the same float32
   probabilities over ``MOE_ROUTE_CASES`` (exact ties, capacity factors
   0.05 / 1.25 / 8, groups 1 / 2, up to the serve cell's 26,624 tokens x
   top-8 of 40): expert ids, capacity ranks, kept slots and counts equal,
   gate values within 1e-6; ``apply_moe`` and ``apply_moe_dense`` card
   against CPU in f32 and bf16 (the card on the CPU's routing,
   ``routing_record``) within ``MOE_APPLY_TOL``, which the planted faults
   (the tie order reversed, capacity ranks one too high) exceed; (b) the
   granite-moe smoke config served (f32; bf16 at head_dim 64 on ``tc`` +
   ``decode``) and trained (f32, bf16) card against CPU, with the MoE
   faults beside phase 11's planted in the CPU's training, and qwen1.5's
   bf16 smoke serve at head_dim 128 with every flash call on ``tc`` or
   ``decode`` (its QKV biases held in bf16); (c) ``serve_granite_moe_3b``:
   phase 5's traffic on granite-moe-3b-a800m at its published size
   (admission equal to the plain version's, 32 ``tc`` + 1,024 ``decode``
   launches, the MoE capacity path at every prefill layer and the dense
   path at every decode layer, the share dropped at capacity), phase 6's
   flash checks and timings at its head_dim-64 shapes, and a profiled
   prefill and decode window split into flash, expert products, MoE
   dispatch, other products and the rest; (d)
   ``train_granite_moe_3b_s4096``: phase 11 (c)'s cell at granite's
   published size (320 ``tc`` launches with the log-sum-exp, every
   master changed, the aux term logged beside the cross-entropy, MFU
   over the router and the top-8 experts a token takes) and the flash op
   at the head_dim-64 training shape;
13. the xLSTM and Mamba sublayers (``models/xlstm.py``,
   ``models/ssm.py``; xlstm-125m, jamba-v0.1) — (a) ``apply_mlstm``
   (chunkwise, a decode step from its state, sequential) and
   ``apply_slstm`` (from its init state, and from a state its
   normalizer floor binds from) at xlstm-125m's widths, ``apply_mamba``
   (a 300-token prefill from a state, two decode steps) at jamba's, on
   the card against the CPU in f32 and bf16 within ``BLOCK_TOL``, which
   the planted faults (mLSTM's forget-gate bias lost, and in f32 on
   strong input gates its stabilizer without the running maximum;
   sLSTM's floor removed; Mamba's conv state read one step off) exceed;
   (b) the xlstm-125m and jamba smoke configs served (f32; bf16, jamba's
   attention at head_dim 128 on ``tc`` + ``decode``, its MoE on the CPU's
   routing) and trained (xlstm f32 and bf16, jamba f32) card against
   CPU, each recurrent block's fault beside phases 11-12's planted in the
   CPU's training; (c) ``serve_xlstm_125m``: phase 5's traffic on
   xlstm-125m at its published size (admission equal to the plain
   version's, no flash launch, the chunkwise mLSTM at prefill and the
   sequential one at decode) with a profiled prefill and decode window
   split by block; (d) ``train_xlstm_125m_s4096``: phase 11 (c)'s cell on
   xlstm-125m at its published size with one timed step
   (``XLSTM_TRAIN_TIMED``; the warm-up step profiled; the AdamW
   schedule of every training cell;
   no flash launch; MFU over the blocks' projections and the head); (e) ``serve_jamba_v01_L16``: phase
   5's traffic on jamba-v0.1 at its published width cut to 16 layers (2
   ``tc`` + 64 ``decode`` flash launches, the MoE paths), the flash op at
   its head_dim-128, g = 4 shapes, and the split by Mamba, MoE, flash,
   other products and the rest;
14. encoder-decoder stacks, cross-attention and the frontends
   (seamless-m4t-medium, paligemma-3b) — (a) the flash op at every call
   form of the three cells, at full size (``encdec_flash_shapes``: the
   encoder and the cross-attention's prefill non-causal at hd 64, the
   decoder's self prefill over the 3,104-key cache, both decode rows,
   paligemma's MQA at hd 256 with g = 8, seamless's training launches
   with the log-sum-exp), kernel against plain in f32 (2e-5) and bf16
   (2e-2, ``FA_ROW_TOL`` per row) on the route the plan gives, planted
   faults (a causal mask on a non-causal call; the last visible key
   tile dropped) read above the row limit, and the kernel's, the plain
   version's and SDPA's times beside the bound; (b) the seamless and
   paligemma smoke configs served (f32; bf16 at hd 64 / 256 on ``tc`` +
   ``decode``) and trained (f32, bf16) card against CPU, with phase 11's
   faults and seamless's cross-attention made causal planted in the
   CPU's training; (c) ``serve_seamless_m4t_medium``: phase 5's traffic
   at its published size with 1,024 frame embeddings a request (the
   reference launcher's ``0.02 * ones``): admission equal to the plain
   version's, 36 ``tc`` + 768 ``decode`` launches, the cross K/V once a
   unit at the prefill, and a profiled prefill and decode window split
   into the encoder's, the decoder's and the cross-attention's flash
   time, the matrix products and the rest; (d) ``serve_paligemma_3b``:
   the same with a 256-embedding vision prefix (18 ``tc`` + 576
   ``decode``); (e) ``train_seamless_m4t_medium_s4096``: phase 11 (c)'s
   cell at seamless's published size with seeded frames (360 ``tc``
   launches with the log-sum-exp, every master changed, MFU over the
   frames' and the tokens' products); each form's flash launches in
   the three cells counted on their paths (``launches_by_form``) and
   held to what (a)'s shape list expects;
15. the int8 KV cache (``models/attention.py``: ``_quant``,
   ``cache_update``, ``_sdpa_chunked_quant``; qwen1.5-32b) -- (a)
   ``_quant`` card against CPU bit for bit on every bf16 magnitude from
   0x3a80 to 0x4480 of either sign (the 420 rows whose ``max|x| /
   scale`` is 127.5 saturate to 127, or stay -128) and on random keys in
   bf16 and f32, and ``_sdpa_chunked_quant`` card against CPU on the
   same int8 cache at the cells' forms (``INT8_ATTN_CASES``: qwen's
   decode in one chunk and in padded chunks, its prefill cut, llama3's
   GQA decode, a window with a softcap) within ``INT8_ATTN_TOL``, with
   planted faults on the CPU's side read above every limit (the cast
   without its clamp, one int8 value flipped); (b) the llama3-8b and
   qwen1.5-32b smoke configs served with an int8 cache card against CPU
   (f32 within 1e-3, bf16 within ``SERVE_BF16_TOL``; no flash launch),
   the same faults planted in the CPU's serve read above the limits; (c)
   phase 5's cell with a bf16 and with an int8 cache (llama3-8b, the
   same seed): cache bytes, prefill s, decode ms a step, the prefill
   logits' correlation and the greedy tokens' agreement, no flash launch
   with int8; (d) ``serve_qwen15_32b_int8``: qwen1.5-32b at its
   published width and depth with the cache ``cell_model_config`` picks
   for its decode cells (int8), phase 5's traffic on ``INT8_REQUESTS``
   proposed requests (admission equal to the plain version's, one
   ``smem`` launch, no flash launch, finite logits), the memory reckoned
   beside the measured peaks, and a profiled prefill and decode window
   split into the int8 attention, the matrix products and the rest;
16. sharding rules, cell programs and the dry run
   (``parallel/sharding.py``, ``launch/{mesh,steps,dryrun}.py``) -- (a)
   ``dryrun.run_cell`` for every arch x ``shapes_for`` cell on the two
   production meshes (32 x 8 and 2 x 32 x 8 H100s) and the host mesh:
   every spec divides, one line a cell with its per-device argument GB
   and whether it fits the card (jamba-v0.1 at 32 layers does not); (b)
   ``prefill_32k_llama3_8b_B1``: llama3-8b at its published size through
   ``build_cell(cfg, prefill_32k at batch 1, one_card_mesh())``, the
   weights and the 32,768-position cache the card holds equal to the dry
   run's per-device argument bytes, one prefill with 32 ``tc`` launches;
   (c) ``decode_32k_llama3_8b_B8``: the same weights through
   ``build_cell`` at ``decode_32k`` with 8 requests, the 34.36 GB cache
   filled with seeded random bf16 K/V and its index at 32,767, the bytes
   again equal to the dry run's, one step with 32 ``decode`` launches
   whose logits equal ``Model.decode_step``'s bit for bit, the step
   timed against its byte bound; the flash call of each cell (q ``[32,
   32768, 128]`` x k/v ``[8, 32768, 128]``; q ``[256, 1, 128]`` x k/v
   ``[64, 32768, 128]``) against its plain version (at prefill the last
   256 rows against every key) with planted faults above the row limit,
   timed beside its bound and SDPA;
17. one cell across the cards of a mesh (``parallel/{group,collectives}.py``,
   ``CellProgram.materialize(group=...)``) -- (a) phase 16 (c)'s cell
   through a one-rank NCCL group on its weights, filled cache and token:
   the bytes the dry run's, logits equal to (c)'s bit for bit, 32
   ``decode`` launches, no collective; (b) on a host of four or more
   cards, four processes, one a card, run ``MESH_CELLS``:
   ``prefill_32k_llama3_8b_B32_4x1`` (32 prompts of 32,768 tokens, FSDP
   and the batch over ``data``) and ``decode_32k_llama3_8b_B32_1x4`` (32
   requests over a 32,768-position cache of seeded bf16, heads over
   ``model``): each rank's bytes the dry run's and its collectives the
   trace's, every flash launch on the route the plan gives, the prefill's
   seconds and the decode step's ms (median of 5) with the time in the
   collectives, rank 0's logits against one card's ``Model.prefill`` /
   ``decode_step`` on the gathered weights (and cache), the prefill bit
   for bit, the decode's distance from the f32 step within 1.5 times one
   card's (``MESH_F32_FACTOR``) and from one card within twice it, which
   the planted faults (a rank's query heads rolled; the all-reduce after
   ``wo`` skipped) exceed, each rank's flash call timed beside SDPA
   (``scripts/mesh_cell.py`` runs (b) alone);
18. jamba-v0.1 across four cards (experts and Mamba's inner channels over
   the model axis) -- (a) on any host: each four-card cell's flash call
   on one card (``JAMBA_FLASH``: q ``[1024, 1, 128]`` x k/v ``[256,
   32768, 128]`` on ``decode`` at 1 split; q ``[8, 1, 128]`` x k/v ``[2,
   524288, 128]`` on ``decode`` at 66; q ``[64, 32768, 128]`` x k/v
   ``[16, 32768, 128]`` causal on ``tc``) against its plain version with
   planted faults, timed beside bound and SDPA; one jamba unit (8
   layers at published widths) through a one-rank NCCL group, its
   logits equal to ``Model.decode_step``'s bit for bit; (b) on a host of
   four or more cards, four processes run ``JAMBA_CELLS`` at jamba's 32
   layers on ``(1, 4)``: ``decode_32k_jamba_v01_52b_B128_1x4``,
   ``long_500k_jamba_v01_52b_B1_1x4`` and
   ``prefill_32k_jamba_v01_52b_B8_1x4``, each rank's weights drawn one
   parameter at a time and cut: its bytes the table's, its collectives
   the trace's, every flash launch on the table's route, the time
   against the cell's bound; then each cell at one unit, rank 0 against
   one card's step in bf16 and f32 (phase 17's gate), which the planted
   faults (an expert slice, Mamba's ``out_proj`` all-reduce skipped,
   ``in_proj`` cut plainly) exceed (``scripts/mesh_cell.py`` runs (b)
   alone, after phase 17 (b)).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``{"kernels": [...]}`` record, and the line before that the
decode shape's numbers.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA's H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor cores, same sheet
N_SHARDS, ROUND_CAP, N_CLIENTS = 4, 1024, 8
RECORDS, OPS = 1 << 20, 1 << 16      # YCSB-A recordcount, operationcount


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def _batch(rng, S, B, K, W, hot, words_np):
    """One seeded [S, B, K] batch against ``words_np [S, W]``: expected
    values mostly current (so rows pass (a)), some stale (rows fail (a)),
    ~10% padded slots, a few all-padded rows and duplicate ids."""
    if hot:
        ranks = np.arange(1, W + 1, dtype=np.float64) ** -0.99
        addr = rng.choice(W, size=(S, B, K), p=ranks / ranks.sum())
    else:
        addr = rng.integers(0, W, size=(S, B, K))
    addr = addr.astype(np.int32)
    addr[rng.random((S, B, K)) < 0.1] = -1
    addr[:, rng.random(B) < 0.05, :] = -1                 # all-padded rows
    if K > 1:
        dup = rng.random((S, B)) < 0.05
        addr[..., 1][dup] = addr[..., 0][dup]             # duplicate ids
    cur = np.take_along_axis(words_np, np.maximum(addr, 0).reshape(S, -1),
                             1).reshape(S, B, K)
    exp = np.where(rng.random((S, B, K)) < 0.05, cur + 1, cur)
    des = rng.integers(0, 1 << 32, size=(S, B, K), dtype=np.uint64)
    return addr, exp.astype(np.uint32), des.astype(np.uint32)


def _colliding(kernel, rng, S, B, K, W):
    """A batch whose addresses the smem route's tag table (and so its
    hash too) sends to bucket 0, shared between rows and duplicated
    within some, expected values mostly current, against seeded ``[S, W]``
    words: every passing slot is contested and probes the whole cluster."""
    pool = np.flatnonzero(kernel.hash_bucket(
        np.arange(W), kernel.table_bits(B, K)[0]) == 0)
    words_np = np.zeros((S, W), np.uint32)
    words_np[:, pool] = rng.integers(0, 1 << 32, size=(S, len(pool)),
                                     dtype=np.uint64).astype(np.uint32)
    addr = rng.choice(pool[:B * K // 2], size=(S, B, K)).astype(np.int32)
    addr[rng.random((S, B, K)) < 0.1] = -1
    cur = np.take_along_axis(words_np, np.maximum(addr, 0).reshape(S, -1),
                             1).reshape(S, B, K)
    exp = np.where(rng.random((S, B, K)) < 0.05, cur + 1, cur)
    des = rng.integers(0, 1 << 32, size=(S, B, K), dtype=np.uint64)
    return words_np, addr, exp.astype(np.uint32), des.astype(np.uint32)


# [1, B, K] rounds of the range index's widths, padded to the widest: a
# leaf split's materialization (132-135 words at node caps of 64) and a
# GC op over a full region (390) among 1-3-word ops; up to 32 rows take
# the global route's one-thread-a-slot kernel, 65 rows its per-row one
WIDE_CASES = ((132, 3, 3, 390, 2), (390, 390, 135, 1), (132,) * 32,
              (3,) * 64 + (260,))


def _wide_batch(rng, W, widths, stale=0.2, share=0.3, dup=0.3):
    """One seeded ``[1, B, K]`` round of rows of ``widths`` against
    ``[1, W]`` words: live words, expected mostly current (a ``stale``
    share of rows fails (a)), desired random, a ``share`` of rows taking
    two words of earlier rows (so (a)-passing rows contend), and a
    ``dup`` share of rows repeating one id within the row (its
    expected value the same, its desired value its own)."""
    words = rng.integers(1, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    K = max(widths)
    addr = np.full((len(widths), K), -1, np.int32)
    taken = []
    for i, k in enumerate(widths):
        row = rng.choice(W, k, replace=False)
        if taken and rng.random() < share:
            row[:2] = rng.choice(np.concatenate(taken), 2, replace=False)
            row = np.unique(row)
            k = len(row)
        row = np.sort(row)
        if k > 1 and rng.random() < dup:
            row[-1] = row[0]
        addr[i, :k] = row
        taken.append(addr[i, :k])
    exp = words[np.maximum(addr, 0)]
    stale_rows = rng.random(len(widths)) < stale
    exp[stale_rows, 0] += 1
    des = rng.integers(0, 1 << 32, addr.shape,
                       dtype=np.uint64).astype(np.uint32)
    return words[None], addr[None], exp[None], des[None]


def _b_losers(pm, ref, dev, words_np, addr, exp, des) -> int:
    """Rows of one ``[1, B, K]`` round that pass (a) (every live slot's
    expected value current) and still lose, by the plain version."""
    live = addr[0] >= 0
    cur = words_np[0][np.maximum(addr[0], 0)]
    passes = ((cur == exp[0]) | ~live).all(1) & live.any(1)
    w = pm.words_to_tensor(words_np, dev)
    _, s = ref.pmwcas_apply_stacked(
        w, *[pm.words_to_tensor(a, dev) for a in (addr, exp, des)])
    return int((passes & ~s[0].cpu().numpy()).sum())


def _held(pm, ref, kernel, dev, words_np, addr, exp, des, route,
          what) -> int:
    """One launch on ``route`` against the plain version on the same
    inputs; returns the largest difference (must be 0)."""
    args = [pm.words_to_tensor(a, dev) for a in (addr, exp, des)]
    w_k = pm.words_to_tensor(words_np, dev)
    w_p = w_k.clone()
    s_k = kernel.pmwcas_apply_cuda(w_k, *args, route=route)
    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
    _sync(dev)
    diff = max(int((s_k.int() - s_p.int()).abs().max()),
               int((w_k.long() - w_p.long()).abs().max()))
    check(diff == 0, f"kernel != plain on the {route} route at {what}")
    B = addr.shape[1]
    check(bool(s_k.all(dim=1).logical_not().any()) or B < 1024,
          f"no loser on the {route} route at {what}")
    check(bool(s_k.any(dim=1).all()) or B < 1024,
          f"no winner on the {route} route at {what}")
    return diff


def kernel_vs_plain(pm, ref, kernel, seed: int, dev) -> int:
    """Bit-for-bit comparisons on ``dev``, every case on both routes (the
    smem route only where its hash fits); returns the largest absolute
    difference seen (must be 0)."""
    rng = np.random.default_rng(seed)
    worst = 0
    n_cases = dict.fromkeys(kernel.ROUTES, 0)
    shapes = [(S, B, K) for S in (1, 4) for B in (1, 7, 1024)
              for K in (1, 2, 8)] + [(1, 128, 9), (2, 512, 8), (1, 256, 16),
                                     (2, 4500, 2)]
    for S, B, K in shapes:
        for hot in (False, True):
            W = 4096 if hot else 1 << 20
            words_np = rng.integers(0, 1 << 32, size=(S, W),
                                    dtype=np.uint64).astype(np.uint32)
            addr, exp, des = _batch(rng, S, B, K, W, hot, words_np)
            for route in kernel.ROUTES:
                if route == "smem" and kernel.plan(B, K)[0] != "smem":
                    continue
                worst = max(worst, _held(
                    pm, ref, kernel, dev, words_np, addr, exp, des, route,
                    f"S={S} B={B} K={K} hot={hot}"))
                n_cases[route] += 1
    for S, B, K in ((4, 1024, 2), (1, 128, 9), (1, 512, 8)):
        batch = _colliding(kernel, rng, S, B, K, 1 << 25)
        for route in kernel.ROUTES:
            worst = max(worst, _held(pm, ref, kernel, dev, *batch, route,
                                     f"S={S} B={B} K={K}, one home bucket"))
            n_cases[route] += 1
    b_losers = 0
    for widths in WIDE_CASES:
        words_np, addr, exp, des = _wide_batch(rng, 1 << 16, widths)
        check(kernel.plan(*addr.shape[1:])[0] == "global",
              f"{len(widths)} rows of up to {max(widths)} words: plan")
        worst = max(worst, _held(pm, ref, kernel, dev, words_np, addr, exp,
                                 des, "global",
                                 f"{len(widths)} rows of up to "
                                 f"{max(widths)} words"))
        n_cases["global"] += 1
        b_losers += _b_losers(pm, ref, dev, words_np, addr, exp, des)
    check(b_losers > 0, "no (a)-passing row lost a claim in the wide cases")
    log(f"phase 2: kernel == plain bit for bit on {json.dumps(n_cases)} "
        "[S, B, K] batches by route (uniform, Zipf-hot, every address in "
        "one home bucket of the smem hash, the range index's wide rounds: "
        f"{b_losers} (a)-passing rows lost a claim there)")

    # (a)-passing rows that lose still block: rows 0,1 pass, 1 loses to 0
    # on word 3, and row 2 (disjoint from 0) loses to row 1
    addr = np.asarray([[[0, 3], [3, 4], [4, 5], [6, 7]]], np.int32)
    exp = np.zeros_like(addr, dtype=np.uint32)
    exp[0, 3, 1] = 9                                      # row 3 fails (a)
    des = np.ones_like(addr, dtype=np.uint32)
    for route in kernel.ROUTES:
        words = pm.words_to_tensor(np.zeros((1, 16), np.uint32), dev)
        s = kernel.pmwcas_apply_cuda(
            words, *[pm.words_to_tensor(a, dev) for a in (addr, exp, des)],
            route=route)
        check(s.cpu().tolist() == [[True, False, False, False]],
              f"blocking semantics broken on {route}: {s.cpu().tolist()}")

    # reserve_slots' corner cases (tests/test_kernels.py), kernel == plain
    # == the expected verdicts
    cases = [
        ([[3, 3, 5, -1]], None, [True]),                  # duplicate ids
        ([[-1, -1, -1], [0, 1, -1]], None, [True, True]),  # all-padded
        ([[0, 1, 2, 3], [3, 4, 5, 6], [7, 8, 9, 10], [4, 5, 11, 12]], None,
         [True, False, True, False]),                    # lower index wins
        ([[1, 2, -1]], 2, [False]),                       # already claimed
    ]
    for (reqs, taken, want), route in itertools.product(cases,
                                                        kernel.ROUTES):
        free = np.ones(16, np.uint32)
        if taken is not None:
            free[taken] = 0
        reqs = np.asarray(reqs, np.int32)
        m_k = pm.words_to_tensor(free, dev)
        m_p = m_k.clone()
        r = pm.words_to_tensor(reqs, dev)
        g_k = kernel.pmwcas_apply_cuda(m_k[None], r[None],
                                       torch.ones_like(r)[None],
                                       torch.zeros_like(r)[None],
                                       route=route)[0]
        _, g_p = ref.pmwcas_apply(m_p, r, torch.ones_like(r),
                                  torch.zeros_like(r))
        check(g_k.cpu().tolist() == g_p.cpu().tolist() == want,
              f"reserve_slots {reqs.tolist()} on {route}: "
              f"{g_k.cpu().tolist()}")
        check(torch.equal(m_k, m_p),
              f"reserve_slots mask {reqs.tolist()} on {route}")
        if route == kernel.plan(*reqs.shape)[0]:    # the op on its route
            m_r = pm.words_to_tensor(free, dev)
            _, g_r = pm.reserve_slots(m_r, r)
            check(torch.equal(g_r, g_k) and torch.equal(m_r, m_k),
                  f"reserve_slots {reqs.tolist()} != its kernel launch")
    log("phase 2: reserve_slots corner cases agree on both routes (kernel "
        "== plain == expected)")

    # sequential_oracle containment at contention
    for seed2 in range(8):
        r2 = np.random.default_rng(seed + 100 + seed2)
        W, B, K = 64, 40, 4
        words_np = r2.integers(0, 4, W).astype(np.uint32)
        addr = np.sort(np.stack([r2.choice(W, K, replace=False)
                                 for _ in range(B)]), 1).astype(np.int32)
        addr[r2.random((B, K)) < 0.1] = -1
        exp = r2.integers(0, 4, (B, K)).astype(np.uint32)
        des = exp + 1
        w = pm.words_to_tensor(words_np, dev)
        _, succ = pm.pmwcas_apply(w, *[pm.words_to_tensor(a, dev)
                                       for a in (addr, exp, des)])
        succ = succ.cpu().numpy()
        seq_words, seq = ref.sequential_oracle(words_np, addr, exp, des)
        check((~succ | seq).all(), "kernel success outside the oracle's")
        new = pm.tensor_to_words(w)
        for i in np.flatnonzero(succ):
            for a in addr[i][addr[i] >= 0]:
                check(new[a] == seq_words[a], "winner write differs from "
                      "the sequential oracle")
    log("phase 2: sequential_oracle containment holds")
    return worst


def small_service_matches_cpu(svc_mod, st, seed: int, dev) -> None:
    """The service on the card against the service on the CPU (the plain
    version) on the same small seeded workload: same verdicts, same
    final tables."""
    spec = st.WorkloadSpec(n_ops=512, n_keys=200, read=0.5, update=0.5,
                           insert=0.0, delete=0.0, alpha=0.99, seed=seed)
    outs = []
    for device in (dev, "cpu"):
        svc = svc_mod.KVService(4, n_buckets=128, round_cap=16,
                                device=device)
        futs = svc.submit_many(st.load_phase(spec, 1.0))
        for c, stream in enumerate(st.client_streams(spec, N_CLIENTS)):
            futs += [svc.submit(op, client=c) for op in stream]
        svc.drain()
        outs.append(([(f.status, f.result.value, f.done_step) for f in futs],
                     [b.values().tolist() for b in svc.backends]))
    check(outs[0] == outs[1], "service on the card != service on the CPU")
    log("phase 2: small KVService on the card == on the CPU")


# ---------------------------------------------------------------------------
# phase 3: the slice at full size
# ---------------------------------------------------------------------------

def _arrivals(streams):
    """Per-client streams interleaved round-robin into one arrival order."""
    return [(c, s[i]) for i in range(max(map(len, streams)))
            for c, s in enumerate(streams) if i < len(s)]


def drive(svc, arrivals, window: int, on_step=None):
    """Bounded-window clients: about ``window`` submissions per wave, then
    drain.  Returns the futures in submission order."""
    futs = []
    for start in range(0, len(arrivals), window):
        futs += [svc.submit(op, client=c)
                 for c, op in arrivals[start:start + window]]
        svc.step()
        if on_step:
            on_step()
    while svc.pending_count:
        svc.step()
        if on_step:
            on_step()
    return futs


def acked_state(st, state, futures):
    """Apply every acknowledged insert/update/delete of one measurement
    window to ``state`` in decision order (deciding wave, then submission
    order); windows are replayed in the order they ran, because
    ``reset_stats`` restarts the wave count."""
    for f in sorted(futures, key=lambda f: (f.done_step, f.seq)):
        if f.status != st.OK:
            continue
        if f.op.kind in (st.INSERT, st.UPDATE):
            state[f.op.key] = f.op.value
        elif f.op.kind == st.DELETE:
            state.pop(f.op.key, None)
    return state


class WaveSplit:
    """Per-wave host time by phase, read from the span tracer after each
    wave (the buffer is cleared every wave, so it never drops)."""
    NAMES = ("wave.snapshot", "wave.grow", "wave.compile", "wave.schedule",
             "wave.dispatch", "wave.complete", "service.wave")

    def __init__(self, tracer):
        self.tracer = tracer
        self.total_us = dict.fromkeys(self.NAMES, 0.0)
        self.waves = 0

    def __call__(self):
        for ev in self.tracer.events():
            if ev["ph"] == "X" and ev["name"] in self.total_us:
                self.total_us[ev["name"]] += ev["dur"]
        self.tracer.clear()
        self.waves += 1

    def per_wave_us(self):
        t = {k: v / max(self.waves, 1) for k, v in self.total_us.items()}
        return {"snapshot": t["wave.snapshot"],
                "grow": t["wave.grow"],
                "compile": t["wave.compile"] - t["wave.snapshot"]
                - t["wave.grow"],
                "schedule": t["wave.schedule"],
                "dispatch": t["wave.dispatch"],
                "complete": t["wave.complete"],
                "wave": t["service.wave"]}


def _table_storage(svc) -> int:
    """The address of the one ``[S, W]`` storage whose rows are the
    shards' word tables (checked), as the stacked dispatch binds them."""
    tables = [b.word_table() for b in svc.backends]
    base = tables[0].untyped_storage().data_ptr()
    for i, t in enumerate(tables):
        check(t.untyped_storage().data_ptr() == base
              and t.data_ptr() == base + i * t.numel() * 4,
              f"shard {i}'s table is not row {i} of one [S, W] tensor")
    return base


DISPATCH_OPS = {"kernel": ("pmwcas_apply",),
                "upload": ("Memcpy HtoD",),
                "verdict": ("Memcpy DtoH (Device -> Pinned)",)}


def wave_device_split(by_name: dict, count: dict, waves: int) -> dict:
    """Device µs per wave by op name over a profiled window of ``waves``
    service waves: the dispatch's own ops (the PMwCAS kernel, the packed
    upload, the verdict copy into pinned memory) and everything else
    (the snapshot's table copies to pageable memory among it)."""
    per = {k: 0.0 for k in (*DISPATCH_OPS, "rest")}
    for name, us in by_name.items():
        key = next((k for k, pats in DISPATCH_OPS.items()
                    if any(p in name for p in pats)), "rest")
        per[key] += us / max(waves, 1)
    per["dispatch"] = sum(per[k] for k in DISPATCH_OPS)
    log(f"phase 4: device us per wave over {waves} profiled waves "
        "(profiler, by op name): " + json.dumps(
            {k: round(v, 3) for k, v in per.items()}))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"phase 4:   {us / max(waves, 1):12.3f} us/wave  "
            f"{count[name] / max(waves, 1):6.2f}/wave  {name[:90]}")
    return per


def full_slice(pm, svc_mod, st, obs, kernel, dev, seed: int,
               records: int = RECORDS, ops: int = OPS):
    n_buckets = 2 * records // N_SHARDS
    window = ROUND_CAP * N_SHARDS
    spec = st.WorkloadSpec(n_ops=ops, n_keys=records, read=0.5,
                           update=0.5, insert=0.0, delete=0.0, alpha=0.99,
                           seed=seed)
    svc = svc_mod.KVService(N_SHARDS, structure="hashmap",
                            n_buckets=n_buckets, round_cap=ROUND_CAP,
                            device=dev)
    check(all(b.word_table().device.type == dev.type and b.n_words == 2 * n_buckets
              for b in svc.backends), "word tables are not on the card")
    log(f"phase 3: KVService(n_shards={N_SHARDS}, round_cap={ROUND_CAP}, "
        f"n_buckets={n_buckets}) -> {N_SHARDS} x {2 * n_buckets} words "
        f"({N_SHARDS * 2 * n_buckets * 4 / 2**20:.0f} MiB) on the card")

    t0 = time.perf_counter()
    load = st.load_phase(spec, fraction=1.0)
    load_futs = drive(svc, [(0, op) for op in load], window)
    _sync(dev)
    load_s = time.perf_counter() - t0
    check(all(f.status == st.OK for f in load_futs), "a load insert failed")
    log(f"phase 3: loaded {len(load)} records in {load_s:.3f} s "
        f"({svc.stats.steps} waves)")

    arrivals = _arrivals(st.client_streams(spec, N_CLIENTS))
    svc.reset_stats()
    # percentiles over every op of the run, not the default recent window
    svc.stats.latency_us.window = len(arrivals)
    table = _table_storage(svc)
    kernel.reset_counts()                     # count the main path only
    t0 = time.perf_counter()
    run_futs = drive(svc, arrivals, window)
    _sync(dev)
    run_s = time.perf_counter() - t0
    launches = kernel.pmwcas_apply_cuda.launches
    routes = dict(kernel.pmwcas_apply_cuda.route_launches)
    stats = svc.stats
    dispatch = stats.dispatch
    log(f"phase 3: YCSB-A {len(arrivals)} ops from {N_CLIENTS} clients in "
        f"{run_s:.3f} s: {len(arrivals) / run_s:.1f} ops/s, "
        f"{stats.steps} waves, p50 {stats.p50_latency_us:.1f} us, "
        f"p99 {stats.p99_latency_us:.1f} us")
    log("phase 3: stats " + json.dumps(stats.as_row()))

    check(all(f.done for f in run_futs), "a future is still pending")
    check(stats.by_status.get(st.EXHAUSTED, 0) == 0, "ops exhausted")
    check(stats.conflict_rate == 0.0,
          f"conflict_rate {stats.conflict_rate} != 0")
    items = svc.check_integrity()
    check(items == svc.items(), "check_integrity disagrees with items()")
    check(items == acked_state(st, acked_state(st, {}, load_futs),
                               run_futs),
          "acknowledged writes do not read back")
    check(len(items) == records, f"{len(items)} live keys != {records}")
    check(launches > 0 and launches == dispatch.dispatches
          + dispatch.serial_rounds,
          f"kernel launches {launches} != dispatches {dispatch.dispatches}"
          f" + serial rounds {dispatch.serial_rounds}")
    check(routes == {"smem": launches, "global": 0},
          f"PMwCAS routes {routes}: every wave must take the smem route")
    check(_table_storage(svc) == table,
          "the shard tables moved off their persistent [S, W] tensor")
    log("phase 3: integrity ok, acknowledged writes read back, "
        "conflict_rate 0; every wave one smem launch on the shards' "
        "persistent [S, W] table")
    log("kernels: " + json.dumps({"pmwcas_apply": launches,
                                  "pmwcas_apply routes": routes}))

    # a second, traced window on the loaded map for the per-wave split
    split = WaveSplit(obs.get_tracer())
    obs.enable_tracing()
    try:
        traced = _arrivals(st.client_streams(
            dataclasses.replace(spec, n_ops=ops // 4, seed=seed + 1),
            N_CLIENTS))
        t0 = time.perf_counter()
        drive(svc, traced, window, on_step=split)
        traced_s = time.perf_counter() - t0
    finally:
        obs.disable_tracing()
        obs.get_tracer().clear()
    per_wave = split.per_wave_us()
    profiled = _arrivals(st.client_streams(
        dataclasses.replace(spec, n_ops=ops // 8, seed=seed + 2),
        N_CLIENTS))
    waves0 = svc.stats.steps
    by_name, count, wall_us = _profile(lambda: drive(svc, profiled,
                                                     window))
    waves = svc.stats.steps - waves0
    busy_us = sum(by_name.values()) or None
    log("phase 4: device busy " + ("not measured" if busy_us is None else
        f"{busy_us:.1f} us of {wall_us:.1f} us wall over {len(profiled)} "
        f"ops: idle share {1 - busy_us / wall_us:.4f} (profiler)"))
    wave_split = wave_device_split(by_name, count, waves)
    log(f"phase 4: per-wave host split over {split.waves} traced waves "
        f"({len(traced)} ops, {traced_s:.3f} s, tracing on), us/wave: "
        + json.dumps({k: round(v, 1) for k, v in per_wave.items()}))
    check(_table_storage(svc) == table, "the shard tables moved")
    svc.check_integrity()
    return dict(launches=launches, routes=routes,
                ops_per_s=len(arrivals) / run_s, load_s=load_s, run_s=run_s,
                stats=stats, svc=svc, wave_split=wave_split)


# ---------------------------------------------------------------------------
# phase 4: kernel timings at the slice's shape
# ---------------------------------------------------------------------------

def _event_ms(fn, iters: int) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn):
    """One call of ``fn`` under the profiler, from the CUDA activity
    trace: (device µs of every kernel, copy and fill it enqueued, by name;
    how many of each the trace shows; host wall µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            count[e.name] = count.get(e.name, 0) + 1
    return by_name, count, wall_us


def _device_us(fn, iters: int = 1):
    """Device time (µs) of ``iters`` calls of ``fn`` and their host wall
    time (µs); the device time is None when the trace shows none."""
    by_name, _, wall_us = _profile(lambda: [fn() for _ in range(iters)])
    busy = sum(by_name.values())
    return (busy if busy > 0 else None), wall_us


def _per_launch_us(fn, iters: int, match: str):
    """Device µs per launch of the kernels whose name holds ``match``,
    over ``iters`` calls of ``fn`` under the profiler (the mean over the
    launches the trace shows), and how many it shows; None if none."""
    by_name, count, _ = _profile(lambda: [fn() for _ in range(iters)])
    us = sum(v for k, v in by_name.items() if match in k)
    n = sum(v for k, v in count.items() if match in k)
    return (us / n if n else None), n


def kernel_timings(pm, ref, kernel, svc, seed: int, dev):
    """Kernel (both routes) and plain version per launch on an update
    wave of the slice's shape: 4 shards x 1024 rows x 2 slots against the
    loaded 4 x 1,048,576-word tables (each row a live bucket's key guard
    + value word, expected == current, desired == expected so every
    launch does the same full work); and the latency floor, an empty
    launch plus three dependent 4-byte loads."""
    rng = np.random.default_rng(seed + 7)
    words = torch.stack([b.word_table() for b in svc.backends]).clone()
    S, W = words.shape
    host = pm.tensor_to_words(words)
    addr = np.empty((S, ROUND_CAP, 2), np.int32)
    for s in range(S):
        live = np.flatnonzero(host[s, 0::2] != 0)
        buckets = rng.choice(live, ROUND_CAP, replace=False)
        addr[s, :, 0] = 2 * buckets
        addr[s, :, 1] = 2 * buckets + 1
    exp = np.take_along_axis(host, addr.reshape(S, -1), 1).reshape(addr.shape)
    a, e = (pm.words_to_tensor(x, dev) for x in (addr, exp))
    d = e.clone()
    claim = kernel.claim_scratch(words)
    success = torch.empty((S, ROUND_CAP), dtype=torch.bool, device=dev)
    w_k, w_p = words.clone(), words.clone()
    check(kernel.plan(ROUND_CAP, 2)[0] == "smem", "the wave's plan")
    _, s_p = ref.pmwcas_apply_stacked(w_p, a, e, d)
    for route in kernel.ROUTES:
        s_k = kernel.pmwcas_apply_cuda(w_k, a, e, d, route=route,
                                       claim=claim)
        torch.cuda.synchronize()
        check(bool(s_k.all()) and torch.equal(s_k, s_p)
              and torch.equal(w_k, w_p),
              f"timing inputs: kernel != plain on the {route} route")

    def run(route):
        return lambda: kernel.launch(w_k, a, e, d, success, route=route,
                                     claim=claim)

    def run_plain():
        ref.pmwcas_apply_stacked(w_p, a, e, d)

    # stream time of back-to-back calls (CUDA events), in turns
    plain_ms, smem_ms, global_ms, smem_ms2, global_ms2, plain_ms2 = (
        _event_ms(run_plain, 20), _event_ms(run("smem"), 500),
        _event_ms(run("global"), 500), _event_ms(run("smem"), 500),
        _event_ms(run("global"), 500), _event_ms(run_plain, 20))
    wrapper_ms = _event_ms(lambda: pm.pmwcas_apply_stacked(w_k, a, e, d),
                           200)
    # device time per launch (profiler): what the card itself spends; the
    # host's ctypes call would dominate the kernel's event time
    turns = [(r, _per_launch_us(run(r), 200, "pmwcas_apply")[0])
             for r in ("smem", "global", "global", "smem")]
    p_dev, _ = _device_us(run_plain, 20)
    # the latency floor: one thread, an empty launch, then three
    # dependent 4-byte loads through a random chain in a table's size
    chain = torch.randint(0, W, (W,), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev
                                                    ).manual_seed(seed))
    out = torch.empty(1, dtype=torch.int32, device=dev)
    probe = {t: _per_launch_us(
        lambda t=t: kernel.latency_probe(chain, out, t), 200, "latency")[0]
        for t in (0, 3)}
    smem_us = [u for r, u in turns if r == "smem" and u]
    global_us = [u for r, u in turns if r == "global" and u]
    ms = min(smem_us) / 1e3 if smem_us else min(smem_ms, smem_ms2)
    g_ms = min(global_us) / 1e3 if global_us else min(global_ms, global_ms2)
    plain = p_dev / 20 / 1e3 if p_dev else min(plain_ms, plain_ms2)
    src = "profiler device time" if smem_us and global_us and p_dev \
        else "CUDA events"
    floor_ms = probe[3] / 1e3 if probe[3] else None
    valid = int((addr >= 0).sum())
    winners = int((np.asarray(s_k.cpu())[..., None] & (addr >= 0)).sum())
    n_bytes = 3 * addr.size * 4 + valid * 4 + winners * 4 + S * ROUND_CAP
    bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
    log(f"phase 4: [S, B, K] = [{S}, {ROUND_CAP}, 2], W = {W}: smem route "
        f"{ms * 1e3:.3f} us/launch, global route {g_ms * 1e3:.3f} "
        f"us/launch, plain {plain * 1e3:.3f} us/call ({src}; per launch "
        f"in two profiled runs of 200, taken in turns: smem "
        f"{[round(x, 3) for x in smem_us]}, global "
        f"{[round(x, 3) for x in global_us]}); stream time back to back "
        f"(CUDA events): smem {smem_ms * 1e3:.2f} / {smem_ms2 * 1e3:.2f} "
        f"us, global {global_ms * 1e3:.2f} / {global_ms2 * 1e3:.2f} us, "
        f"checked wrapper {wrapper_ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} / {plain_ms2 * 1e3:.2f} us; bound "
        f"{bound_ms * 1e3:.4f} us ({n_bytes} bytes at "
        f"{H100_BYTES_PER_S:.3g} B/s); latency floor (profiler, one "
        f"thread): empty launch "
        + ("not measured" if probe[0] is None else f"{probe[0]:.3f} us")
        + ", plus three dependent 4-byte loads "
        + ("not measured" if probe[3] is None else f"{probe[3]:.3f} us"))
    return dict(ms=ms, global_ms=g_ms, plain_ms=plain, bound_ms=bound_ms,
                floor_ms=floor_ms,
                empty_ms=probe[0] / 1e3 if probe[0] else None)


# ---------------------------------------------------------------------------
# flash attention: kernel vs plain
# ---------------------------------------------------------------------------

class FACase(NamedTuple):
    """One flash check: the flat shapes ``q [B*KV*G, Sq, hd]``, ``k/v
    [B*KV, Sk, hd]``, the mask options, and the bf16 route :func:`plan`
    must take (f32 takes ``decode`` at ``G * Sq <= 16``, else ``simt``).
    ``empty`` moves row 0 before every key; ``q_at`` puts the first q row
    at that position; ``splits`` forces the decode route's split count."""
    name: str
    B: int
    KV: int
    G: int
    Sq: int
    Sk: int
    hd: int
    causal: bool
    window: int
    cap: float
    route: str
    empty: bool = False
    q_at: Optional[float] = None
    splits: Optional[int] = None


FA_CHECK_CASES = [
    # the FA_CASES of tests/test_kernels.py:28-38, then the slice's shapes
    FACase("fa_case0", 1, 1, 1, 16, 16, 8, True, 0, 0.0, "decode"),
    FACase("fa_case1", 2, 2, 2, 32, 32, 16, True, 0, 0.0, "simt"),
    FACase("fa_gqa_ragged", 1, 2, 4, 24, 40, 8, True, 0, 0.0, "simt"),
    FACase("fa_cross", 1, 1, 1, 16, 48, 8, False, 0, 0.0, "decode"),
    FACase("fa_window", 2, 1, 2, 32, 32, 8, True, 9, 0.0, "simt"),
    FACase("fa_softcap", 1, 2, 1, 32, 32, 8, True, 0, 30.0, "simt"),
    FACase("fa_bf16", 1, 1, 2, 16, 16, 8, True, 0, 0.0, "simt"),
    FACase("fa_decode", 1, 1, 1, 1, 40, 8, True, 0, 0.0, "decode"),
    FACase("llama3", 1, 8, 4, 128, 200, 128, True, 0, 0.0, "tc"),
    FACase("gemma2", 1, 2, 2, 96, 96, 256, True, 32, 50.0, "tc"),
    FACase("decode_long", 2, 8, 4, 1, 2080, 128, True, 0, 0.0, "decode"),
    FACase("ragged", 1, 2, 2, 70, 135, 64, True, 0, 0.0, "tc"),
    FACase("no_visible", 1, 2, 2, 8, 24, 8, True, 0, 0.0, "decode", True),
    # the tensor-core route's edges: a 128-row tile mixing the heads of a
    # group (4 x 70 rows), hd 256 with window and softcap, Sk not a
    # multiple of the key tile, a row with no visible key
    FACase("tc_mixed_heads", 1, 2, 4, 70, 150, 128, True, 0, 0.0, "tc"),
    FACase("tc_hd256_window_cap", 1, 2, 2, 100, 100, 256, True, 32, 50.0,
           "tc"),
    FACase("tc_hd64_ragged_sk", 2, 1, 2, 80, 200, 64, True, 0, 0.0, "tc"),
    FACase("tc_no_visible", 1, 2, 4, 40, 72, 128, True, 0, 0.0, "tc", True),
    # the decode route's: the row mid-cache (the tail splits see nothing),
    # and forced split counts
    FACase("decode_mid_cache", 2, 8, 4, 1, 2080, 128, True, 0, 0.0,
           "decode", q_at=1500.0),
    *(FACase(f"decode_splits{n}", 1, 2, 4, 1, 2080, 128, True, 0, 0.0,
             "decode", q_at=1500.0, splits=n) for n in (1, 2, 9, 33)),
    # a row that sees no key, split and whole; hd 256 with window and cap
    FACase("decode_no_visible", 1, 2, 4, 1, 300, 128, True, 0, 0.0,
           "decode", True),
    FACase("decode_no_visible_1split", 1, 2, 4, 1, 300, 128, True, 0, 0.0,
           "decode", True, splits=1),
    FACase("decode_hd256_window_cap", 1, 2, 2, 1, 500, 256, True, 32, 50.0,
           "decode"),
    # rings that wrap: 1000 keys through the tc K/V ring (3 x 128 keys at
    # hd 64 and 128, 2 x 64 at hd 256), late rows seeing them all or no
    # mask at all; 2080 keys through the decode mma ring (3 x 64 keys at
    # hd 64, 2 x 64 at hd 256) at one split, two and the plan's count
    FACase("tc_hd64_wrap", 1, 2, 2, 64, 1000, 64, True, 0, 0.0, "tc",
           q_at=936.0),
    FACase("tc_hd128_wrap", 1, 2, 4, 40, 1000, 128, False, 0, 0.0, "tc"),
    FACase("tc_hd256_wrap", 1, 2, 2, 64, 1000, 256, True, 0, 0.0, "tc",
           q_at=936.0),
    *(FACase(f"decode_hd{hd}_wrap" + (f"_splits{n}" if n else ""), 1, 2,
             4, 1, 2080, hd, True, 0, 0.0, "decode", splits=n)
      for hd in (64, 256) for n in (1, 2, None)),
    # the encoder-decoder's and paligemma's call forms (phase 14), cut
    # down, with a ragged Sk: the encoder (non-causal, Sq = Sk), the
    # cross-attention's prefill (non-causal, Sq > Sk) and decode row
    # (non-causal: a row at position 0 sees every key), the decoder self
    # prefill over a cache longer than the prompt, paligemma's MQA at hd
    # 256 with g = 8 (prefill rows at the last keys; a decode step)
    FACase("enc_hd64_ragged", 1, 4, 1, 200, 200, 64, False, 0, 0.0, "tc"),
    FACase("cross_prefill_hd64_ragged", 2, 2, 1, 1100, 1000, 64, False, 0,
           0.0, "tc"),
    FACase("cross_decode_hd64_ragged", 2, 4, 1, 1, 1000, 64, False, 0, 0.0,
           "decode"),
    FACase("cross_decode_hd64_1split", 2, 4, 1, 1, 1000, 64, False, 0, 0.0,
           "decode", splits=1),
    FACase("self_prefill_hd64_long_cache", 1, 4, 1, 600, 800, 64, True, 0,
           0.0, "tc"),
    FACase("mqa_hd256_g8_prefill", 1, 1, 8, 100, 300, 256, True, 0, 0.0,
           "tc", q_at=200.0),
    FACase("mqa_hd256_g8_decode", 2, 1, 8, 1, 1000, 256, True, 0, 0.0,
           "decode"),
]
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 is also held per row: the largest ||got_r - want_r|| / ||want_r||
# over the output rows.  Where outputs are ~0.04 (a row that sees ~2,000
# keys), the element-wise 2e-2 passes a kernel that skips a 64-key tile
# (~5e-3 a value); per row that fault reads >= 0.1, a sound kernel
# ~3e-3 to 6e-3 (bf16 output rounding, p rounded to bf16 for P.V).
# Readings: PERF.md section 6; flash_timings plants the faults at the
# serve cell's shapes on every run and checks they exceed the limit.
FA_ROW_TOL = 2e-2


def fa_route(case: FACase, dtype) -> str:
    """The route the plan must give ``case`` in ``dtype``."""
    if dtype == torch.bfloat16 or case.G * case.Sq <= 16:
        return case.route
    return "simt"


def fa_case_inputs(case: FACase, dtype, dev, seed: int = 0):
    """Seeded flat inputs of one case: ``(q, k, v, q_pos, k_pos)`` and the
    keywords.  Positions as in tests/test_kernels.py (a decode row sits at
    the last key unless ``q_at`` moves it); ``empty`` moves row 0 before
    every key."""
    rng = np.random.default_rng(seed)
    B, KV, G, Sq, Sk, hd = (case.B, case.KV, case.G, case.Sq, case.Sk,
                            case.hd)
    q = rng.standard_normal((B * KV * G, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((B * KV, Sk, hd), dtype=np.float32)
    v = rng.standard_normal((B * KV, Sk, hd), dtype=np.float32)
    qp = np.arange(Sq, dtype=np.float32) + (
        Sk - Sq if case.causal and Sq == 1 else 0)
    if case.q_at is not None:
        qp = np.arange(Sq, dtype=np.float32) + case.q_at
    if case.empty:
        qp[0] = -1.0
    kp = np.arange(Sk, dtype=np.float32)

    def t(a):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    args = (t(q), t(k), t(v), torch.from_numpy(qp).to(dev),
            torch.from_numpy(kp).to(dev))
    return args, dict(g=G, scale=1.0 / np.sqrt(hd), causal=case.causal,
                      window=case.window, attn_cap=case.cap)


def fa_run(fa_ops, fa_kernel, case: FACase, args, kw):
    """The flash op on ``args``; a case that forces the decode split
    count calls the kernel's wrapper with it (CUDA tensors only)."""
    if case.splits is not None and args[0].is_cuda:
        return fa_kernel.flash_attention_cuda(*args, **kw,
                                              splits=case.splits)
    return fa_ops.flash_attention_flat(*args, **kw)


def fa_row_err(got, want) -> float:
    """The largest ``||got_r - want_r|| / ||want_r||`` over the rows (the
    last axis) of two outputs."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def fa_close(got, want, dtype):
    """``|got - want| <= tol + tol * |want|`` (numpy's allclose with rtol =
    atol = tol), every value finite, and in bf16 also ``fa_row_err <=
    FA_ROW_TOL``; returns the max abs difference."""
    tol = FA_TOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= tol + tol * w.abs()).all())
    if dtype == torch.bfloat16:
        ok = ok and fa_row_err(g, w) <= FA_ROW_TOL
    return ok, float(diff.max())


def fa_kernel_vs_plain(fa_ops, fa_ref, fa_kernel, seed: int, dev) -> float:
    """The flash op (the kernel on ``dev``) against its plain version on
    the same inputs, every case in f32 and bf16; on the card each call
    must take the case's route.  Returns the largest absolute
    difference."""
    worst = worst_row = 0.0
    for case in FA_CHECK_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = fa_case_inputs(case, dtype, dev, seed)
            before = dict(fa_kernel.flash_attention_cuda.route_launches)
            got = fa_run(fa_ops, fa_kernel, case, args, kw)
            want = fa_ref.flash_attention_flat(*args, **kw)
            _sync(dev)
            if dev.type == "cuda":
                after = fa_kernel.flash_attention_cuda.route_launches
                took = [r for r in after if after[r] != before[r]]
                check(took == [fa_route(case, dtype)],
                      f"flash {case.name} {dtype} took {took}, not "
                      f"{fa_route(case, dtype)}")
            ok, err = fa_close(got, want, dtype)
            check(got.dtype == dtype and got.shape == args[0].shape,
                  f"flash {case.name} {dtype}: dtype/shape")
            row = fa_row_err(got, want)
            check(ok, f"flash kernel != plain at {case.name} {dtype}: max "
                  f"abs err {err}, row err {row}")
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                worst_row = max(worst_row, row)
    log(f"phase 2: flash kernel == plain on {len(FA_CHECK_CASES)} cases x "
        f"{{f32, bf16}} (tol 2e-5 / 2e-2, bf16 rows {FA_ROW_TOL}), each on "
        f"its route, max abs err {worst:.3e}, bf16 max row err "
        f"{worst_row:.3e}")
    return worst


def serve_logits_agree(card, cpu, tol: float, rtol: float,
                       tag: str = "phase 2") -> tuple:
    """Two serves' kept logits, step by step: within ``atol = tol`` and
    ``rtol`` at every step, and the same tokens up to the first step
    whose top-2 gap is within ``tol`` (a near-tie may pick either token;
    the runs part there).  Raises :class:`SmokeFailure` where they differ;
    returns ``(max abs diff, steps compared)``."""
    worst = 0.0
    for step, (lk, lc) in enumerate(zip(card.logits, cpu.logits)):
        lk, lc = lk.float().numpy(), lc.float().numpy()
        worst = max(worst, float(np.abs(lk - lc).max()))
        check(np.allclose(lk, lc, rtol=rtol, atol=tol),
              f"step {step}: card logits differ from the CPU's by "
              f"{np.abs(lk - lc).max():.3e}")
        if step == len(card.logits) - 1:
            break
        same = card.generated[:, step] == cpu.generated[:, step]
        top2 = np.sort(lc, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        check(same[clear].all(), f"step {step}: a token differs where the "
              f"top-2 gap exceeds {tol}")
        if not same.all():
            log(f"{tag}: near-tie at step {step}; compared up to there")
            break
    return worst, step + 1


def small_serve_config(get_config, dtype: str, head_dim: int = 0,
                       arch: str = "llama3-8b", over: Optional[dict] = None):
    """``arch``'s smoke config in ``dtype`` with attn_impl "pallas", its
    head_dim set to ``head_dim`` when given, and the fields of ``over``
    replaced."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=dtype, attn_impl="pallas", **(over or {}))
    return dataclasses.replace(cfg, head_dim=head_dim) if head_dim else cfg


def small_serve_kwargs(seed: int) -> dict:
    """The small serve's traffic: 16 requests of 16 prompt tokens, 8
    decode steps, 64 pages of 16 tokens, logits kept."""
    return dict(requests=16, steps=8, prompt_len=16, page_size=16,
                n_pages=64, seed=seed, keep_logits=True)


def small_serve_matches_cpu(serve_mod, build_model, get_config, seed: int,
                            dev, dtype: str = "float32", head_dim: int = 0,
                            tol: float = 1e-3, rtol: Optional[float] = None,
                            arch: str = "llama3-8b", tag: str = "phase 2",
                            prompt_len: int = 0, over: Optional[dict] = None):
    """A small serve (:func:`small_serve_config`, the same weights on both
    devices) on the card against the CPU: the same admitted set, and
    logits and tokens as :func:`serve_logits_agree` checks them (``rtol``
    defaults to ``tol``).  In f32 the tolerance 1e-3 covers sums taken in
    another order and the bf16 KV cache, which turns a last-bit
    difference into one bf16 ulp.  The CPU runs first; an MoE layer on
    the card then takes the CPU's routing (:func:`routing_record`), and
    its own choices may differ only at near-ties.  ``over`` replaces
    fields of the config.  Returns the flash calls the card run made, by
    route."""
    from repro_torch.models import moe as moe_mod
    cfg = small_serve_config(get_config, dtype, head_dim, arch, over)
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    card_model = copy.deepcopy(cpu_model).to(dev)
    kw = small_serve_kwargs(seed)
    kw["prompt_len"] = prompt_len or kw["prompt_len"]
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    with routing_record(moe_mod) as cpu_rec:
        cpu = serve_mod.serve(cfg, device="cpu", model=cpu_model, **kw)
    before = dict(fa_kernel.flash_attention_cuda.route_launches)
    with routing_record(moe_mod, follow=cpu_rec) as card_rec:
        card = serve_mod.serve(cfg, device=dev, model=card_model, **kw)
    routes = {r: n - before[r] for r, n in
              fa_kernel.flash_attention_cuda.route_launches.items()}
    flips = routing_flips(card_rec, cpu_rec, ROUTE_GAP_EPS[dtype])
    check(np.array_equal(card.admitted, cpu.admitted),
          "card and CPU admitted different requests")
    check(card.logits_finite and cpu.logits_finite, "non-finite logits")
    rtol = tol if rtol is None else rtol
    worst, steps = serve_logits_agree(card, cpu, tol, rtol, tag)
    moe = (f", {len(cpu_rec)} MoE calls, the card's own routing differs "
           f"from the CPU's at {flips[0]} tokens (smallest reference gap "
           f"{flips[1]:.3e}, limit {ROUTE_GAP_EPS[dtype]})"
           if cpu_rec else "")
    log(f"{tag}: small serve ({cfg.name} smoke, {dtype}, head_dim "
        f"{cfg.resolved_head_dim}, prompts of {kw['prompt_len']}) on the "
        f"card == on the CPU: "
        f"{len(card.admitted)} admitted, logits within atol {tol} rtol "
        f"{rtol} over {steps} steps (max abs diff {worst:.3e}), flash "
        f"calls by route {json.dumps(routes)}{moe}")
    return routes


# bf16 small serve, card against CPU: bf16 keeps 8 significant bits and the
# two runs round at other places (the tensor-core routes round p to bf16,
# the CPU's plain version keeps it in f32; the products accumulate in
# another order), so logits of magnitude <= 4.6 differ by a few bf16 ulps.
# The limit is absolute (rtol 0), between the readings in PERF.md section
# 6: a sound card run, and faults planted in the CPU's flash op
# (tests/test_torch_flash_faults.py, which checks each one fails it).
SERVE_BF16_TOL = 0.15
SERVE_BF16_HEAD_DIM = 128


def small_serve_bf16(serve_mod, build_model, get_config, seed: int, dev):
    """The bf16 small serve at head_dim 128, card against CPU: on the card
    the prefill takes the tensor-core route and every decode step the
    decode route (prompt 16 x 4 heads = 64 rows per kv head; 8 steps)."""
    routes = small_serve_matches_cpu(
        serve_mod, build_model, get_config, seed, dev, dtype="bfloat16",
        head_dim=SERVE_BF16_HEAD_DIM, tol=SERVE_BF16_TOL, rtol=0.0)
    n_layers = get_config("llama3-8b", smoke=True).n_layers
    if dev.type == "cuda":
        check(routes == dict(tc=n_layers, decode=n_layers * 8, simt=0),
              f"bf16 small serve flash routes {routes}")
    return routes


# ---------------------------------------------------------------------------
# phase 5: the LM serve slice at full width
# ---------------------------------------------------------------------------

LM_REQUESTS, LM_STEPS, LM_PROMPT = 128, 32, 2048
LM_PAGE, LM_PAGES = 256, 1024


def layer_counts(cfg) -> collections.Counter:
    """Layers of the whole stack by mixer kind (``attn``, ``mamba``,
    ``mlstm``, ``slstm``) and by ffn (``ffn_dense``, ``ffn_moe``,
    ``ffn_none``)."""
    c = collections.Counter()
    for spec in cfg.unit:
        c[spec.kind] += cfg.n_units
        c[f"ffn_{spec.ffn}"] += cfg.n_units
    return c


def flash_calls(cfg) -> tuple:
    """``(calls over a prompt, calls a decode step)`` of the flash op in
    one forward: one an attention layer (none where the cache is int8:
    those layers attend through the plain chunk-dequantizing path), and
    for an encoder-decoder also one a decoder layer's cross-attention
    and, over the prompt only, one an encoder layer."""
    n = layer_counts(cfg)["attn"]
    cached = 0 if cfg.kv_dtype == "int8" else n
    if cfg.enc_dec:
        return cached + n + cfg.n_enc_layers, cached + n
    return cached, cached


def kv_position_bytes(cfg) -> int:
    """Bytes one position of the decode cache takes over every attention
    layer: K and V in bf16, or in int8 beside their float32 scales."""
    heads = layer_counts(cfg)["attn"] * cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    return heads * (2 * hd + 2 * 4 if cfg.kv_dtype == "int8" else 2 * hd * 2)


def n_norm_weights(cfg) -> int:
    """The norms' weights: ``ln1`` a layer, ``ln2`` a layer with an ffn,
    the final norm; an encoder-decoder's ``ln_cross`` a decoder layer, two
    an encoder layer and ``enc_norm``."""
    c = layer_counts(cfg)
    n = cfg.n_layers + cfg.n_layers - c["ffn_none"] + 1
    if cfg.enc_dec:
        n += cfg.n_layers + 2 * cfg.n_enc_layers + 1
    return n * cfg.d_model


def n_params_gap(cfg) -> int:
    """What ``cfg.n_params``' formula leaves out of the port's (and the
    reference's) parameter count besides the norms and the padded vocab:
    a Mamba layer's ``conv_b`` and ``dt_proj_b``; an mLSTM layer's
    gates and ``out_norm`` (the formula counts ``4 d_in^2`` where the
    block holds ``wq wk wv``); an sLSTM layer's recurrent matrices and
    biases (the formula counts ``2 D d_in + 4 d_in^2``); an attention
    layer's QKV biases (qwen1.5); a frontend's ``frontend_proj``."""
    D, H = cfg.d_model, cfg.n_heads
    gap = 0
    for spec in cfg.unit:
        if spec.kind == "attn" and cfg.qkv_bias:
            gap += (H + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim
        if spec.kind == "mamba":
            gap += 2 * (cfg.mamba.expand * D)
        elif spec.kind in ("mlstm", "slstm"):
            d_in = int(cfg.xlstm.proj_factor * D)
            gap += (-d_in * d_in + 2 * d_in * H + 2 * H + d_in
                    if spec.kind == "mlstm"
                    else -D * d_in + 4 * d_in * d_in + 4 * d_in)
    proj = cfg.frontend_dim * D if cfg.frontend != "none" else 0
    return gap * cfg.n_units + proj


def plain_grants(serve_mod, pm_ref, seed: int, dev,
                 requests: int = LM_REQUESTS) -> torch.Tensor:
    """The plain ``reserve_slots`` verdicts (``bool[requests]``) on the
    serve cells' page proposals, drawn as ``serve`` draws them."""
    pages_per_req = -(-(LM_PROMPT + LM_STEPS) // LM_PAGE)
    r = torch.as_tensor(serve_mod.propose_pages(
        requests, pages_per_req, LM_PAGES, np.random.default_rng(seed)),
        device=dev)
    _, granted = pm_ref.pmwcas_apply(
        torch.ones(LM_PAGES, dtype=torch.int32, device=dev), r,
        torch.ones_like(r), torch.zeros_like(r))
    return granted


def attention_form(*a, **kw) -> str:
    """The label of an attention call by its form: the encoder's
    (non-causal self-attention), the decoder's self-attention, or
    cross-attention (``kv=``)."""
    if kw.get("kv") is not None:
        return "p11.cross_attn"
    return "p11.self_attn" if kw.get("causal", True) else "p11.enc_attn"


attention_form.labels = ("p11.enc_attn", "p11.self_attn", "p11.cross_attn")


@contextlib.contextmanager
def launches_by_form(attn_mod, fa_kernel):
    """Within the block each call of ``attn_mod.attention`` adds the flash
    launches it made, by route, to ``counts["<form> <route>"]`` (the form
    by :func:`attention_form`: ``enc``, ``self`` or ``cross``; a remat
    recompute calls it again); yields ``counts``."""
    attention = attn_mod.attention
    counts = collections.Counter()

    def counted(*a, **kw):
        before = dict(fa_kernel.flash_attention_cuda.route_launches)
        out = attention(*a, **kw)
        form = attention_form(*a, **kw)[len("p11."):-len("_attn")]
        for route, n in fa_kernel.flash_attention_cuda.route_launches.items():
            if n != before[route]:
                counts[f"{form} {route}"] += n - before[route]
        return out

    attn_mod.attention = counted
    try:
        yield counts
    finally:
        attn_mod.attention = attention


def lm_slice(serve_mod, build_model, get_config, pm_ref, fa_kernel,
             pm_kernel, seed: int, dev, arch: str = "llama3-8b",
             tag: str = "phase 5", cfg=None, requests: int = LM_REQUESTS,
             min_admitted: int = 8):
    """``arch`` (or ``cfg``) at full width and depth, random bf16 weights
    from a seeded generator on the card, served through ``serve`` to
    ``requests`` proposed requests: admission by the PMwCAS kernel,
    attention by the flash kernel (at every attention layer: ``tc`` at
    the prefill, ``decode`` at every step; no launch for a layer whose
    cache is int8).  For an MoE arch also the MoE layer's calls by path
    (the capacity path at every prefill layer, the dense path at every
    decode layer) and the share of the prefill's assignments dropped at
    capacity; the peak memory of the build and of the serve, and the
    greedy tokens."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(cfg or get_config(arch), attn_impl="pallas")
    counts = layer_counts(cfg)
    n_moe = counts["ffn_moe"]
    fa_prompt, fa_step = flash_calls(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    _sync(dev)
    build_peak = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    norms = n_norm_weights(cfg)
    # the embedding's rows past the vocab (padded to a multiple of 256)
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    gap = n_params_gap(cfg)
    check(n_params - norms - pad - gap == cfg.n_params,
          f"{n_params} parameters")
    experts = (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
               f"{cfg.moe.d_ff}" if cfg.moe else "")
    kinds = ", ".join(f"{n} {k}" for k, n in sorted(counts.items()))
    if cfg.enc_dec:
        kinds += (f"; {cfg.n_enc_layers} encoder layers over "
                  f"{cfg.frontend_len} frames, cross-attention in every "
                  f"decoder layer")
    elif cfg.frontend != "none":
        kinds += f"; a {cfg.frontend_len}-embedding {cfg.frontend} prefix"
    log(f"{tag}: {cfg.name} ({cfg.n_layers} layers: {kinds}; d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}{experts}, vocab "
        f"{cfg.vocab}): {cfg.n_params} weights + {norms} norm weights + "
        f"{pad} padded-vocab weights + {gap} the formula leaves out, "
        f"{n_bytes / 1e9:.2f} GB on the "
        f"card, drawn in {time.perf_counter() - t0:.3f} s")

    pages_per_req = -(-(LM_PROMPT + LM_STEPS) // LM_PAGE)
    want = plain_grants(serve_mod, pm_ref, seed, dev, requests)

    dropped, cross_kv = [], []
    route = moe_mod.route
    precompute = attn_mod.precompute_cross_kv

    def counted_route(probs, k, capacity):  # drops summed on the card
        r = route(probs, k, capacity)
        dropped.append(((~r.keep).sum(), r.keep.numel()))
        return r

    def counted_cross_kv(*a, **kw):
        cross_kv.append(1)
        return precompute(*a, **kw)

    fa_kernel.reset_counts()                        # count this path only
    pm_kernel.reset_counts()
    moe_mod.reset_counts()
    moe_mod.route = counted_route
    attn_mod.precompute_cross_kv = counted_cross_kv
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        with launches_by_form(attn_mod, fa_kernel) as forms:
            res = serve_mod.serve(cfg, requests=requests, steps=LM_STEPS,
                                  prompt_len=LM_PROMPT, page_size=LM_PAGE,
                                  n_pages=LM_PAGES, device=dev, seed=seed,
                                  model=model)
    finally:
        moe_mod.route = route
        attn_mod.precompute_cross_kv = precompute
    fa_forms = dict(forms)
    moe_calls = dict(moe_mod.calls)
    fa_launches = fa_kernel.flash_attention_cuda.launches
    fa_routes = dict(fa_kernel.flash_attention_cuda.route_launches)
    pm_launches = pm_kernel.pmwcas_apply_cuda.launches
    pm_routes = dict(pm_kernel.pmwcas_apply_cuda.route_launches)
    B = len(res.admitted)
    log(f"{tag}: admitted {B}/{requests} requests ({pages_per_req} "
        f"pages each of {LM_PAGE} tokens, {LM_PAGES} pages)")
    check(np.array_equal(res.granted, want.cpu().numpy()),
          "admission != the plain reserve_slots on the same proposals")
    check(B >= min_admitted, f"only {B} requests admitted")
    check(res.logits_finite, "non-finite logits")
    check(res.generated.shape == (B, LM_STEPS)
          and (res.generated >= 0).all()
          and (res.generated < cfg.vocab).all(), "generated tokens")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    want_fa = fa_prompt + fa_step * LM_STEPS
    check(fa_launches == want_fa,
          f"flash launches {fa_launches} != {fa_prompt} + {fa_step} x "
          f"{LM_STEPS} = {want_fa}")
    want_routes = dict(tc=fa_prompt, decode=fa_step * LM_STEPS, simt=0)
    check(fa_routes == want_routes, f"flash routes {fa_routes} != "
          f"{want_routes} (tc at every prefill, decode at every step)")
    check(sum(fa_forms.values()) == fa_launches, f"flash launches by call "
          f"form {fa_forms} do not add up to {fa_launches}")
    check(len(cross_kv) == (cfg.n_units if cfg.enc_dec else 0),
          f"the cross K/V computed {len(cross_kv)} times, not once a unit "
          f"at the prefill")
    check(pm_launches == 1 and pm_routes == {"smem": 1, "global": 0},
          f"page-grant launches {pm_launches} by route {pm_routes} != 1 "
          "on the smem route")
    moe = ""
    if cfg.moe:
        want_moe = dict(capacity=n_moe, dense=n_moe * LM_STEPS)
        check(moe_calls == want_moe, f"MoE calls by path {moe_calls} != "
              f"{want_moe} (capacity at every prefill layer, dense at every "
              f"decode layer)")
        n_drop = int(sum(d for d, _ in dropped))
        n_all = sum(n for _, n in dropped)
        C = moe_mod._capacity(B * LM_PROMPT, cfg.moe.n_experts,
                              cfg.moe.top_k, cfg.moe.capacity_factor)
        moe = (f"; MoE calls by path {json.dumps(moe_calls)}; the prefill "
               f"dropped {n_drop} of {n_all} assignments at capacity {C} "
               f"({n_drop / n_all:.4f})")
    kv_len = LM_PROMPT + LM_STEPS + cfg.frontend_len   # as serve sizes it
    kv_bytes = B * kv_len * kv_position_bytes(cfg)
    cross_bytes = (2 * cfg.n_units * B * cfg.n_kv_heads * cfg.frontend_len
                   * cfg.resolved_head_dim
                   * torch.finfo(model.dtype).bits // 8
                   if cfg.enc_dec else 0)
    state_bytes = 4 * sum(
        t.numel() for spec, c in zip(cfg.unit, model.init_cache(
            B, 1)["layers"].values()) if spec.kind != "attn"
        for t in c.values())
    t = res.timings
    cross = (f", cross K/V {cross_bytes / 1e9:.2f} GB ({cfg.frontend_len} "
             f"frames, computed once a unit at the prefill)"
             if cfg.enc_dec else "")
    log(f"{tag}: KV cache {cfg.kv_dtype} {kv_bytes / 1e9:.2f} GB "
        f"({kv_len} positions){cross}, recurrent states "
        f"f32 {state_bytes / 1e9:.3f} GB, peak memory of the serve "
        f"{peak / 1e9:.2f} GB (max_memory_allocated); prefill of "
        f"{B} x {LM_PROMPT} tokens {t['prefill_s']:.3f} s; decode "
        f"{t['decode_ms_per_step']:.3f} ms/step over {LM_STEPS} steps "
        f"({t['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{t['tokens_per_s']:.1f} generated tokens/s with the prefill); "
        f"launches on this path: flash {fa_launches} (by route "
        f"{json.dumps(fa_routes)}; by call form and route "
        f"{json.dumps(fa_forms)}), pmwcas {pm_launches} (by route "
        f"{json.dumps(pm_routes)}){moe}")
    return dict(model=model, cfg=cfg, B=B, fa_launches=fa_launches,
                fa_routes=fa_routes, fa_forms=fa_forms,
                pm_launches=pm_launches,
                pm_routes=pm_routes, timings=t, moe_calls=moe_calls,
                peak_bytes=peak, kv_bytes=kv_bytes, cross_bytes=cross_bytes,
                cross_kv_calls=len(cross_kv), weight_bytes=n_bytes,
                build_peak_bytes=build_peak, generated=res.generated)


def _visible_pairs(qp, kp) -> int:
    """(q row, key) pairs the causal mask leaves visible, for one head."""
    return int(((kp < 2.0 ** 29)[None, :] & (qp[:, None] >= kp[None, :]))
               .sum())


def _clocks() -> str:
    """The card's SM clock, power draw and temperature right now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _sdpa_library(q, k, v, qp, kp, scale: float, B: int,
                  causal: bool = True):
    """One PyTorch call computing the same function: SDPA with GQA and an
    explicit boolean mask from the positions (valid keys, and causal when
    ``causal``; timed here, never called by the port)."""
    import torch.nn.functional as F
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    ok = (kp < 2.0 ** 29)[None, :].expand(Sq, Sk)
    if causal:
        ok = ok & (qp[:, None] >= kp[None, :])
    q4 = q.view(B, H // B, Sq, hd)
    k4, v4 = k.view(B, HK // B, Sk, hd), v.view(B, HK // B, Sk, hd)
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=ok[None, None], scale=scale, enable_gqa=True)


def _captured(fn, n: int):
    """A CUDA graph of ``n`` back-to-back calls of ``fn`` and a function
    that replays it once and returns the device time per call (ms, CUDA
    events around the replay), so the host's launch speed drops out.
    ``fn`` is warmed up first on the capture's side stream, so one-time
    work (``cudaFuncSetAttribute``, the allocator's first blocks) happens
    outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    replay.graph = graph               # keeps the graph alive with replay
    return replay


def _graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: the mean over ``replays`` replays
    of :func:`_captured`'s graph of ``n`` calls."""
    replay = _captured(fn, n)
    return sum(replay() for _ in range(replays)) / replays


def _interleaved_ms(fns: dict, n: int, rounds: int) -> dict:
    """Device time per call of each of ``fns`` (name -> function) from
    :func:`_captured` graphs of ``n`` calls, replayed in turns for
    ``rounds`` rounds, so that drift of the card's clocks between calls
    falls on all alike.  Returns name -> the per-round times (ms)."""
    replays = {name: _captured(fn, n) for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, replay in replays.items():
            times[name].append(replay())
    return times


def route_tile(route: str, hd: int) -> tuple:
    """``(keys a tile, K/V ring depth)`` of a bf16 call's kernel on
    ``route`` at head_dim ``hd``: ``flash_attention_tc.cu`` (tc) or the
    mma kernel of ``flash_attention_decode.cu`` (decode)."""
    if route == "tc":
        return (128, 3) if hd <= 128 else (64, 2)
    return 64, (3 if hd <= 128 else 2)


def fault_tiles(n_keys: int, last_pos: int, tile: int, stages: int):
    """The key slices :func:`fa_fault_errs` plants its faults in: a middle
    tile (at least the ring's second lap), the tile ``stages`` before it
    (the stale fault's source), and the tile holding the key at
    ``last_pos`` (the last row's own)."""
    j = max(stages, n_keys // tile // 2)
    last = min(last_pos, n_keys - 1) // tile * tile
    return (slice(j * tile, (j + 1) * tile),
            slice((j - stages) * tile, (j - stages + 1) * tile),
            slice(last, last + tile))


def fa_fault_errs(fa_ref, args, kw, want, tile: int, stages: int) -> dict:
    """:func:`fa_row_err` of outputs that a kernel with a planted fault
    would give, against the plain version's ``want``: the plain version
    on inputs changed the way each fault changes what the kernel reads.
    ``tile`` is the route's keys a tile, ``stages`` its K/V ring depth;
    the keys must span more than ``stages`` tiles.  ``drop``: a middle
    key tile (at least the ring's second lap) skipped; ``stale``: that
    tile's K and V served from its ring slot's previous tile (``stages``
    tiles back); ``last``: the tile holding the last row's own key (the
    last key, for a row past every key) skipped; for a non-causal call
    where a row has keys after its position, ``causal``: a causal mask
    applied."""
    q, k, v, qp, kp = args
    mid, old, last = fault_tiles(k.shape[1], int(qp.max()), tile, stages)

    def masked(keys):
        kpf = kp.clone()
        kpf[keys] = 2.0 ** 30
        return kpf

    ks, vs = k.clone(), v.clone()
    ks[:, mid], vs[:, mid] = k[:, old], v[:, old]
    runs = {"drop": (k, v, masked(mid), kw), "stale": (ks, vs, kp, kw),
            "last": (k, v, masked(last), kw)}
    if not kw["causal"] and bool((kp[None, :] > qp[:, None]).any()):
        runs["causal"] = (k, v, kp, dict(kw, causal=True))
    return {name: fa_row_err(fa_ref.flash_attention_flat(q, kf, vf, qp, kpf,
                                                         **kw_), want)
            for name, (kf, vf, kpf, kw_) in runs.items()}


def flash_timings(fa_ops, fa_ref, fa_kernel, lm, dev, seed: int,
                  tag: str = "phase 6"):
    """The flash op at the slice's prefill and decode shapes (one layer,
    random q/k/v from a seed).  Kernel against plain in f32 (2e-5,
    prefill at B = 1; on the ``simt`` route and the decode route's SIMT
    split kernel) and in bf16, the call the serve makes (2e-2, and per
    row ``FA_ROW_TOL``; on the ``tc`` route and the decode route's mma
    kernel).  Faults planted in the plain version's inputs (a key tile
    skipped, a stale ring slot, the last row's own tile skipped; one
    request's heads) must read above ``FA_ROW_TOL`` per row, so the bf16
    check would catch them.  Then the route and split count the plan
    gives the bf16 call, and the time per call of the kernel, the plain
    version and SDPA in bf16 beside the bound: stream time of
    back-to-back calls (CUDA events) at both shapes, and at the decode
    shape also device time from replayed CUDA graphs, the kernel's and
    SDPA's taken in turns over several rounds."""
    cfg, B = lm["cfg"], lm["B"]
    hd = cfg.resolved_head_dim
    Sk = LM_PROMPT + LM_STEPS
    G = cfg.n_heads // cfg.n_kv_heads
    free, _ = torch.cuda.mem_get_info()
    # the plain version holds about four f32 [H, Sq, Sk] score tensors
    per_req = 4 * cfg.n_heads * LM_PROMPT * Sk * 4
    B_cmp = max(1, min(B, int(0.8 * free) // per_req))
    out = {}
    for shape, Sq, Bc in (("prefill", LM_PROMPT, B_cmp), ("decode", 1, B)):
        rng = np.random.default_rng(seed + 11)
        mk = (lambda *s: torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(device=dev))
        q32 = mk(Bc * cfg.n_heads, Sq, hd)
        k32, v32 = (mk(Bc * cfg.n_kv_heads, Sk, hd) for _ in range(2))
        # prefill rows at 0..Sq-1; the decode row at the last cached key
        qp = torch.arange(Sq, device=dev, dtype=torch.float32) + (
            Sk - 1 if Sq == 1 else 0)
        kp = torch.arange(Sk, device=dev, dtype=torch.float32)
        kw = dict(g=G, scale=1.0 / np.sqrt(hd), causal=True, window=0,
                  attn_cap=0.0)
        B32 = 1 if shape == "prefill" else Bc
        f32_args = (q32[:B32 * cfg.n_heads], k32[:B32 * cfg.n_kv_heads],
                    v32[:B32 * cfg.n_kv_heads], qp, kp)
        got = fa_ops.flash_attention_flat(*f32_args, **kw)
        want = fa_ref.flash_attention_flat(*f32_args, **kw)
        torch.cuda.synchronize()
        ok, err32 = fa_close(got, want, torch.float32)
        check(ok, f"flash kernel != plain in f32 at the {shape} shape: "
              f"{err32}")
        rms = float(want.pow(2).mean().sqrt())
        del got, want
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        del q32, k32, v32
        got = fa_ops.flash_attention_flat(q, k, v, qp, kp, **kw)
        want = fa_ref.flash_attention_flat(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        ok, err = fa_close(got, want, torch.bfloat16)
        row = fa_row_err(got, want)
        check(ok, f"flash kernel != plain in bf16 at the {shape} shape: "
              f"max abs err {err}, row err {row}")
        o = torch.empty_like(q)
        HK = k.shape[0]
        route, splits = fa_kernel.plan(q.dtype, hd, G * Sq, Sk, HK,
                                       fa_kernel.n_sms(dev.index or 0))
        tile, stages = route_tile(route, hd)
        nq, nk = cfg.n_heads, cfg.n_kv_heads       # one request's heads
        faults = fa_fault_errs(fa_ref, (q[:nq], k[:nk], v[:nk], qp, kp), kw,
                               want[:nq], tile, stages)
        check(min(faults.values()) > FA_ROW_TOL,
              f"a planted fault at the {shape} shape reads "
              f"{json.dumps(faults)}, within the row limit {FA_ROW_TOL}")
        del want
        ws = (torch.empty(fa_kernel.workspace_floats(HK, splits, G * Sq, hd),
                          dtype=torch.float32, device=dev)
              if route == "decode" and fa_kernel.needs_workspace(
                  q.dtype, hd, splits) else None)

        def run_kernel():
            fa_kernel.launch(q, k, v, qp, kp, o, **kw, workspace=ws)

        def run_plain():
            fa_ref.flash_attention_flat(q, k, v, qp, kp, **kw)

        run_lib = _sdpa_library(q, k, v, qp, kp, kw["scale"], Bc)
        lib_err = float((run_lib().reshape(q.shape).float()
                         - got.float()).abs().max())
        n_k = 20 if shape == "decode" else 5
        n_p = 5 if shape == "decode" else 2
        ms, plain, lib = (_event_ms(run_kernel, n_k),
                          _event_ms(run_plain, n_p), _event_ms(run_lib, n_k))
        pairs = _visible_pairs(qp, kp) * q.shape[0]
        flops = 4 * hd * pairs
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound_ops = flops / H100_BF16_FLOPS * 1e3
        bound_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        by = "operations" if bound_ops >= bound_bytes else "bytes"
        res = dict(B=Bc, route=route, splits=splits, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=bound, bound_by=by,
                   err=max(err, err32), row_err=row, faults=faults)
        graphs = ""
        if shape == "decode":
            rounds = _interleaved_ms({"kernel": run_kernel, "sdpa": run_lib},
                                     50, 9)
            kr, lr = rounds["kernel"], rounds["sdpa"]
            res.update(graph_ms=float(np.median(kr)),
                       graph_plain_ms=_graph_ms(run_plain, 20),
                       graph_library_ms=float(np.median(lr)),
                       graph_rounds_ms=kr, graph_library_rounds_ms=lr)
            wins = sum(a < b for a, b in zip(kr, lr))
            graphs = (f"; device time per call (CUDA graphs of 50 back-to-"
                      f"back calls, kernel and SDPA replayed in turns, "
                      f"{len(kr)} rounds: median [min, max]) kernel "
                      f"{res['graph_ms'] * 1e3:.3f} [{min(kr) * 1e3:.3f}, "
                      f"{max(kr) * 1e3:.3f}] us, SDPA "
                      f"{res['graph_library_ms'] * 1e3:.3f} "
                      f"[{min(lr) * 1e3:.3f}, {max(lr) * 1e3:.3f}] us, "
                      f"kernel faster in {wins} of {len(kr)} rounds; plain "
                      f"{res['graph_plain_ms'] * 1e3:.3f} us")
        best = res.get("graph_ms", ms)
        rate = (f"{flops / best / 1e9:.1f} TFLOP/s" if by == "operations"
                else f"{n_bytes / best / 1e9:.4f} TB/s")
        log(f"{tag}: flash at the {shape} shape q [{q.shape[0]}, {Sq}, "
            f"{hd}] x k/v [{HK}, {Sk}, {hd}] bf16 (B = {Bc} of {B}; f32 "
            f"check at B = {B32}): route {route}, splits {splits}; stream "
            f"time per call (CUDA events, back to back) kernel "
            f"{ms * 1e3:.3f} us, plain {plain * 1e3:.3f} us, SDPA "
            f"{lib * 1e3:.3f} us{graphs}; kernel achieves {rate}; clocks, "
            f"power, temperature after the timed runs {_clocks()}; bound "
            f"{bound * 1e3:.3f} us by {by} ({flops} flops over {pairs} "
            f"visible pairs at {H100_BF16_FLOPS:.3g} FLOP/s, {n_bytes} bytes "
            f"at {H100_BYTES_PER_S:.3g} B/s); kernel vs plain: f32 max abs "
            f"err {err32:.3e} (output RMS {rms:.3e}), bf16 max abs err "
            f"{err:.3e}, bf16 max row err {row:.3e} (limit {FA_ROW_TOL}; "
            f"planted faults {tile}-key tile, ring of {stages}: "
            f"{json.dumps({n: round(e, 6) for n, e in faults.items()})}), "
            f"vs SDPA {lib_err:.3e}")
        out[shape] = res
        del q, k, v, o, got, ws
        torch.cuda.empty_cache()
    return out


# kernels the flash op launches, by the names the profiler shows: one of
# the first four per op call (SIMT, tensor-core prefill, the two decode
# split kernels); the combine follows a decode call of more than one split
FLASH_KERNELS = ("flash_attention_kernel", "flash_attention_tc_kernel",
                 "flash_attention_decode_kernel",
                 "flash_attention_decode_mma_kernel")
FLASH_GROUP = FLASH_KERNELS + ("flash_attention_combine_kernel",)


def _device_split(fn):
    """Device time of one call of ``fn`` by kernel (profiler): (busy µs,
    wall µs, {group: µs}, [(kernel name, µs), ...] largest first, flash
    op calls in the trace).  Groups: the flash kernels (every route, the
    decode combine included), matrix products (cuBLAS's gemm/nvjet
    kernels), and everything else (norms, RoPE, casts, copies, argmax)."""
    by_name, count, wall_us = _profile(fn)
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        key = ("flash" if any(f in name for f in FLASH_GROUP) else "matmul"
               if any(w in low for w in ("gemm", "cutlass", "xmma", "cublas",
                                         "nvjet"))
               else "other")
        groups[key] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    flash = sum(n for k, n in count.items()
                if any(f in k for f in FLASH_KERNELS))
    return sum(by_name.values()), wall_us, groups, top, flash


def _log_split(what, flash_made, busy, wall, groups, top, flash_seen,
               tag: str = "phase 6"):
    if not busy:
        log(f"{tag}: {what}: device time not measured (the profiler saw "
            "no device time)")
        return
    shares = ", ".join(f"{k} {v:.1f} us ({v / busy:.3f})"
                       for k, v in groups.items())
    log(f"{tag}: {what}: device busy {busy:.1f} us of {wall:.1f} us "
        f"wall, idle share {1 - busy / wall:.4f} (profiler); by group: "
        f"{shares}; flash launches in the trace: {flash_seen} of "
        f"{flash_made}")
    for name, us in top[:5]:
        log(f"{tag}:   {us:12.1f} us  {name[:100]}")


def where_time_goes(lm, ft, dev, seed: int, steps: int = 8,
                    tag: str = "phase 6"):
    """One prefill and a window of decode steps at the slice's batch and
    cache length, profiled: device busy share and time by kernel group,
    and the flash kernel's device time per prefill launch inside the
    model beside its time alone (``ft``, from :func:`flash_timings`).
    The prompt is drawn from the seed; the decode tokens are arbitrary
    (the work depends only on the shapes and positions)."""
    model, cfg, B = lm["model"], lm["cfg"], lm["B"]
    rng = np.random.default_rng(seed + 13)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, LM_PROMPT)),
                             device=dev)
    tok = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        cache = model.init_cache(B, LM_PROMPT + LM_STEPS)
        split = _device_split(lambda: model.prefill(prompt, cache))
        _log_split(f"one prefill of {B} x {LM_PROMPT} tokens", cfg.n_layers,
                   *split, tag=tag)
        log(f"{tag}: clocks, power, temperature after it: {_clocks()}")
        if split[0] and split[4] == cfg.n_layers:
            alone = ft["prefill"]
            log(f"{tag}: flash per prefill launch inside the model "
                f"{split[2]['flash'] / cfg.n_layers:.1f} us (profiler) "
                f"at B = {lm['B']} against {alone['ms'] * 1e3:.1f} us alone "
                f"(CUDA events, B = {alone['B']})")

        def window():
            for _ in range(steps):
                model.decode_step(tok, cache)

        window()                                   # warm
        cache["index"] = LM_PROMPT
        _log_split(f"decode window of {steps} steps", cfg.n_layers * steps,
                   *_device_split(window), tag=tag)


# ---------------------------------------------------------------------------
# phase 7: the durable slice (the paper's persistence, host code)
# ---------------------------------------------------------------------------

# kernel against durable: [B, K] increment batches and the route each
# takes.  The global route's batch is cut from [512, 32] to [128, 32]
# (K = 32 > 16 slots a row takes global at any B): the committer seeds
# every word with two fsyncs on the card machine's 9p disk, and 16,384
# words took 186.5 s of the smoke's 1,200 (PR 27)
DIFF_SHAPES = ((1024, 2, "smem"), (256, 16, "smem"), (128, 32, "global"))
# durable YCSB-A: 4 hash-map shards; the record count is cut from the ycsb
# cell's 1,048,576 because a durable snapshot reads every slot file of a
# shard on every wave (see PERF.md §4)
DUR_SHARDS, DUR_ROUND_CAP, DUR_RECORDS, DUR_OPS = 4, 64, 1024, 2048
DUR_KW = dict(group_commit=True, epoch_rounds=4, checkpoint_every=4,
              wal_prune_every=16)
# the reference bench's workload (benchmarks/bench_durable.py): 96 ops
# over 48 keys, 2 shards, round_cap 8, 8 clients
LEDGER_SPEC = dict(n_ops=96, n_keys=48, read=0.1, update=0.55, insert=0.25,
                   delete=0.1, alpha=0.9, seed=23)


def durable_differential(pm, kernel, dev, seed: int) -> dict:
    """``run_differential`` on the card: the simulator kernel, the PMwCAS
    kernel and the durable committer on seeded increment batches, one per
    shape of ``DIFF_SHAPES``; verdicts and final values must be equal,
    each batch must take its route and run one simulator launch.  Counts
    are zeroed just before and read just after."""
    from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
    out = {}
    kernel.reset_counts()
    sim_kernel.reset_counts()
    for B, K, route in DIFF_SHAPES:
        init, ops = pm.increment_batch(B * K, K, B, seed=seed + K)
        check(len(ops) == B, f"increment_batch gave {len(ops)} ops, not {B}")
        before = dict(kernel.pmwcas_apply_cuda.route_launches)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_diff_") as root:
            t0 = time.perf_counter()
            report = pm.run_differential(ops, init, durable_root=root,
                                         device=dev)
            secs = time.perf_counter() - t0
        check(report.agree and set(report.verdicts) ==
              {"sim", "kernel", "durable"},
              f"sim / kernel / durable disagree at [{B}, {K}]:\n"
              + report.summary())
        routes = kernel.pmwcas_apply_cuda.route_launches
        check(routes[route] == before[route] + 1,
              f"[{B}, {K}] did not launch on the {route} route: {routes}")
        won = int(report.verdicts["kernel"].sum())
        out[f"{B}x{K}"] = dict(route=route, ops=B, won=won, s=secs)
        log(f"phase 7: run_differential [{B}, {K}] on the {route} route: "
            f"sim == kernel == durable ({won}/{B} won, {B * K} words, "
            f"{secs:.3f} s with the committer's seeding)")
    launches = kernel.pmwcas_apply_cuda.launches
    routes = dict(kernel.pmwcas_apply_cuda.route_launches)
    sim_launches = sim_kernel.pmwcas_sim_cuda.launches
    sim_routes = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
    check(launches == len(DIFF_SHAPES) and all(routes.values())
          and sim_launches == len(DIFF_SHAPES),
          f"differential launches {launches}, routes {routes}, simulator "
          f"{sim_launches}: both routes and one simulation a batch must run")
    log("kernels: " + json.dumps({"pmwcas_apply differential": launches,
                                  "routes": routes,
                                  "pmwcas_sim differential": sim_launches,
                                  "pmwcas_sim routes": sim_routes}))
    return dict(launches=launches, routes=routes, shapes=out,
                sim_launches=sim_launches, sim_routes=sim_routes)


def fs_type(path) -> str:
    """The filesystem under ``path``, from ``/proc/mounts`` (the longest
    mount point that holds it)."""
    path = str(pathlib.Path(path).resolve())
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                dev, mnt, typ = line.split()[:3]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, kind = mnt, f"{typ} on {mnt} ({dev})"
    except OSError:
        pass
    return kind


def last_op_reads_back(st, items, futures) -> None:
    """Every key whose LAST submitted op was acknowledged holds that op's
    effect (nothing later can have changed it)."""
    last = {f.op.key: f for f in futures}
    for key, f in last.items():
        if not (f.done and f.status == st.OK):
            continue
        if f.op.kind in (st.INSERT, st.UPDATE):
            check(items.get(key) == f.op.value,
                  f"acknowledged write of key {key} lost: {items.get(key)}"
                  f" != {f.op.value}")
        elif f.op.kind == st.DELETE:
            check(key not in items, f"acknowledged delete of {key} lost")


def durable_slice(svc_mod, st, obs, dev, seed: int,
                  records: int = DUR_RECORDS, ops: int = DUR_OPS,
                  parent=None) -> dict:
    """YCSB-A over ``DUR_SHARDS`` durable hash-map shards (group commit,
    epochs of 4 rounds, a checkpoint every 4 epochs, WAL prune every 16
    waves): load, run, drain, crash and recover, crash again with an
    epoch open; integrity and the acknowledged writes are checked after
    each."""
    n_buckets = 2 * records // DUR_SHARDS
    window = DUR_ROUND_CAP * DUR_SHARDS
    spec = st.WorkloadSpec(n_ops=ops, n_keys=records, read=0.5,
                           update=0.5, insert=0.0, delete=0.0, alpha=0.99,
                           seed=seed)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_durable_",
                                         dir=parent))
    try:
        svc = svc_mod.KVService(DUR_SHARDS, backend="durable",
                                n_buckets=n_buckets,
                                round_cap=DUR_ROUND_CAP, durable_root=root,
                                device=dev, **DUR_KW)
        log(f"phase 7: durable KVService(n_shards={DUR_SHARDS}, round_cap="
            f"{DUR_ROUND_CAP}, n_buckets={n_buckets}, "
            + ", ".join(f"{k}={v}" for k, v in DUR_KW.items())
            + f") over {fs_type(root)}")
        t0 = time.perf_counter()
        load_futs = drive(svc, [(0, op) for op in st.load_phase(spec, 1.0)],
                          window)
        load_s = time.perf_counter() - t0
        check(all(f.status == st.OK for f in load_futs),
              "a durable load insert failed")
        log(f"phase 7: loaded {records} records in {load_s:.3f} s "
            f"({svc.stats.steps} waves)")

        arrivals = _arrivals(st.client_streams(spec, N_CLIENTS))
        svc.reset_stats()
        svc.stats.latency_us.window = len(arrivals)
        d0 = svc.durability_stats()
        persists0 = sum(b.pool.persist_count for b in svc.backends)
        split = WaveSplit(obs.get_tracer())
        obs.enable_tracing()
        try:
            t0 = time.perf_counter()
            run_futs = drive(svc, arrivals, window, on_step=split)
            run_s = time.perf_counter() - t0
        finally:
            obs.disable_tracing()
            obs.get_tracer().clear()
        stats = svc.stats
        d1 = svc.durability_stats()
        reg = obs.get_registry()
        delta = {k: d1.as_row()[k] - d0.as_row()[k] for k in d1.as_row()}
        committed = max(1, delta["ops_committed"])
        redundant = {dict(s.labels).get("reason"): int(s.value)
                     for s in reg.series("redundant_fences") if s.value}
        wal = sum(len(b.pool.listdir("wal")) for b in svc.backends)
        wal_cap = 2 * svc.wal_prune_every * DUR_SHARDS
        row = dict(
            ops=len(arrivals), s=run_s, ops_per_s=len(arrivals) / run_s,
            waves=stats.steps, p50_us=stats.p50_latency_us,
            p99_us=stats.p99_latency_us,
            persist_us_mean=stats.persist_us.mean_us,
            latency_us_mean=stats.latency_us.mean_us,
            flushes_per_commit=delta["flushes_issued"] / committed,
            fences_per_commit=delta["fences"] / committed,
            persists=sum(b.pool.persist_count for b in svc.backends)
            - persists0, durability=delta, acks_held=stats.acks_held,
            epoch_syncs=stats.epoch_syncs, wal_pruned=stats.wal_pruned,
            wal_records=wal, wal_cap=wal_cap, redundant_fences=redundant,
            wave_split_us=split.per_wave_us())
        log(f"phase 7: durable YCSB-A {len(arrivals)} ops from {N_CLIENTS} "
            f"clients in {run_s:.3f} s: {row['ops_per_s']:.1f} ops/s, "
            f"{stats.steps} waves, p50 {row['p50_us']:.1f} us, p99 "
            f"{row['p99_us']:.1f} us, persist share {row['persist_us_mean']:.1f}"
            f" us of a mean {row['latency_us_mean']:.1f} us latency")
        log(f"phase 7: flushes per commit {row['flushes_per_commit']:.4f}, "
            f"fences per commit {row['fences_per_commit']:.4f}, persists "
            f"{row['persists']}, WAL {wal} records (cap {wal_cap}), "
            f"acks held {stats.acks_held}, epoch syncs {stats.epoch_syncs}, "
            f"WAL pruned {stats.wal_pruned}, redundant fences {redundant}")
        log("phase 7: durability " + json.dumps(delta))
        log(f"phase 7: per-wave host split over {split.waves} traced waves "
            "(tracing on), us/wave: " + json.dumps(
                {k: round(v, 1) for k, v in row["wave_split_us"].items()}))

        check(all(f.done for f in run_futs), "a durable future is pending")
        check(svc.pending_count == 0 and not svc._held,
              "held acks left after the drain")
        check(stats.by_status.get(st.EXHAUSTED, 0) == 0, "ops exhausted")
        items = svc.check_integrity()
        acked = acked_state(st, acked_state(st, {}, load_futs), run_futs)
        check(items == acked, "acknowledged durable writes do not read back")
        check(sum(redundant.values()) == 0,
              f"redundant fences on the durable path: {redundant}")
        check(wal <= wal_cap, f"WAL holds {wal} records, cap {wal_cap}")

        t0 = time.perf_counter()
        svc = svc.crash()
        row["recover_ms"] = (time.perf_counter() - t0) * 1e3
        check(svc.check_integrity() == acked,
              "acknowledged writes lost across crash()/recover")
        log(f"phase 7: crash() + recover in {row['recover_ms']:.1f} ms: "
            "integrity ok, every acknowledged write reads back")

        # crash again with an epoch open: acks are held until it closes,
        # so no acknowledged op may be lost
        more = _arrivals(st.client_streams(
            dataclasses.replace(spec, n_ops=ops // 4, seed=seed + 1),
            N_CLIENTS))
        futs = [svc.submit(op, client=c) for c, op in more]
        open_epochs = held = 0
        while svc.pending_count and not (open_epochs and held):
            svc.step()
            open_epochs = sum(b.epoch_pending for b in svc.backends)
            held = len(svc._held)
        check(open_epochs > 0 and held > 0,
              f"no epoch open ({open_epochs} rounds) or no ack held "
              f"({held}) at the second crash")
        svc = svc.crash()
        items = svc.check_integrity()
        last_op_reads_back(st, items, load_futs + run_futs + futs)
        row.update(open_epoch_rounds=open_epochs, held_at_crash=held)
        log(f"phase 7: crash with {open_epochs} rounds in open epochs and "
            f"{held} acks held: integrity ok, no acknowledged op lost")
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def durable_ledger(svc_mod, st, pm, obs, svc_kw: dict, root) -> dict:
    """The reference bench's window (``LEDGER_SPEC``) on 2 durable shards
    for the per-op protocol, group commit and the dirty-flag baseline:
    flushes per commit, fences and redundant fences, from the registry.
    Takes the package's modules, so the CPU tests run it on both."""
    root = pathlib.Path(root)
    spec = st.WorkloadSpec(**LEDGER_SPEC)
    load = st.load_phase(spec, fraction=1.0)
    streams = st.client_streams(spec, 8)
    out = {}
    for mode in ("per_op", "group", "marker"):
        common = dict(structure="hashmap", n_buckets=2 * spec.n_keys,
                      round_cap=8, **svc_kw)
        if mode == "marker":
            svc = svc_mod.KVService(2, backend=[
                pm.DurableBackend(root / mode / f"shard{s}",
                                  committer="marker") for s in range(2)],
                **common)
        else:
            svc = svc_mod.KVService(2, backend="durable",
                                    durable_root=root / mode,
                                    group_commit=mode == "group", **common)
        svc.apply(load)
        svc.reset_stats()
        for i in range(max(len(s) for s in streams)):
            for client, stream in enumerate(streams):
                if i < len(stream):
                    svc.submit(stream[i], client=client)
        svc.drain()
        svc.check_integrity()
        reg = obs.get_registry()
        committed = int(reg.value("ops_committed", component="committer"))
        issued = int(reg.value("flushes_issued", component="committer"))
        out[mode] = dict(
            flushes_issued=issued, ops_committed=committed,
            flushes_per_commit=issued / max(1, committed),
            fences=int(reg.value("fences", component="committer")),
            flush_fences=int(reg.total("flush_fences")),
            redundant_fences=int(reg.total("redundant_fences")))
    return out


def durable_phase(pm, svc_mod, st, obs, kernel, dev, seed: int) -> dict:
    t0 = time.perf_counter()
    diff = durable_differential(pm, kernel, dev, seed)
    ycsb = durable_slice(svc_mod, st, obs, dev, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ledger_") as root:
        ledger = durable_ledger(svc_mod, st, pm, obs, dict(device=dev), root)
    for mode, row in ledger.items():
        log(f"phase 7: ledger {mode}: flushes per commit "
            f"{row['flushes_per_commit']:.4f} ({row['flushes_issued']} / "
            f"{row['ops_committed']}), fences {row['fences']}, flush fences "
            f"{row['flush_fences']}, redundant {row['redundant_fences']}")
    check(ledger["group"]["redundant_fences"] == 0,
          "group commit paid redundant fences")
    check(ledger["per_op"]["redundant_fences"] > 0,
          "the per-op read barrier flagged no redundant fence")
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")
    return dict(differential=diff, ycsb=ycsb, ledger=ledger)


# ---------------------------------------------------------------------------
# phase 8: the range index — BzTree shards under YCSB-E
# ---------------------------------------------------------------------------

# leaf_cap = root_cap = 64: a leaf of 129 words, an inner node of 130, a
# region of 390 (a root split's two halves and new root); a split's wide
# MwCAS is 132-135 words and a GC zeroing op up to 390, so both take the
# kernel's global route, while the waves' 3-word inserts take smem
TREE_CAP = 64
# YCSB-E at the ycsb cell's operation count; the record count is cut from
# its 1,048,576 as PERF.md §4 "Reduced" sets out
TREE_RECORDS, TREE_OPS = 1 << 18, 1 << 16
TREE_SAMPLE = 16                     # every 16th load wave is traced
TREE_WIDTHS = (132, 390)             # a leaf split's wide op; a full GC op


class BoundedClients:
    """Closed-loop clients: before each wave, ops are submitted in
    arrival order until ``window`` are outstanding (a client issues its
    next op once one of its own completes; ``window`` in flight in all),
    then the wave runs."""

    def __init__(self, svc, arrivals, window: int):
        self.svc, self.arrivals, self.window = svc, arrivals, window
        self.next = 0
        self.futures = []
        self.waves = 0

    @property
    def done(self) -> bool:
        return self.next >= len(self.arrivals) and not self.svc.pending_count

    def wave(self) -> None:
        room = self.window - self.svc.pending_count
        if room > 0 and self.next < len(self.arrivals):
            self.futures += [self.svc.submit(op, client=c) for c, op in
                             self.arrivals[self.next:self.next + room]]
            self.next += room
        self.svc.step()
        self.waves += 1

    def run(self, waves: Optional[int] = None, on_step=None) -> int:
        n = 0
        while not self.done and (waves is None or n < waves):
            self.wave()
            n += 1
            if on_step:
                on_step()
        return n


def tree_spec(st, records: int, ops: int, seed: int):
    """YCSB core workload E (95% scan, 5% insert, Zipfian 0.99) over a
    key universe of twice ``records``; the load inserts half of it, so an
    insert of a key not loaded is a real insert, as E's inserts of new
    records are."""
    spec = dataclasses.replace(st.YCSB_E, n_ops=ops, n_keys=2 * records,
                               alpha=0.99, seed=seed)
    check((spec.scan, spec.insert) == (0.95, 0.05), f"YCSB-E mix {spec}")
    return spec


def tree_expected_launches(svc, dispatches: int) -> dict:
    """The launches by route the tree path issues, worked out from the
    code: a stacked wave is one smem launch; every split (leaf, inner or
    root; ``splits`` counts them at their install) is a freeze, a region
    reserve and an install or swing (3 smem launches) plus ONE wide
    materialization of at least 132 words (global); a consolidation is a
    reserve, a freeze, a compacted image of at most 5 words and a swing
    (4 smem)."""
    splits = sum(t.splits for t in svc.structs)
    cons = sum(t.consolidations for t in svc.structs)
    return {"smem": dispatches + 3 * splits + 4 * cons, "global": splits}


def tree_slice(pm, svc_mod, st, obs, kernel, dev, seed: int,
               records: int = TREE_RECORDS, ops: int = TREE_OPS) -> dict:
    n_regions = records // N_SHARDS // 16
    window = ROUND_CAP * N_SHARDS
    spec = tree_spec(st, records, ops, seed)
    svc = svc_mod.KVService(N_SHARDS, structure="bztree", leaf_cap=TREE_CAP,
                            root_cap=TREE_CAP, n_regions=n_regions,
                            round_cap=ROUND_CAP, device=dev)
    W = svc.words_per_shard
    region = svc.structs[0].region_words
    check(all(b.word_table().device.type == dev.type and b.n_words == W
              for b in svc.backends) and all(
                  t.allocator.device.type == dev.type for t in svc.structs),
          "tree tables or free lists are not on the card")
    log(f"phase 8: KVService(n_shards={N_SHARDS}, structure='bztree', "
        f"leaf_cap={TREE_CAP}, root_cap={TREE_CAP}, n_regions={n_regions}, "
        f"round_cap={ROUND_CAP}) -> {N_SHARDS} x {W} words "
        f"({N_SHARDS * W * 4 / 2**20:.1f} MiB) on the card, regions of "
        f"{region} words")

    tracer = obs.get_tracer()
    load_split = WaveSplit(tracer)
    kernel.reset_counts()                     # count the main path only
    loader = BoundedClients(svc, [(0, op) for op in st.load_phase(spec, 0.5)],
                            window)
    load_prof = None
    t0 = time.perf_counter()
    while not loader.done:
        if loader.waves == 64 and load_prof is None and dev.type == "cuda":
            w0 = loader.waves
            by_name, count, wall_us = _profile(lambda: loader.run(8))
            load_prof = (by_name, count, wall_us, loader.waves - w0)
            continue
        traced = loader.waves % TREE_SAMPLE == TREE_SAMPLE - 1
        if traced:
            obs.enable_tracing()
        loader.wave()
        if traced:
            obs.disable_tracing()
            load_split()
    _sync(dev)
    load_s = time.perf_counter() - t0
    tracer.clear()
    load_futs = loader.futures
    check(all(f.status == st.OK for f in load_futs), "a tree load insert "
          "failed: " + json.dumps(collections.Counter(
              f.status for f in load_futs)))
    load_waves = svc.stats.steps
    dispatches = svc.executor.stats.dispatches + \
        svc.executor.stats.serial_rounds
    log(f"phase 8: loaded {len(load_futs)} records in {load_s:.3f} s "
        f"({load_waves} waves, {load_split.waves} traced, 8 profiled); "
        f"splits {[t.splits for t in svc.structs]}, root splits "
        f"{[t.root_splits for t in svc.structs]}, heights "
        f"{[t.height() for t in svc.structs]}")

    arrivals = _arrivals(st.client_streams(spec, N_CLIENTS))
    svc.reset_stats()
    svc.stats.latency_us.window = len(arrivals)
    runner = BoundedClients(svc, arrivals, window)
    t0 = time.perf_counter()
    runner.run()
    _sync(dev)
    run_s = time.perf_counter() - t0
    dispatches += svc.executor.stats.dispatches + \
        svc.executor.stats.serial_rounds
    launches = kernel.pmwcas_apply_cuda.launches
    routes = dict(kernel.pmwcas_apply_cuda.route_launches)
    stats = svc.stats
    run_futs = runner.futures
    # the YCSB-E window's numbers, taken before the GC, traced and
    # profiled windows below run on the same service
    run_waves, run_p50_us, run_p99_us = (
        stats.steps, stats.p50_latency_us, stats.p99_latency_us)
    run_splits = [t.splits for t in svc.structs]
    run_root_splits = [t.root_splits for t in svc.structs]
    kinds = collections.Counter(f"{f.op.kind} {f.status}" for f in run_futs)
    log(f"phase 8: YCSB-E {len(arrivals)} ops from {N_CLIENTS} clients in "
        f"{run_s:.3f} s: {len(arrivals) / run_s:.1f} ops/s, {run_waves} "
        f"waves, p50 {run_p50_us:.1f} us, p99 {run_p99_us:.1f} us; splits "
        f"{run_splits}, root splits {run_root_splits}; "
        f"{json.dumps(kinds)}")
    log("phase 8: stats " + json.dumps(stats.as_row()))

    check(all(f.done for f in run_futs), "a tree future is still pending")
    check(stats.by_status.get(st.EXHAUSTED, 0) == 0, "tree ops exhausted")
    check(stats.conflict_rate == 0.0,
          f"tree conflict_rate {stats.conflict_rate} != 0")
    check(all(sh.out_of_regions == 0 for sh in stats.shards),
          "a tree shard ran out of regions")
    items = svc.check_integrity()
    acked = acked_state(st, acked_state(st, {}, load_futs), run_futs)
    check(items == acked, "acknowledged tree inserts do not read back")
    heights = [t.height() for t in svc.structs]
    check(min(heights) >= 3 and all(t.root_splits >= 2 for t in svc.structs),
          f"tree heights {heights}: every shard must reach 3 (root splits)")
    keys = np.sort(np.fromiter(acked, np.int64, len(acked)))
    rng = np.random.default_rng(seed + 8)
    probes = [int(k) for k in rng.integers(1, 2 * records, 6)] + [1]
    got = [r.value for r in svc.apply([st.KVOp(st.SCAN, k) for k in probes])]
    want = [len(keys) - int(np.searchsorted(keys, k)) for k in probes]
    check(got == want, f"scans {got} != the sorted count {want}")
    expected = tree_expected_launches(svc, dispatches)
    splits = sum(t.splits for t in svc.structs)
    check(routes == expected and launches == sum(expected.values()),
          f"tree launches by route {routes} != worked out {expected} "
          f"({dispatches} waves, {splits} splits)")
    log(f"phase 8: integrity ok, every acknowledged insert reads back, "
        f"scans {got} == the sorted count, conflict_rate 0, heights "
        f"{heights}; launches by route {routes} == worked out from "
        f"{dispatches} waves and {splits} splits")

    # GC: every frozen split original is a full node, so each freed
    # region is one global zeroing op and one smem free
    before = dict(kernel.pmwcas_apply_cuda.route_launches)
    t0 = time.perf_counter()
    freed = svc.gc_regions()
    gc_ms = (time.perf_counter() - t0) * 1e3
    gc_routes = {r: kernel.pmwcas_apply_cuda.route_launches[r] - before[r]
                 for r in before}
    check(freed > 0 and gc_routes == {"smem": freed, "global": freed},
          f"GC freed {freed} regions with launches {gc_routes}")
    check(svc.check_integrity() == items, "GC changed the tree's items")
    log(f"phase 8: gc_regions freed {freed} regions in {gc_ms:.1f} ms "
        f"(launches {gc_routes}); integrity holds after it")

    # a traced window (host split) and a profiled one (device idle share)
    run_split = WaveSplit(tracer)
    obs.enable_tracing()
    try:
        traced = _arrivals(st.client_streams(
            dataclasses.replace(spec, n_ops=ops // 4, seed=seed + 1),
            N_CLIENTS))
        BoundedClients(svc, traced, window).run(on_step=run_split)
    finally:
        obs.disable_tracing()
        tracer.clear()
    profiled = _arrivals(st.client_streams(
        dataclasses.replace(spec, n_ops=ops // 8, seed=seed + 2), N_CLIENTS))
    prof_driver = BoundedClients(svc, profiled, window)
    run_prof = (_profile(lambda: prof_driver.run()) + (prof_driver.waves,)
                if dev.type == "cuda" else None)
    svc.check_integrity()
    idle = {}
    for what, prof in (("load", load_prof), ("run", run_prof)):
        if prof is None:
            idle[what] = None
            log(f"phase 8: {what} device busy not measured (no profiled "
                "window)")
            continue
        by_name, count, wall_us, waves = prof
        busy = sum(by_name.values()) or None
        idle[what] = None if busy is None else 1 - busy / wall_us
        log(f"phase 8: {what} device busy " + (
            "not measured" if busy is None else
            f"{busy:.1f} us of {wall_us:.1f} us wall over {waves} waves: "
            f"idle share {idle[what]:.4f} (profiler)"))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"phase 8:   {us / max(waves, 1):12.3f} us/wave  "
                f"{count[name] / max(waves, 1):6.2f}/wave  {name[:80]}")
    host = {"load": load_split.per_wave_us(), "run": run_split.per_wave_us()}
    for what, per in host.items():
        log(f"phase 8: {what} per-wave host split over "
            f"{(load_split if what == 'load' else run_split).waves} traced "
            "waves (tracing on), us/wave: "
            + json.dumps({k: round(v, 1) for k, v in per.items()}))
    return dict(records=records, ops=len(arrivals), n_regions=n_regions,
                words_per_shard=W, load_s=load_s, load_waves=load_waves,
                run_s=run_s, ops_per_s=len(arrivals) / run_s,
                waves=run_waves, p50_us=run_p50_us, p99_us=run_p99_us,
                launches=launches, routes=routes, splits=run_splits,
                root_splits=run_root_splits,
                heights=heights, freed=freed, gc_ms=gc_ms,
                gc_routes=gc_routes, idle=idle, host_split_us=host,
                svc=svc)


def tree_kernel_timings(pm, ref, kernel, svc, seed: int, dev) -> dict:
    """The global route at the tree's wide widths (``TREE_WIDTHS``: a
    leaf split's materialization, a GC op over a full region) on a copy
    of shard 0's table: one ``[1, 1, K]`` row of live words.  Kernel ==
    plain bit for bit first, twice: expected == current with random
    desired values and one id repeated (the row wins and stores), and
    with one expected value stale (the row loses and stores nothing).
    Then, with desired == expected so that every launch does the same
    full work, device µs per launch (profiler), the plain version's, and
    the bound."""
    rng = np.random.default_rng(seed + 9)
    words = svc.backends[0].word_table()[None].clone()
    host = pm.tensor_to_words(words)[0]
    live = np.flatnonzero(host)
    out = {}
    for K in TREE_WIDTHS:
        check(kernel.plan(1, K)[0] == "global", f"[1, 1, {K}] plan")
        addr = np.sort(rng.choice(live, K, replace=False)).astype(
            np.int32)[None, None]
        exp = host[addr]
        claim = kernel.claim_scratch(words)
        dup = addr.copy()
        dup[..., -1] = dup[..., 0]                 # one id twice in the row
        stale = exp.copy()
        stale[..., K // 2] += 1
        des = rng.integers(0, 1 << 32, addr.shape,
                           dtype=np.uint64).astype(np.uint32)
        for ad, ex, win in ((dup, host[dup], True), (addr, stale, False)):
            a, e, d = (pm.words_to_tensor(x, dev) for x in (ad, ex, des))
            w_k, w_p = words.clone(), words.clone()
            s_k = kernel.pmwcas_apply_cuda(w_k, a, e, d, claim=claim)
            _, s_p = ref.pmwcas_apply_stacked(w_p, a, e, d)
            torch.cuda.synchronize()
            check(bool(s_k.all()) == win and torch.equal(s_k, s_p)
                  and torch.equal(w_k, w_p) and
                  torch.equal(w_k, words) != win,
                  f"[1, 1, {K}] (the row {'wins' if win else 'loses'}): "
                  "kernel != plain")
        a, e = (pm.words_to_tensor(x, dev) for x in (addr, exp))
        d = e.clone()
        success = torch.empty((1, 1), dtype=torch.bool, device=dev)
        w_k, w_p = words.clone(), words.clone()
        run = (lambda: kernel.launch(w_k, a, e, d, success, route="global",
                                     claim=claim))
        us, n = _per_launch_us(run, 200, "pmwcas_apply")
        plain_dev, _ = _device_us(lambda: ref.pmwcas_apply_stacked(
            w_p, a, e, d), 20)
        ev_ms = _event_ms(run, 200)
        ms = us / 1e3 if us else ev_ms
        plain_ms = plain_dev / 20 / 1e3 if plain_dev else \
            _event_ms(lambda: ref.pmwcas_apply_stacked(w_p, a, e, d), 20)
        n_bytes = 3 * K * 4 + K * 4 + K * 4 + 1
        bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
        out[K] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      event_ms=ev_ms)
        log(f"phase 8: global route at [1, 1, {K}] on a {words.shape[1]}-"
            f"word table: kernel == plain (random desired values and a "
            f"repeated id: the row wins; a stale value: it loses); "
            f"{ms * 1e3:.3f} us/launch "
            f"({'profiler' if us else 'CUDA events'}, {n} launches seen), "
            f"stream time {ev_ms * 1e3:.3f} us back to back (CUDA events), "
            f"plain {plain_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.5f} us "
            f"({n_bytes} bytes)")
    return out


def tree_differential(st, pm, dev, seed: int) -> dict:
    """``run_struct_differential(structure="bztree")``: the tree on the
    card's kernel shard against the tree on durable shards, on a seeded
    workload that splits (leaf_cap 8, so a split's wide op takes the
    global route); then the card tree's rounds replayed on a CPU
    ``KernelBackend`` (verdicts and post-round words), and the same
    stream on a CPU tree: its word table must equal the card's bit for
    bit."""
    spec = st.WorkloadSpec(n_ops=96, n_keys=96, read=0.2, update=0.2,
                           insert=0.45, delete=0.1, scan=0.05, alpha=0.5,
                           seed=seed + 4, batch=8)
    kvops = st.load_phase(spec, 0.5) + st.compile_workload(spec)
    from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
    from repro_torch.structures.differential import _replay_rounds_on_sim
    shape = dict(leaf_cap=8, root_cap=4, n_regions=40)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tree_diff_") as root:
        sim_kernel.reset_counts()
        t0 = time.perf_counter()
        rep = st.run_struct_differential(kvops, structure="bztree",
                                         durable_root=root, device=dev,
                                         **shape)
        secs = time.perf_counter() - t0
        sim_launches = sim_kernel.pmwcas_sim_cuda.launches
        sim_routes = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
    check(rep.agree, "tree kernel != durable:\n" + rep.summary())
    check(sim_launches == rep.sim_rounds_checked > 0,
          f"the tree differential made {sim_launches} simulator launches "
          f"for {rep.sim_rounds_checked} rounds checked")
    # the simulator's share of the differential's time: its replay again,
    # alone (these launches come after the count was read)
    t0 = time.perf_counter()
    _replay_rounds_on_sim(rep.structs["kernel"].last_history, "ours", dev)
    sim_secs = time.perf_counter() - t0
    card = rep.structs["kernel"]
    check(card.splits >= 3 and card.root_splits >= 1,
          f"the differential's tree split {card.splits} times")
    replayed, ok = st.replay_rounds(card.last_history, device="cpu")
    check(ok, "the card tree's rounds replayed on the CPU disagree")
    cpu = st.BzTreeIndex(pm.KernelBackend(n_words=card.backend.n_words,
                                          device="cpu"), device="cpu",
                         **shape)
    cpu_res = cpu.apply(kvops)
    check([r.status for r in cpu_res] == rep.statuses["kernel"]
          and np.array_equal(cpu.backend.values(), card.backend.values())
          and np.array_equal(cpu.allocator.mask(), card.allocator.mask()),
          "the tree on the card != the same stream on the CPU")
    log(f"phase 8: run_struct_differential(bztree) kernel on the card == "
        f"durable ({len(kvops)} ops, {rep.rounds['kernel']} rounds, "
        f"{card.splits} splits, {card.root_splits} root splits, {secs:.2f} "
        f"s); {rep.sim_rounds_checked} rounds replayed on the simulator "
        f"kernel in {sim_launches} launches ({rep.sim_rounds_skipped} "
        f"skipped; the replay alone {sim_secs:.3f} s); {replayed} rounds "
        f"replayed on the CPU match; word table == the CPU tree's bit for "
        f"bit")
    return dict(ops=len(kvops), rounds=rep.rounds["kernel"],
                splits=card.splits, s=secs, sim_launches=sim_launches,
                sim_routes=sim_routes, sim_skipped=rep.sim_rounds_skipped,
                sim_s=sim_secs)


def raw_stream(seed: int, n_shards: int, words: int, n_ops: int,
               cross: float = 0.1):
    """Seeded raw increment-style ops over ``n_shards`` x ``words``: a
    few hot words a shard (shared targets, so rounds defer), expected
    values from a running model (80% current, so some fail (a)), and a
    ``cross`` share spanning two shards."""
    rng = np.random.default_rng(seed)
    model = np.zeros(n_shards * words, np.int64)
    out = []
    for _ in range(n_ops):
        k = int(rng.integers(1, 4))
        if rng.random() < cross:
            shards = rng.choice(n_shards, 2, replace=False)
            addrs = sorted({int(s) * words + int(rng.integers(words))
                            for s in shards})
        else:
            s = int(rng.integers(n_shards))
            addrs = sorted({s * words + int(rng.integers(words // 8))
                            for _ in range(k)})
        targets = []
        for a in addrs:
            exp = int(model[a]) + (0 if rng.random() < 0.8 else 1)
            targets.append((a, exp, exp + 1))
        for a, _e, d in targets:
            model[a] = d
        out.append(targets)
    return out


def scheduler_matches_cpu(pm, svc_mod, dev, seed: int) -> dict:
    """``BatchScheduler`` over 4 kernel shards on the card against the
    same over 4 CPU shards: one seeded raw stream (cross-shard ops among
    it) from 8 clients in windows; verdicts, latencies in rounds, the
    round/defer/cross counts and the tables must be equal."""
    stream = raw_stream(seed + 5, N_SHARDS, 1024, 8192)
    outs = []
    for device in (dev, torch.device("cpu")):
        backends = [pm.KernelBackend(n_words=1024, device=device)
                    for _ in range(N_SHARDS)]
        sched = svc_mod.BatchScheduler(
            backends, svc_mod.ShardRouter(N_SHARDS, words_per_shard=1024),
            round_cap=ROUND_CAP)
        futs = []
        t0 = time.perf_counter()
        for start in range(0, len(stream), 2048):
            futs += [sched.submit(pm.MwCASOp(t), client=i % N_CLIENTS)
                     for i, t in enumerate(stream[start:start + 2048])]
            sched.step()
        sched.drain()
        secs = time.perf_counter() - t0
        st_ = sched.stats
        outs.append(dict(
            verdicts=[(f.success, f.latency_rounds) for f in futs],
            tables=[b.values().tolist() for b in backends],
            counts=dict(steps=st_.steps, cross_rounds=st_.cross_rounds,
                        cross_ops=st_.cross_ops,
                        rounds=[s.rounds for s in st_.shards],
                        defers=[s.defers for s in st_.shards]),
            s=secs))
    card, cpu = outs
    check(card["verdicts"] == cpu["verdicts"] and card["tables"] ==
          cpu["tables"] and card["counts"] == cpu["counts"],
          "BatchScheduler on the card != on the CPU")
    won = sum(v for v, _r in card["verdicts"])
    check(card["counts"]["cross_ops"] > 0 and 0 < won < len(stream)
          and sum(card["counts"]["defers"]) > 0,
          f"the raw stream exercised too little: {card['counts']}")
    log(f"phase 8: BatchScheduler card == CPU on {len(stream)} raw ops "
        f"({won} won, {card['counts']['cross_ops']} cross-shard in "
        f"{card['counts']['cross_rounds']} global rounds, "
        f"{sum(card['counts']['defers'])} defers, {card['counts']['steps']}"
        f" waves; {card['s']:.2f} s on the card, {cpu['s']:.2f} s on the "
        "CPU)")
    return card["counts"]


def tree_phase(pm, ref, svc_mod, st, obs, kernel, dev, seed: int,
               records: int = TREE_RECORDS) -> dict:
    t0 = time.perf_counter()
    run = tree_slice(pm, svc_mod, st, obs, kernel, dev, seed, records)
    timings = tree_kernel_timings(pm, ref, kernel, run.pop("svc"), seed, dev)
    diff = tree_differential(st, pm, dev, seed)
    sched = scheduler_matches_cpu(pm, svc_mod, dev, seed)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    return dict(run=run, timings=timings, differential=diff,
                scheduler=sched)


# ---------------------------------------------------------------------------
# phase 9: the cycle-accurate simulator
# ---------------------------------------------------------------------------

# the CPU parity tests' configs (tests/test_torch_sim_core.py): a dense
# alpha = 1 schedule for each algorithm, ORIGINAL helping, 8-byte blocks
# (false sharing), the pinned ORIGINAL crash, a long alpha = 0 one
SIM_CASES = (
    ("ours", dict(n_threads=4, n_words=64, k=3, n_steps=1200, max_ops=32,
                  seed=3, alpha=1.0)),
    ("ours_df", dict(n_threads=4, n_words=64, k=3, n_steps=1200,
                     max_ops=32, seed=3, alpha=1.0)),
    ("original", dict(n_threads=8, n_words=32, k=2, n_steps=3000,
                      max_ops=32, seed=7, alpha=1.0)),
    ("pcas", dict(n_threads=4, n_words=64, k=1, n_steps=1200, max_ops=32,
                  seed=3, alpha=1.0)),
    ("ours", dict(n_threads=8, n_words=512, k=1, n_steps=3000, max_ops=128,
                  seed=7, alpha=1.0, block_bytes=8)),
    ("original", dict(n_threads=6, n_words=32, k=2, n_steps=600,
                      max_ops=16, seed=8016, alpha=1.0)),
    ("ours_df", dict(n_threads=4, n_words=256, k=3, n_steps=4000,
                     max_ops=64, seed=7)),
)
SIM_CUT = 365                        # run_until's cut in the checks
# the simulator's routes phase 9 runs: the plan's (smem, for every state
# of the phase but one wide SimBackend round) and global, forced
SIM_ROUTES = (None, "global")
# tests/test_recovery.py::test_crash_exhaustive_prefix: every crash point
# of a 400-step hot schedule over 16 words, per algorithm
CRASH_ALGS = (("ours", 3), ("ours_df", 3), ("original", 2), ("pcas", 1))
CRASH_KW = dict(n_threads=4, n_words=16, n_steps=400, max_ops=32, seed=3,
                alpha=1.0)
# the reference's pinned ORIGINAL fault (ROADMAP Queue 3): the same answer
# from both packages
PIN_CFG = dict(algorithm="original", n_threads=6, n_words=32, k=2,
               n_steps=600, max_ops=16, seed=8016, alpha=1.0)
PIN_STEP, PIN_MSG = 365, "words [15]: recovered=[1] expected=[2]"
# Figs. 9-10 (benchmarks/bench_threads.py:11-32) at the paper's 1e6 words
FIG_THREADS = (1, 4, 8, 16, 32, 56)
FIG_WORDS, FIG_STEPS, FIG_MAX_OPS, FIG_SEED = 1_000_000, 60_000, 512, 11
CLOCK_GHZ = 2.0                      # benchmarks/common.py:17
# dependent 4-byte loads on a step's critical path: the schedule entry,
# the thread's PC, its target index / op index, the target's address, the
# word (its line owner loads beside it)
STEP_DEP_LOADS = 5


def sim_diff(a: dict, b: dict) -> list:
    """The state fields where two host states differ (counters as int64)."""
    bad = []
    for name, x in a.items():
        x, y = np.asarray(x), np.asarray(b[name])
        if name == "counters":
            x, y = x.astype(np.int64), y.astype(np.int64)
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(name)
    return bad


def sim_err(a: dict, b: dict) -> int:
    """The largest absolute difference over every field of two host
    states of one shape (uint32 words compared as integers)."""
    return max(int(np.abs(np.asarray(x).astype(np.int64)
                          - np.asarray(b[name]).astype(np.int64)).max(
                              initial=0))
               for name, x in a.items())


def sim_specs(core, cases=SIM_CASES, cut=SIM_CUT) -> list:
    """Each case drained, and cut at ``cut`` without draining."""
    out = []
    for alg, kw in cases:
        cfg = core.SimConfig(algorithm=alg, **kw)
        out += [(cfg, None, None, True, None), (cfg, None, None, False, cut)]
    return out


def sim_held(specs, card_results, plain_results, what: str) -> int:
    """Hold every card result to the plain version's on the whole state
    and the drain rounds; returns the largest absolute difference seen (0:
    bit for bit)."""
    worst = 0
    for spec, got, want in zip(specs, card_results, plain_results):
        bad = sim_diff(got.state, want.state)
        check(not bad and got.drain_rounds == want.drain_rounds,
              f"{what}: the simulator kernel != plain for "
              f"{spec[0].algorithm} {spec[0]} (cut {spec[4]}) in {bad}, "
              f"drain rounds {got.drain_rounds} / {want.drain_rounds}")
        worst = max(worst, sim_err(got.state, want.state))
    return worst


def sim_run(core, sim_kernel, specs, dev, route, what: str) -> list:
    """``core.run_sims`` on the card on ``route`` (None: the plan's),
    checked to take ONE launch on the route wanted (the plan's: smem for
    every state here that fits)."""
    want = route or sim_kernel.plan(
        [sim_kernel.SimJob(spec[0], None, None) for spec in specs])[0]
    before = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
    results = core.run_sims(specs, device=dev, route=route)
    after = sim_kernel.pmwcas_sim_cuda.route_launches
    check({r: after[r] - before[r] for r in after} ==
          {r: int(r == want) for r in after},
          f"{what}: launches by route {before} -> {after}, not one on "
          f"{want}")
    return results


def sim_kernel_vs_plain(core, sim_kernel, dev) -> int:
    """(a) The kernel on each route (smem by the plan, global forced)
    against its plain version, bit for bit on the whole state: every case
    of ``SIM_CASES`` drained and cut, all four algorithms, in ONE mixed
    launch a route; then two of them alone."""
    specs = sim_specs(core)
    plain = core.run_sims(specs, device="cpu")
    err = 0
    for route in SIM_ROUTES:
        card = sim_run(core, sim_kernel, specs, dev, route, "mixed launch")
        err = max(err, sim_held(specs, card, plain,
                                f"mixed launch, {route or 'smem'}"))
        for i in (1, 4):
            alone = sim_run(core, sim_kernel, [specs[i]], dev, route,
                            "alone")[0]
            check(not sim_diff(alone.state, card[i].state),
                  "a simulation alone != the same in a mixed launch")
    log(f"phase 9: simulator kernel == plain bit for bit on the whole state "
        f"(max abs err {err}) for {len(specs)} simulations "
        f"({len(SIM_CASES)} configs x drained / cut at {SIM_CUT}, four "
        f"algorithms) in one mixed launch on each route (smem by the "
        f"plan, global forced); alone == batched")
    return err


def sim_crash_sweep(core, pm, sim_kernel, dev) -> dict:
    """(b) Every crash point 1-399 of ``test_crash_exhaustive_prefix``'s
    schedule for the four algorithms, as simulations of one launch a
    route; each recovers consistently and equals the plain version; then
    the pinned ORIGINAL example on each route, which must raise the
    reference's RecoveryError through ``SimSession.crash_at``."""
    specs = []
    for alg, k in CRASH_ALGS:
        cfg = core.SimConfig(algorithm=alg, k=k, **CRASH_KW)
        specs += [(cfg, None, None, False, s) for s in range(1, 400)]
    plain = core.run_sims(specs, device="cpu")
    err, secs, kernel_ms = 0, {}, {}
    for route in SIM_ROUTES:
        name = route or "smem"
        t0 = time.perf_counter()
        card = sim_run(core, sim_kernel, specs, dev, route, "crash sweep")
        secs[name] = time.perf_counter() - t0
        kernel_ms[name] = sim_kernel.pmwcas_sim_cuda.last_ms
        if route is None:
            for spec, r in zip(specs, card):
                core.check_crash_consistency(spec[0], r.state)
        err = max(err, sim_held(specs, card, plain, f"crash sweep, {name}"))
    pin = core.SimConfig(**PIN_CFG)
    want = core.run_until(pin, PIN_STEP, device="cpu")
    for route in SIM_ROUTES:
        got = core.run_until(pin, PIN_STEP, device=dev, route=route)
        check(not sim_diff(got.state, want.state),
              f"pinned case on {route or 'smem'}: kernel != plain")
    before = sim_kernel.pmwcas_sim_cuda.launches
    try:
        pm.SimSession().configure(**PIN_CFG).with_device(dev).crash_at(
            PIN_STEP)
        raised = None
    except core.RecoveryError as e:
        raised = str(e)
    check(sim_kernel.pmwcas_sim_cuda.launches == before + 1
          and sim_kernel.pmwcas_sim_cuda.last_route == "smem",
          "SimSession.crash_at did not launch the simulator kernel on smem")
    check(raised is not None and PIN_MSG in raised,
          f"the pinned ORIGINAL crash gave {raised!r}")
    log(f"phase 9: crash sweep, {len(specs)} crash points (1-399 x four "
        f"algorithms) in one launch a route: smem "
        f"{kernel_ms['smem']:.3f} ms, global {kernel_ms['global']:.3f} ms "
        f"({secs['smem']:.3f} / {secs['global']:.3f} s with set-up and "
        f"copies): all recover consistently, all == plain on both routes "
        f"(max abs err {err}); pinned ORIGINAL crash@{PIN_STEP} == plain "
        f"on both routes, RecoveryError({raised!r}) as in the reference")
    return dict(points=len(specs), s=secs, pinned=raised,
                kernel_ms=kernel_ms, err=err)


def backend_jobs(core, sim_kernel, dev, T: int, k: int, cap: int,
                 seed: int) -> list:
    """``SimBackend``'s mode (``MODE_BACKEND``) straight on the engine,
    one job an algorithm of ``k`` (PCAS at ``k = 1`` only): ``T`` threads,
    one op each over ``k`` sorted distinct words of ``2 * T * k``, drawn so
    ops share words, with an attempt cap of ``cap``."""
    rng = np.random.default_rng(seed)
    n_words = max(2 * T * k, 8)
    ops = np.stack([np.sort(rng.choice(n_words, k, replace=False))
                    for _ in range(T)]).astype(np.int32).reshape(T, 1, k)
    jobs = []
    for alg in ("ours", "ours_df", "original", "pcas"):
        if alg == "pcas" and k != 1:
            continue
        cfg = core.SimConfig(algorithm=alg, n_threads=T, n_words=n_words,
                             k=k, max_ops=1, n_steps=1)
        jobs.append(sim_kernel.SimJob(
            cfg, core.init_state(cfg, ops, device=dev),
            np.zeros(0, np.int32), mode=sim_kernel.MODE_BACKEND,
            attempt_cap=cap))
    return jobs


# (threads, k, attempt cap): SimBackend rounds; the cap of 2 stops every
# algorithm in its read phase, 12 in an attempt; 1,024 ops of k = 3 need
# more shared memory than a block has, so the plan sends them to global
BACKEND_CASES = ((64, 3, 10_000), (64, 1, 10_000), (16, 3, 2), (16, 3, 12),
                 (1024, 3, 10_000))


def sim_backend_modes(core, pm, sim_kernel, dev, seed: int) -> dict:
    """(b) ``SimBackend``'s mode on each route against the plain version:
    every ``BACKEND_CASES`` round, outputs (error, thread, steps) and the
    whole state after, the attempt-cap exits included; the wide round on
    ``global`` by the plan; then ``SimBackend`` itself (the four
    algorithms, smem by the plan) card == CPU."""
    O = sim_kernel
    routes, errs = {}, set()
    for T, k, cap in BACKEND_CASES:
        cpu = backend_jobs(core, sim_kernel, "cpu", T, k, cap, seed)
        planned = sim_kernel.plan(cpu)[0]
        check(planned == ("global" if T == 1024 else "smem"),
              f"SimBackend round [{T}, {k}] planned on {planned}")
        want = core.sim.run_jobs(cpu)
        errs.update(int(e) for e in want[:, O.O_ERR])
        for route in ((None,) if planned == "global" else SIM_ROUTES):
            jobs = backend_jobs(core, sim_kernel, dev, T, k, cap, seed)
            before = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
            got = core.sim.run_jobs(jobs, route=route)
            took = sim_kernel.pmwcas_sim_cuda.last_route
            check(took == (route or planned) and sim_kernel.pmwcas_sim_cuda
                  .route_launches[took] == before[took] + 1,
                  f"SimBackend round [{T}, {k}] ran on {took}")
            routes.setdefault(f"{T}x{k} cap {cap}", []).append(took)
            cols = [O.O_ERR, O.O_ERR_THREAD, O.O_STEPS]
            check(np.array_equal(got[:, cols], want[:, cols]),
                  f"SimBackend round [{T}, {k}] cap {cap} on {took}: "
                  f"outputs {got[:, cols].tolist()} != plain "
                  f"{want[:, cols].tolist()}")
            for a, b in zip(jobs, cpu):
                bad = sim_diff(core.state_to_arrays(a.state),
                               core.state_to_arrays(b.state))
                check(not bad, f"SimBackend round [{T}, {k}] cap {cap}, "
                      f"{a.cfg.algorithm} on {took}: state != plain in "
                      f"{bad}")
    errs = sorted(errs)
    check(errs == [0, O.ERR_READ_PHASE, O.ERR_ATTEMPT],
          f"the rounds stopped with errors {errs}")
    for alg in ("ours", "ours_df", "original", "pcas"):
        kk = 1 if alg == "pcas" else 3
        init, ops = pm.increment_batch(64, kk, 24, seed=seed + 5)
        outs = []
        for device in (dev, "cpu"):
            b = pm.SimBackend(64, algorithm=alg, values=init, device=device)
            outs.append(([r.success for r in b.execute(ops)],
                         b.values().tolist(), b.counters.tolist()))
        check(outs[0] == outs[1], f"SimBackend({alg}) card != CPU")
        check(sim_kernel.pmwcas_sim_cuda.last_route == "smem",
              f"SimBackend({alg}) ran on "
              f"{sim_kernel.pmwcas_sim_cuda.last_route}")
    log(f"phase 9: SimBackend's mode == plain on outputs and the whole "
        f"state for {len(BACKEND_CASES)} rounds (the attempt-cap exits "
        f"{errs} too), by route {routes}; SimBackend card == CPU for the "
        f"four algorithms on smem")
    return routes


def sim_struct_differential(st, dev, seed: int) -> dict:
    """(c) ``run_struct_differential(hashmap, algorithm="ours")`` on the
    card: kernel == durable, and every round replayed on the simulator
    kernel (one launch a round).  The ops are
    ``test_struct_differential_native_sim_no_shadow_skips``'s (inserts,
    an update, deletes and a re-insert of one key group: three rounds)
    over four key groups."""
    kvops = []
    for base in range(0, 96, 24):
        kvops += [st.KVOp(st.INSERT, base + k, ((base + k) << 8) | 1)
                  for k in (2, 6, 10, 14)]
        kvops += [st.KVOp(st.UPDATE, base + 2, 123456 + base + seed),
                  st.KVOp(st.DELETE, base + 6),
                  st.KVOp(st.INSERT, base + 18, 7),
                  st.KVOp(st.DELETE, base + 10),
                  st.KVOp(st.INSERT, base + 6, 999 + base)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sim_diff_") as root:
        rep = st.run_struct_differential(kvops, 64, algorithm="ours",
                                         durable_root=root, device=dev)
    check(rep.agree and rep.sim_rounds_checked > 0,
          "hash-map differential with the simulator:\n" + rep.summary())
    log(f"phase 9: run_struct_differential(hashmap, algorithm=ours) on the "
        f"card over {len(kvops)} ops: agree, {rep.sim_rounds_checked} "
        f"rounds checked on the simulator kernel, {rep.sim_rounds_skipped} "
        f"skipped")
    return dict(checked=rep.sim_rounds_checked,
                skipped=rep.sim_rounds_skipped)


def fig_specs(core, pm) -> list:
    """Figs. 9-10: threads x alpha; k = 3 x {ours, ours_df, original}, k =
    1 x {ours, ours_df, original, pcas}; drained runs, as ``run_cell``."""
    specs = []
    for fig, k, algs in ((9, 3, (pm.OURS, pm.OURS_DF, pm.ORIGINAL)),
                         (10, 1, (pm.OURS, pm.OURS_DF, pm.ORIGINAL,
                                  pm.PCAS))):
        for alpha in (0.0, 1.0):
            for t in FIG_THREADS:
                for alg in algs:
                    cfg = core.SimConfig(
                        algorithm=alg.name, n_threads=t, k=k,
                        n_words=FIG_WORDS, alpha=alpha, n_steps=FIG_STEPS,
                        max_ops=FIG_MAX_OPS, seed=FIG_SEED)
                    specs.append((f"fig{fig}_{alg.name}_t{t}_a{alpha:g}",
                                  (cfg, None, None, True, None)))
    return specs


def sim_bytes(cfg, state) -> int:
    """Bytes one drained simulation must move at least: every word its
    threads' ops touched (cache and pmem, read and written), the owner of
    every distinct line touched (read and written: the touched words'
    lines and, but for PCAS, which keeps no descriptor, the descriptor
    line of each thread that ran), the schedule, those ops' address and
    desired rows, and the per-thread registers, descriptors and counters
    read and written once."""
    ops, op_idx = np.asarray(state["ops"]), np.asarray(state["op_idx"])
    counters = np.asarray(state["counters"])
    rows = [ops[t, :min(int(op_idx[t]) + 1, cfg.max_ops)].reshape(-1)
            for t in range(cfg.n_threads)]
    words = np.unique(np.concatenate(rows).astype(np.int64))
    ran = sum(1 for t in range(cfg.n_threads)
              if int(op_idx[t]) > 0 or counters[t].any())
    lines = np.unique(words // cfg.words_per_line).size + (
        0 if cfg.algorithm == "pcas" else ran)
    n_rows = sum(r.size for r in rows)
    per_thread = sum(np.asarray(v).nbytes for name, v in state.items()
                     if name not in ("cache", "pmem", "line_owner", "ops",
                                     "ops_des"))
    return (words.size * 16 + lines * 8 + 4 * cfg.n_steps + 8 * n_rows
            + 2 * per_thread)


def sim_grid(core, pm, sim_kernel, pm_kernel, dev, seed: int) -> dict:
    """(d) The Figs. 9-10 grid at 1,000,000 words in ONE launch a route
    (smem by the plan, then global forced; the two equal bit for bit):
    modeled Mops at 2 GHz, CAS / flush / invalidations per op and p99 per
    cell; the zero-conflict counts at one thread; four full-size cells (t
    = 56, alpha = 1, one per algorithm) held to the plain version, whose
    time per step is extrapolated to the grid; the five slowest cells of
    each route by the kernel's own nanoseconds a simulation; the grid's
    latency bound (its longest simulation's steps x the latency floor of a
    step) beside its bytes bound; one simulation alone on each route for
    the time per step beside the floor."""
    named = fig_specs(core, pm)
    names = [n for n, _ in named]
    specs = [s for _, s in named]
    runs = {}
    for route in SIM_ROUTES:
        t0 = time.perf_counter()
        results = sim_run(core, sim_kernel, specs, dev, route, "the grid")
        wall = time.perf_counter() - t0
        out = sim_kernel.pmwcas_sim_cuda.last_out
        runs[route or "smem"] = dict(
            results=results, wall_s=wall,
            ms=sim_kernel.pmwcas_sim_cuda.last_ms,
            steps=sim_kernel.pmwcas_sim_cuda.last_steps,
            cell_steps=out[:, sim_kernel.O_STEPS].tolist(),
            cell_ns=out[:, sim_kernel.O_NS].tolist())
    results = runs["smem"]["results"]
    for name, a, b in zip(names, results, runs["global"]["results"]):
        check(not sim_diff(a.state, b.state)
              and a.drain_rounds == b.drain_rounds,
              f"{name}: the smem route's result != the global route's")
    cells = {}
    for (name, spec), r in zip(named, results):
        secs = r.wall_cycles / (CLOCK_GHZ * 1e9)
        cells[name] = dict(
            mops=r.ops_completed / secs / 1e6 if secs > 0 else 0.0,
            cas=r.per_op(pm.CNT_CAS), flush=r.per_op(pm.CNT_FLUSH),
            inval=r.per_op(pm.CNT_INVAL),
            p99=r.percentile_latency_cycles(99), ops=r.ops_completed)
        check(r.ops_completed > 0, f"{name} completed no op")
        log(f"phase 9: {name}: {cells[name]['mops']:.3f} Mops "
            f"(modeled at {CLOCK_GHZ:g} GHz), {cells[name]['ops']} ops, "
            f"cas/op {cells[name]['cas']:.4f}, flush/op "
            f"{cells[name]['flush']:.4f}, inval/op {cells[name]['inval']:.4f},"
            f" p99 {cells[name]['p99']:.1f} cycles/op")
    # zero-conflict counts (tests/test_pmwcas_core.py): one thread
    for alg in pm.STRATEGIES:
        for k in (3, 1):
            name = f"fig{9 if k == 3 else 10}_{alg.name}_t1_a0"
            if name not in cells:
                continue
            want = alg.cas_per_op(k) + (1 if alg is pm.ORIGINAL else 0)
            check(abs(cells[name]["cas"] - want) <= 0.01,
                  f"{name}: {cells[name]['cas']} CAS per op, not {want}")
    ratio = (cells["fig9_ours_t56_a1"]["mops"]
             / cells["fig9_original_t56_a1"]["mops"])
    # four full-size cells on the plain version, each route held to them
    held = {}
    plain_s = plain_steps = worst = 0
    for name in ("fig9_ours_t56_a1", "fig9_ours_df_t56_a1",
                 "fig9_original_t56_a1", "fig10_pcas_t56_a1"):
        i = names.index(name)
        cfg = specs[i][0]
        job = core_job(core, cfg)
        t1 = time.perf_counter()
        out = core.sim.run_jobs([job])[0]
        plain_s += time.perf_counter() - t1
        plain_steps += int(out[sim_kernel.O_STEPS])
        plain = core.state_to_arrays(job.state)
        for route, run in runs.items():
            got = run["results"][i]
            bad = sim_diff(got.state, plain)
            worst = max(worst, sim_err(got.state, plain))
            check(not bad and got.drain_rounds ==
                  int(out[sim_kernel.O_ROUNDS]),
                  f"{name}: the grid's {route} result != plain in {bad}")
            check(run["cell_steps"][i] == int(out[sim_kernel.O_STEPS]),
                  f"{name}: {run['cell_steps'][i]} steps on {route}, "
                  f"{int(out[sim_kernel.O_STEPS])} on the plain version")
        held[name] = int(out[sim_kernel.O_STEPS])
    plain_us_step = plain_s / plain_steps * 1e6
    plain_grid_ms = plain_us_step * runs["smem"]["steps"] / 1e3
    # the slowest cells of each route, by the kernel's own nanoseconds
    for route, run in runs.items():
        order = sorted(range(len(names)), key=lambda i: -run["cell_ns"][i])
        run["slowest"] = [dict(
            cell=names[i], steps=run["cell_steps"][i],
            ns=run["cell_ns"][i],
            ns_step=run["cell_ns"][i] / max(1, run["cell_steps"][i]))
            for i in order[:5]]
        log(f"phase 9: the grid's five slowest cells on {route}: " + "; ".join(
            f"{c['cell']} {c['steps']} steps {c['ns'] / 1e6:.3f} ms "
            f"({c['ns_step']:.1f} ns a step)" for c in run["slowest"]))
    # one simulation alone on each route: its time per step
    i56 = names.index("fig9_ours_t56_a1")
    for route in SIM_ROUTES:
        run = runs[route or "smem"]
        alone = sim_run(core, sim_kernel, [specs[i56]], dev, route,
                        "the cell alone")[0]
        run["alone_ms"] = sim_kernel.pmwcas_sim_cuda.last_ms
        run["alone_steps"] = sim_kernel.pmwcas_sim_cuda.last_steps
        run["alone_ns"] = int(sim_kernel.pmwcas_sim_cuda.last_out[
            0, sim_kernel.O_NS])
        run["step_us"] = run["alone_ms"] * 1e3 / run["alone_steps"]
        check(not sim_diff(alone.state, results[i56].state),
              f"the t56 ours cell alone on {route or 'smem'} != in the "
              f"grid's launch")
    # the latency of one dependent load (the PMwCAS kernel's probe): the
    # simulator's own kind (L1 cached) through a 16 KiB chain, and L2's
    # (__ldcg) through a 4 MiB one; each the slope over `trips` loads of
    # the device time per launch (profiler: stream time between launches
    # issued from Python holds the host's launch gaps, which can hide a
    # short probe), else of the stream time
    gen = torch.Generator(device=dev).manual_seed(seed)
    out1 = torch.empty(1, dtype=torch.int32, device=dev)
    trips, lat = 1024, {}
    for what, n in (("l1", 1 << 12), ("l2", 1 << 20)):
        chain = torch.randint(0, n, (n,), dtype=torch.int32, device=dev,
                              generator=gen)
        probes = {m: (lambda m=m: pm_kernel.latency_probe(
            chain, out1, m, l1=what == "l1")) for m in (0, trips)}
        us = {m: _per_launch_us(fn, 20, "latency")[0]
              for m, fn in probes.items()}
        if None in us.values():
            us = {m: _event_ms(fn, 20) * 1e3 for m, fn in probes.items()}
        lat[what] = (us[trips] - us[0]) / trips
    load_us = lat["l1"]
    floor_us = STEP_DEP_LOADS * load_us
    n_bytes = sum(sim_bytes(s[0], r.state) for s, r in zip(specs, results))
    bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
    longest = max(runs["smem"]["cell_steps"])
    latency_bound_ms = longest * floor_us / 1e3
    sm, gl = runs["smem"], runs["global"]
    log(f"phase 9: Figs. 9-10 grid, {len(specs)} simulations at "
        f"{FIG_WORDS} words, {FIG_STEPS} steps, max_ops {FIG_MAX_OPS}, seed "
        f"{FIG_SEED}, drained: ONE launch a route, smem {sm['ms']:.3f} ms, "
        f"global {gl['ms']:.3f} ms of stream time (CUDA events) for "
        f"{sm['steps']} steps ({sm['wall_s']:.3f} / {gl['wall_s']:.3f} s "
        f"wall with state set-up and copies), the two equal bit for bit; "
        f"plain version {plain_us_step:.3f} us a step over four full-size "
        f"cells ({plain_steps} steps, {plain_s:.3f} s; each == both "
        f"routes' results bit for bit), so the grid extrapolates to "
        f"{plain_grid_ms:.1f} ms on the plain version; ours/original at t "
        f"= 56, alpha = 1: {ratio:.4f}x Mops")
    for route, run in runs.items():
        log(f"phase 9: one simulation alone (fig9_ours_t56_a1) on {route}: "
            f"{run['alone_ms']:.3f} ms for {run['alone_steps']} steps = "
            f"{run['step_us']:.4f} us a step ({run['alone_ns']} ns in the "
            f"kernel)")
    log(f"phase 9: latency floor {STEP_DEP_LOADS} dependent loads x "
        f"{load_us:.4f} us (an L1 hit: the probe's slope of device time "
        f"over {trips} dependent 4-byte loads through a 16 KiB chain) = "
        f"{floor_us:.4f} us a step ({STEP_DEP_LOADS * lat['l2']:.4f} us "
        f"with every load from L2, {lat['l2']:.4f} us each); the grid's "
        f"latency bound {latency_bound_ms:.3f} ms (its longest simulation, "
        f"{longest} steps, x the floor), its bytes bound "
        f"{bound_ms * 1e3:.3f} us ({n_bytes} bytes at "
        f"{H100_BYTES_PER_S:.3g} B/s)")
    routes = {route: dict(
        grid_ms=run["ms"], wall_s=run["wall_s"], step_us=run["step_us"],
        alone_ms=run["alone_ms"], alone_steps=run["alone_steps"],
        alone_ns=run["alone_ns"], slowest=run["slowest"],
        cell_ns={n: v for n, v in zip(names, run["cell_ns"])})
        for route, run in runs.items()}
    return dict(cells=len(specs), grid_ms=sm["ms"], grid_steps=sm["steps"],
                global_grid_ms=gl["ms"], wall_s=sm["wall_s"],
                plain_us_step=plain_us_step, plain_grid_ms=plain_grid_ms,
                held=held, ratio=ratio, step_us=sm["step_us"],
                global_step_us=gl["step_us"],
                alone_steps=sm["alone_steps"], err=worst, load_us=load_us,
                l2_load_us=lat["l2"], floor_us=floor_us, bound_ms=bound_ms,
                latency_bound_ms=latency_bound_ms, longest_steps=longest,
                n_bytes=n_bytes, routes=routes,
                cell_steps={n: v for n, v in zip(names, sm["cell_steps"])},
                t56_a1={n: cells[n] for n in cells if n.endswith("t56_a1")})


def core_job(core, cfg):
    """A drained job of ``cfg`` on CPU tensors, for the plain driver."""
    from repro_torch.kernels.pmwcas_sim.kernel import SimJob
    return SimJob(cfg, core.init_state(cfg, device="cpu"),
                  core.generate_schedule(cfg), drain=True)


def sim_phase(core, pm, st, sim_kernel, pm_kernel, dev, seed: int) -> dict:
    t0 = time.perf_counter()
    sim_kernel.reset_counts()
    err = sim_kernel_vs_plain(core, sim_kernel, dev)
    crash = sim_crash_sweep(core, pm, sim_kernel, dev)
    backend = sim_backend_modes(core, pm, sim_kernel, dev, seed)
    diff = sim_struct_differential(st, dev, seed)
    before = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
    grid = sim_grid(core, pm, sim_kernel, pm_kernel, dev, seed)
    routes = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
    grid_routes = {r: routes[r] - before[r] for r in routes}
    check(grid_routes == {"smem": 2, "global": 2},
          f"the grid and the cell alone took {grid_routes} launches by "
          "route, not 2 on smem (the plan's) and 2 on global (forced)")
    launches = sim_kernel.pmwcas_sim_cuda.launches
    log("kernels: " + json.dumps({"pmwcas_sim phase 9": launches,
                                  "routes": routes}))
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return dict(err=max(err, crash["err"], grid["err"]), crash=crash,
                backend=backend, differential=diff, grid=grid,
                launches=launches, routes=routes)


# ---------------------------------------------------------------------------
# phase 10: chaos on the card
# ---------------------------------------------------------------------------

CHAOS_WAVES = 60                     # benchmarks/bench_chaos.py:31, not quick


def chaos_ints(report) -> dict:
    return {f.name: getattr(report, f.name)
            for f in dataclasses.fields(report)
            if type(getattr(report, f.name)) is int}


def chaos_mismatch(card, cpu) -> list:
    """The fields where two reports of one scenario differ: the canonical
    trace, the final items, every integer and the checker's stats."""
    out = []
    if card.trace_lines != cpu.trace_lines:
        first = next((i for i, (a, b) in enumerate(
            zip(card.trace_lines, cpu.trace_lines)) if a != b),
            min(len(card.trace_lines), len(cpu.trace_lines)))
        out.append(f"trace_lines (first difference at line {first})")
    if card.final_items != cpu.final_items:
        out.append("final_items")
    if chaos_ints(card) != chaos_ints(cpu):
        out.append(f"integers {chaos_ints(card)} != {chaos_ints(cpu)}")
    if dataclasses.asdict(card.check) != dataclasses.asdict(cpu.check):
        out.append("check stats")
    return out


def chaos_line(rep, wall_s: float) -> str:
    c, slo = rep.check, rep.slo
    return (f"phase 10: {rep.scenario.name}: {rep.ops_per_s:.1f} ops/s, "
            f"p99 {rep.p99_latency_us:.1f} us, {rep.waves_run} waves, "
            f"{rep.ops_completed}/{rep.ops_invoked} ops, {rep.crashes} "
            f"crashes, {rep.faults_fired} faults fired, {c.immediates}/"
            f"{c.mutations}/{c.indeterminate} immediates/mutations/"
            f"indeterminate, slo_ok {slo['ok']}, WAL {rep.wal_records} "
            f"records / {rep.wal_pruned} pruned, {wall_s:.3f} s wall")


def chaos_sweep_cell(chaos, obs, dev, scenarios) -> dict:
    """(a) ``scenarios`` (``default_scenarios``) on the card, traced, with
    ``bench_chaos.py``'s assertions as hard checks, and one real history
    tampered."""
    tracer = obs.enable_tracing(capacity=1 << 20).clear()
    reports, drivers, walls = [], [], []
    try:
        with tempfile.TemporaryDirectory(prefix="chaos_smoke_") as tmp:
            for i, sc in enumerate(scenarios):
                root = (f"{tmp}/run{i}" if sc.backend == "durable"
                        else None)
                t0 = time.perf_counter()
                driver = chaos.ScenarioDriver(sc, durable_root=root,
                                              device=dev)
                rep = driver.run()
                walls.append(time.perf_counter() - t0)
                log(chaos_line(rep, walls[-1]))
                reports.append(rep)
                drivers.append(driver)
    finally:
        obs.disable_tracing()
    events = tracer.events()
    check(tracer.dropped == 0, f"the tracer dropped {tracer.dropped} events")
    obs.validate_chrome_trace(obs.chrome_trace(tracer))
    durable = [r for r in reports if r.scenario.backend == "durable"]
    check(len(reports) == 7 and len(durable) == 6,
          f"{len(reports)} scenarios, {len(durable)} durable")
    for rep in reports:
        check(rep.check is not None and rep.check.ok,
              f"{rep.scenario.name}: history not linearizable")
        obs.validate_slo_report(rep.slo)
        evals = sum(s["evaluations"] for s in rep.slo["specs"])
        check(evals > 0, f"{rep.scenario.name}: SLOs never evaluated")
        check(rep.slo["observations"] == rep.scenario.waves,
              f"{rep.scenario.name}: {rep.slo['observations']} SLO "
              f"observations for {rep.scenario.waves} waves")
    crashes = sum(r.crashes for r in durable)
    pruned = sum(r.wal_pruned for r in durable)
    check(crashes >= 2, f"the sweep injected only {crashes} crashes")
    check(pruned > 0, "the WAL prune cadence never ran under chaos")
    for rep in durable:
        check(rep.wal_records < max(1, rep.ops_completed),
              f"{rep.scenario.name}: {rep.wal_records} WAL records for "
              f"{rep.ops_completed} ops")
    # where the sweep's time goes: host ms by span name (nested spans
    # count inside their parents too), the ten largest
    spans = collections.Counter()
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] += e["dur"] / 1e3
    top = dict(spans.most_common(10))
    log("phase 10 (a): host ms by span: " + ", ".join(
        f"{name} {ms:.1f}" for name, ms in top.items()))
    faults = [e for e in events if e["name"] == "chaos.fault"]
    check(faults and all(e["ph"] == "i" for e in faults),
          "faults fired but no chaos.fault instant reached the trace")
    traced_crashes = sum(1 for e in faults if e["args"]["kind"] == "crash")
    check(traced_crashes == sum(r.crashes for r in reports),
          f"{traced_crashes} crash instants for "
          f"{sum(r.crashes for r in reports)} crashes")
    # the checker's rejection power on a real card history
    history = list(drivers[0].recorder.events)
    idx = next(i for i, ev in enumerate(history)
               if ev[0] == "complete" and ev[3] == "ok" and ev[4] is not None)
    wave, seq, status, val = history[idx][1:]
    history[idx] = ("complete", wave, seq, status, (val or 0) + 1)
    try:
        chaos.check_history(history)
    except chaos.LinearizabilityError as e:
        rejected = str(e)
    else:
        raise SmokeFailure("a tampered card history passed the checker")
    log(f"phase 10: tampered {reports[0].scenario.name} history rejected: "
        f"{rejected}")
    families = {r.scenario.family: dict(
        ops_per_s=r.ops_per_s, p99_latency_us=r.p99_latency_us,
        waves=r.waves_run, ops_completed=r.ops_completed,
        ops_invoked=r.ops_invoked, crashes=r.crashes,
        faults_fired=r.faults_fired, migrations=r.migrations,
        immediates=r.check.immediates, mutations=r.check.mutations,
        indeterminate=r.check.indeterminate, slo_ok=r.slo["ok"],
        wal_records=r.wal_records, wal_pruned=r.wal_pruned,
        elapsed_s=r.elapsed_s, wall_s=w) for r, w in zip(reports, walls)}
    return dict(families=families, crashes=crashes, wal_pruned=pruned,
                fault_instants=len(faults), trace_events=len(events),
                span_ms=top, wall_s=sum(walls))


def kernel_storm(chaos, seed: int, waves: int):
    """``hot_key_storm`` on kernel shards with only its shard storm (kernel
    shards cannot crash: ``KVService.crash`` refuses them)."""
    sc = chaos.hot_key_storm(seed=seed, waves=waves)
    return dataclasses.replace(sc, backend="kernel", faults=tuple(
        f for f in sc.faults if f.kind == chaos.SHARD_STORM))


def chaos_on_card(chaos, scenario, dev, reset, count):
    """Run ``scenario`` on the card with the launch counts zeroed just
    before and read just after, then again under the profiler for its
    device time, then on the CPU.  Returns the card driver, the counts,
    the card and CPU reports, wall s and the busy share: the profiled
    device time over the unprofiled run's wall time (the profiler slows
    the host, so its own wall time would understate the share)."""
    reset()
    t0 = time.perf_counter()
    driver = chaos.ScenarioDriver(scenario, device=dev)
    card = driver.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = count()
    by_name, _, _ = _profile(
        lambda: chaos.ScenarioDriver(scenario, device=dev).run())
    busy_us = sum(by_name.values())
    cpu = chaos.ScenarioDriver(scenario, device="cpu").run()
    return driver, counts, card, cpu, wall_s, (
        busy_us / (wall_s * 1e6) if busy_us > 0 else None)


def chaos_phase(chaos, obs, pm_kernel, sim_kernel, dev, seed: int) -> dict:
    t0 = time.perf_counter()
    scenarios = chaos.default_scenarios(seed=seed, waves=CHAOS_WAVES)
    sweep = chaos_sweep_cell(chaos, obs, dev, scenarios)
    log(f"phase 10 (a): the sweep took {sweep['wall_s']:.3f} s")

    # (b) the PMwCAS kernel under a shard storm, card == CPU
    driver, routes, card, cpu, storm_s, storm_busy = chaos_on_card(
        chaos, kernel_storm(chaos, seed, CHAOS_WAVES), dev,
        pm_kernel.reset_counts,
        lambda: dict(pm_kernel.pmwcas_apply_cuda.route_launches))
    log(chaos_line(card, storm_s))
    bad = chaos_mismatch(card, cpu)
    check(not bad, f"kernel storm: card != CPU in {bad}")
    check(card.check.ok and card.crashes == 0 and card.faults_fired > 0,
          "kernel storm: not linearizable, crashed, or no storm fired")
    disp = driver.svc.stats.dispatch
    check(routes["global"] == 0 and routes["smem"] ==
          disp.dispatches + disp.serial_rounds and disp.dispatches > 0,
          f"kernel storm: launches {routes} for {disp.dispatches} "
          f"dispatches and {disp.serial_rounds} serial rounds")
    log(f"phase 10 (b): {routes} launches for {disp.dispatches} stacked "
        f"dispatches; device busy share "
        + (f"{storm_busy:.4f}" if storm_busy is not None else
           "not measured (the profiler saw no device time)"))
    storm = dict(routes=routes, dispatches=disp.dispatches, wall_s=storm_s,
                 busy_share=storm_busy, ops_per_s=card.ops_per_s,
                 p99_latency_us=card.p99_latency_us)

    # (c) the simulator kernel under chaos, card == CPU
    sim_sc = next(sc for sc in scenarios if sc.family == "sim_native")
    driver, (sim_launches, sim_routes), card, cpu, sim_s, sim_busy = \
        chaos_on_card(chaos, sim_sc, dev, sim_kernel.reset_counts,
                      lambda: (sim_kernel.pmwcas_sim_cuda.launches,
                               dict(sim_kernel.pmwcas_sim_cuda
                                    .route_launches)))
    log(chaos_line(card, sim_s))
    bad = chaos_mismatch(card, cpu)
    check(not bad, f"sim_native: card != CPU in {bad}")
    check(card.check.ok and card.check.mutations > 0,
          "sim_native: not linearizable or no mutation")
    rounds = driver.svc.stats.rounds
    check(sim_launches == rounds and rounds > 0,
          f"sim_native: {sim_launches} simulator launches for {rounds} "
          "shard rounds")
    log(f"phase 10 (c): {sim_launches} simulator launches for {rounds} "
        f"shard rounds (by route {sim_routes}); device busy share "
        + (f"{sim_busy:.4f}" if sim_busy is not None else
           "not measured (the profiler saw no device time)"))
    wall = time.perf_counter() - t0
    log(f"phase 10 took {wall:.1f} s")
    return dict(sweep=sweep, storm=storm, sim=dict(
        launches=sim_launches, routes=sim_routes, rounds=rounds, wall_s=sim_s,
        busy_share=sim_busy, ops_per_s=card.ops_per_s,
        p99_latency_us=card.p99_latency_us), wall_s=wall)


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

# the flash op's training call at the cell's shape: q [64, 4096, 128], k/v
# [16, 4096, 128] (llama3-8b's 32 heads over 8 kv heads, batch 2, 4096
# tokens), causal
TRAIN_FA_CASE = FACase("train_llama3_8b_s4096", 2, 8, 4, 4096, 4096, 128,
                       True, 0, 0.0, "tc")
# the log-sum-exp against the plain version's, absolute: f32 as asked of
# the simt route; bf16 from the readings (PERF.md section 6)
FA_LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


def fa_lse_route(case: FACase, dtype) -> str:
    """The route of a training (log-sum-exp) call: never ``decode``."""
    return ("tc" if dtype == torch.bfloat16 and case.hd in (64, 128, 256)
            else "simt")


def fa_lse_vs_plain(fa_kernel, fa_ref, seed: int, dev) -> dict:
    """Phase 11 (a): the flash kernel's training launch (``lse=True``)
    against the plain version on the same inputs, over ``FA_CHECK_CASES``
    and the cell's training shape, in f32 and bf16.  ``out`` is held as
    phase 2 holds it (``fa_close``), ``lse`` to ``FA_LSE_TOL``; each call
    must take ``tc`` or ``simt``, never ``decode``.  Where a serving
    launch takes the same route, its output (a null lse pointer) must
    equal the training launch's bit for bit.  Returns the worst errors by
    dtype and the launches by route."""
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    routes = collections.Counter()
    same = 0
    for case in FA_CHECK_CASES + [TRAIN_FA_CASE]:
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = fa_case_inputs(case, dtype, dev, seed)
            before = dict(fa_kernel.flash_attention_cuda.route_launches)
            got, lse = fa_kernel.flash_attention_cuda(*args, **kw, lse=True)
            after = fa_kernel.flash_attention_cuda.route_launches
            took = [r for r in after if after[r] != before[r]]
            want_route = fa_lse_route(case, dtype)
            check(took == [want_route], f"training flash {case.name} "
                  f"{dtype} took {took}, not {want_route}")
            routes[want_route] += 1
            want, want_lse = fa_ref.flash_attention_flat_lse(*args, **kw)
            _sync(dev)
            ok, err = fa_close(got, want, dtype)
            lerr = float((lse - want_lse).abs().max())
            check(ok, f"training flash out != plain at {case.name} {dtype}:"
                  f" max abs err {err}")
            check(lse.shape == want_lse.shape and lse.dtype == torch.float32
                  and bool(torch.isfinite(lse).all())
                  and lerr <= FA_LSE_TOL[dtype],
                  f"training flash lse != plain at {case.name} {dtype}: "
                  f"max abs err {lerr} (limit {FA_LSE_TOL[dtype]})")
            name = "float32" if dtype == torch.float32 else "bfloat16"
            worst[name] = [max(worst[name][0], err),
                           max(worst[name][1], lerr)]
            if fa_route(case, dtype) == want_route:
                serve = fa_kernel.flash_attention_cuda(*args, **kw)
                check(torch.equal(serve, got), f"{case.name} {dtype}: the "
                      f"serving launch differs from the training launch")
                same += 1
            del args, got, lse, want, want_lse
    torch.cuda.empty_cache()
    n = len(FA_CHECK_CASES) + 1
    log(f"phase 11 (a): training flash (lse) == plain on {n} cases x "
        f"{{f32, bf16}}, launches by route {json.dumps(routes)}: out max abs"
        f" err f32 {worst['float32'][0]:.3e} / bf16 "
        f"{worst['bfloat16'][0]:.3e}; lse max abs err f32 "
        f"{worst['float32'][1]:.3e} (limit {FA_LSE_TOL[torch.float32]}) / "
        f"bf16 {worst['bfloat16'][1]:.3e} (limit "
        f"{FA_LSE_TOL[torch.bfloat16]}); {same} serving launches (null lse)"
        f" equal the training launch bit for bit")
    return dict(worst=worst, routes=dict(routes), same=same)


# (b) small training, card against CPU: the llama3-8b smoke config in f32
# (head_dim 8: the simt route) and bf16 at head_dim 128 (the tc route),
# SMALL_STEPS AdamW steps from the same float32 masters on the same
# batches, key chunks of SMALL_CHUNK so the backward runs several.
# Limits per step: the loss (absolute) and every master's gradient in
# relative norm ||g_card - g_cpu|| / ||g_cpu||, set from the readings
# (PERF.md section 6) and checked on every run to lie below what planted
# faults in the CPU's attention read (TRAIN_FAULTS).
SMALL_STEPS, SMALL_SEQ, SMALL_BATCH, SMALL_CHUNK = 3, 64, 2, 16
SMALL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 5e-2)}
TRAIN_FAULTS = ("lse_off_by_log2", "delta_dropped")
MOE_TRAIN_FAULTS = ("pos_shifted", "aux_dropped")
# a fault planted in the CPU's training for each recurrent block an arch
# has: mLSTM's forget-gate bias lost (left at zero), sLSTM's recurrent
# matrices applied transposed, Mamba's conv taps in reverse order
BLOCK_TRAIN_FAULTS = {"mlstm": "b_f_dropped", "slstm": "r_transposed",
                      "mamba": "conv_flipped"}
# The xLSTM blocks' input-gate biases: a block's output hardly moves when
# all of a head's input-gate preactivations shift (the shift cancels
# between numerator and denominator, save where a floor binds or at the
# init state), so their gradients are sums that cancel to ~1e-3 of their
# terms, and float32 runs of one mLSTM lie 1e-3 from a float64 one
# (tests/test_torch_hybrid_models.py).  Card against CPU, relative to its
# own norm, mLSTM's read 6.7e-3 in float32 and 5.8e-2 and 0.22 in bf16 on
# two H100 runs, sLSTM's 4.4e-2 in bf16 (PERF.md section 6): rounding
# noise.  So a bias's difference is measured against the norm of the same
# layer's input-gate weight gradient and held to the other masters' limit.
def _b_i_scale(name: str) -> str:
    for block in (".mlstm.", ".slstm."):
        if block + "b_i" in name:
            return name.replace(block + "b_i", block + "w_i")
    return name


# an arch with mLSTM layers, float32: the block's other gradients pass
# through its normalizer max(|q.n|, exp(-m)), whose |q.n| cancels; float32
# runs of either library lie up to 1.5e-3 from float64 there
# (tests/test_torch_xlstm.py), and card against CPU read 7.3e-4 (wq),
# 6.3e-4 (wk), 5.3e-4 (up_proj) over three steps (PERF.md section 6)
MLSTM_F32_GRAD_TOL = 2e-3


def small_train_config(get_config, dtype: str, arch: str = "llama3-8b",
                       head_dim: int = 128):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=dtype, attn_impl="chunked",
                              attn_chunk=SMALL_CHUNK)
    return dataclasses.replace(cfg, head_dim=head_dim) \
        if dtype == "bfloat16" else cfg


@contextlib.contextmanager
def planted(attn_mod, fault: Optional[str], moe_mod=None):
    """A planted fault: in the attention backward, the log-sum-exp off by
    log 2 (a kernel's lse in the wrong base or offset) or ``delta``
    dropped (the backward fed a zero output, so ``sum(do * out)`` is 0);
    in the MoE layer (``moe_mod``), the tie order of the top-k reversed
    (``tie_rule_dropped``), every capacity rank one too high
    (``pos_shifted``) or the aux loss dropped (``aux_dropped``); in the
    recurrent blocks, mLSTM's stabilizer without its running maximum
    (``no_cummax``) or its forget-gate bias lost (``b_f_dropped``),
    sLSTM's normalizer floor removed (``no_n_floor``)
    or its recurrent matrices applied transposed (``r_transposed``),
    Mamba's cached conv state read one step off (``conv_state_shifted``)
    or its conv taps in reverse order (``conv_flipped``); the decoder's
    cross-attention made causal (``cross_causal``)."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xlstm_mod
    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault in ("lse_off_by_log2", "delta_dropped"):
        orig = attn_mod._flash_backward

        def faulty(q, k, v, q_pos, k_pos, out, lse, do, **kw):
            if fault == "lse_off_by_log2":
                lse = lse + float(np.log(2.0))
            else:
                out = torch.zeros_like(out)
            return orig(q, k, v, q_pos, k_pos, out, lse, do, **kw)

        patch(attn_mod, "_flash_backward", faulty)
    elif fault == "tie_rule_dropped":
        stable = moe_mod.topk_stable

        def higher_first(probs, k):      # the higher id first among equals
            vals, ids = stable(probs.flip(-1), k)
            return vals, probs.shape[-1] - 1 - ids

        patch(moe_mod, "topk_stable", higher_first)
    elif fault == "pos_shifted":
        route = moe_mod.route

        def shifted(probs, k, capacity):
            r = route(probs, k, capacity)
            return r._replace(pos=r.pos + 1, keep=r.pos + 1 < capacity)

        patch(moe_mod, "route", shifted)
    elif fault == "aux_dropped":
        apply_moe = moe_mod.apply_moe

        def no_aux(*a, **kw):
            y, aux = apply_moe(*a, **kw)
            return y, aux * 0.0

        patch(moe_mod, "apply_moe", no_aux)
    elif fault == "no_cummax":
        patch(xlstm_mod, "_running_max", lambda a: a)
    elif fault == "b_f_dropped":
        apply_mlstm = xlstm_mod.apply_mlstm

        def no_forget_bias(p, *a, **kw):
            return apply_mlstm(dict(p, b_f=p["b_f"] * 0.0), *a,
                               **kw)

        patch(xlstm_mod, "apply_mlstm", no_forget_bias)
    elif fault == "no_n_floor":
        patch(xlstm_mod, "N_FLOOR", 0.0)
    elif fault == "r_transposed":
        apply_slstm = xlstm_mod.apply_slstm

        def transposed(p, *a, **kw):
            p = dict(p, **{f"r_{g}": p[f"r_{g}"].T for g in "zifo"})
            return apply_slstm(p, *a, **kw)

        patch(xlstm_mod, "apply_slstm", transposed)
    elif fault == "cross_causal":
        attention = attn_mod.attention

        def causal_cross(*a, **kw):
            if kw.get("kv") is not None:
                kw["causal"] = True
            return attention(*a, **kw)

        patch(attn_mod, "attention", causal_cross)
    elif fault in ("conv_state_shifted", "conv_flipped"):
        apply_mamba = ssm_mod.apply_mamba

        def faulty_mamba(p, x, **kw):
            state = kw.get("state")
            if fault == "conv_flipped":
                p = dict(p, conv_w=p["conv_w"].flip(0))
            elif state is not None:         # read one step off
                kw["state"] = dict(state, conv=state["conv"].roll(1, 1))
            return apply_mamba(p, x, **kw)

        patch(ssm_mod, "apply_mamba", faulty_mamba)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def with_frames(cfg, batch: dict, seed: int) -> dict:
    """``batch`` with ``frontend_embeds [B, frontend_len, frontend_dim]``
    (float32 normals from numpy, seeded) for an arch with a frontend; the
    synthetic stream makes tokens only, as the reference's does."""
    if cfg.frontend == "none":
        return batch
    B = np.asarray(batch["tokens"]).shape[0]
    fe = np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return dict(batch, frontend_embeds=fe)


def _grads_and_step(model, adamw, opt_cfg, opt, batch) -> tuple:
    """One training step that keeps its gradients: ``(loss, {name:
    grad})``; the masters and ``opt`` are updated in place."""
    params = model.param_dict()
    for t in params.values():
        t.grad = None
    loss = model.train_loss(batch)
    loss.backward()
    grads = {n: t.grad.detach().clone() for n, t in params.items()}
    adamw.update(opt_cfg, {n: t.grad for n, t in params.items()}, opt,
                 params)
    return float(loss.detach()), grads


def _grad_errs(a: dict, b: dict) -> dict:
    """Every master's ``||a - b|| / ||b||`` (mLSTM's ``b_i`` over its
    layer's ``w_i`` gradient instead, :func:`_b_i_scale`)."""
    return {n: float((a[n].float().cpu() - b[n].float().cpu()).norm()
                     / b[_b_i_scale(n)].float().cpu().norm().clamp_min(1e-30))
            for n in b}


def _grad_err(a: dict, b: dict) -> float:
    return max(_grad_errs(a, b).values())


def small_train_matches_cpu(get_config, TrainModel, adamw, data, attn_mod,
                            fa_kernel, dtype: str, seed: int, dev,
                            arch: str = "llama3-8b", head_dim: int = 128,
                            tag: str = "phase 11 (b)",
                            faults_of: Optional[tuple] = None) -> dict:
    """Phase 11 (b) for one dtype: the card's run against the CPU's, step
    by step (loss and every gradient); the planted faults on the CPU's
    first step against its sound first step.  On the card every flash
    call takes the route of the dtype, twice an attention layer a step
    (remat).  For an MoE arch the CPU runs first and the card takes its
    routing (:func:`routing_record`; its own choices may differ only at
    near-ties), and the MoE faults are planted too; for each recurrent
    block an arch has, its ``BLOCK_TRAIN_FAULTS`` fault (the attention
    faults only where there is attention); ``faults_of`` names the
    faults instead."""
    from repro_torch.models import moe as moe_mod
    cfg = small_train_config(get_config, dtype, arch, head_dim)
    counts = layer_counts(cfg)
    if faults_of is None:
        faults_of = ((TRAIN_FAULTS if counts["attn"] else ())
                     + (MOE_TRAIN_FAULTS if cfg.moe else ())
                     + tuple(f for k, f in BLOCK_TRAIN_FAULTS.items()
                             if counts[k]))
    cpu = TrainModel(cfg, device="cpu", seed=seed)
    card = copy.deepcopy(cpu).to(dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=SMALL_STEPS)
    stream = data.SyntheticStream(data.DataConfig(
        vocab=cfg.vocab, seq_len=SMALL_SEQ, global_batch=SMALL_BATCH,
        seed=seed))
    batches = [with_frames(cfg, stream.next_batch(), seed + i)
               for i in range(SMALL_STEPS)]
    faults = {}
    for fault in faults_of:
        with planted(attn_mod, fault, moe_mod):
            m = copy.deepcopy(cpu)
            faults[fault] = _grads_and_step(
                m, adamw, opt_cfg, adamw.init_state(opt_cfg, m.param_dict()),
                batches[0])
    runs, recs = {}, {}
    for name, model in (("cpu", cpu), ("card", card)):
        opt = adamw.init_state(opt_cfg, model.param_dict())
        before = dict(fa_kernel.flash_attention_cuda.route_launches)
        with routing_record(moe_mod, recs.get("cpu")) as recs[name]:
            runs[name] = [_grads_and_step(
                model, adamw, opt_cfg, opt,
                {k: torch.as_tensor(v, device=model.device)
                 for k, v in b.items()}) for b in batches]
    _sync(dev)
    routes = {r: n - before[r] for r, n in
              fa_kernel.flash_attention_cuda.route_launches.items()}
    flips = routing_flips(recs["card"], recs["cpu"], ROUTE_GAP_EPS[dtype])
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(runs["card"],
                                                      runs["cpu"]))
    by_master = collections.Counter()
    for a, b in zip(runs["card"], runs["cpu"]):
        for n, e in _grad_errs(a[1], b[1]).items():
            by_master[n] = max(by_master[n], e)
    grad_err = max(by_master.values())
    sound = runs["cpu"][0]
    fault_err = {f: dict(loss=abs(r[0] - sound[0]),
                         grad=_grad_err(r[1], sound[1]))
                 for f, r in faults.items()}
    loss_tol, grad_tol = SMALL_TOL[dtype]
    if counts["mlstm"]:
        grad_tol = max(grad_tol, MLSTM_F32_GRAD_TOL)
    route = "tc" if dtype == "bfloat16" else "simt"
    want = dict.fromkeys(fa_kernel.ROUTES, 0)
    want[route] = 2 * flash_calls(cfg)[0] * SMALL_STEPS
    if dev.type == "cuda":
        check(routes == want, f"small training {dtype}: flash routes "
              f"{routes}, not {want}")
    check(all(np.isfinite(r[0]) for r in runs["card"]),
          f"small training {dtype}: non-finite loss on the card")
    check(loss_err <= loss_tol and grad_err <= grad_tol,
          f"small training {dtype}: card != CPU (loss err {loss_err:.3e}, "
          f"limit {loss_tol}; grad err {grad_err:.3e}, limit {grad_tol}; the "
          f"largest {json.dumps(by_master.most_common(4))})")
    for f, e in fault_err.items():
        check(e["grad"] > grad_tol, f"planted fault {f} reads grad err "
              f"{e['grad']:.3e}, within the limit {grad_tol}")
    moe = (f"; {len(recs['cpu'])} MoE calls, the card's own routing "
           f"differs from the CPU's at {flips[0]} tokens (smallest reference"
           f" gap {flips[1]:.3e}, limit {ROUTE_GAP_EPS[dtype]})"
           if recs["cpu"] else "")
    log(f"{tag}: small training {dtype} ({cfg.name} smoke, head_dim "
        f"{cfg.resolved_head_dim}, {SMALL_STEPS} steps of {SMALL_BATCH} x "
        f"{SMALL_SEQ} tokens, chunks of {SMALL_CHUNK}) card == CPU: loss "
        f"err {loss_err:.3e} (limit {loss_tol}), grad rel-norm err "
        f"{grad_err:.3e} (limit {grad_tol}); planted faults on the CPU "
        + ", ".join(f"{f}: loss {e['loss']:.3e} grad {e['grad']:.3e}"
                    for f, e in fault_err.items())
        + f"; flash calls by route {json.dumps(routes)}{moe}; the largest "
        f"gradient errors {json.dumps(by_master.most_common(3))}")
    return dict(loss_err=loss_err, grad_err=grad_err, faults=fault_err,
                routes=routes, flips=flips[0])


# (c) the full-width cell train_llama3_8b_L8_s4096: llama3-8b's published
# widths, depth cut to 8 layers (f32 masters, gradients and AdamW's m/v of
# 32 layers need 128 GB), batch 2 of 4,096 tokens (train_4k's length).
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_TIMED = 8, 4096, 2, 4
TRAIN_GROUPS = ("flash_fwd", "attn_bwd", "matmul", "cross_entropy",
                "adamw", "other")
CE_BACKWARD = ("LogsumexpBackward", "GatherBackward")


def train_cell_config(get_config):
    return dataclasses.replace(get_config("llama3-8b"),
                               n_layers=TRAIN_LAYERS)


def matmul_params(cfg) -> int:
    """Parameters the step multiplies a token by (every layer's
    projections and MLP, and the head; the embedding lookup excluded).
    An MoE layer counts its router and the ``top_k`` experts a token
    takes, not the capacity padding its products also compute; a Mamba
    layer its four projections (not the depthwise conv or the scan); an
    sLSTM layer its input and recurrent products (float32 ones, counted
    like the rest against the bf16 peak); an mLSTM layer its projections
    (not the chunk's attention-like products); an encoder-decoder's
    decoder layer also its cross-attention's q and o (its k and v act on
    the frames, :func:`frame_params`)."""
    D, H, KV, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    total = 0
    for spec in cfg.unit:
        if spec.kind == "attn":
            total += D * H * hd + 2 * D * KV * hd + H * hd * D
        elif spec.kind == "mamba":       # in_proj, x_proj, dt_proj, out_proj
            d_in, N = cfg.mamba.expand * D, cfg.mamba.d_state
            r = cfg.mamba.dt_rank or -(-D // 16)
            total += D * 2 * d_in + d_in * (r + 2 * N) + r * d_in + d_in * D
        else:                            # the xLSTM blocks' projections
            d_in = int(cfg.xlstm.proj_factor * D)
            total += (D * 2 * d_in + 3 * d_in * d_in + 2 * d_in * H
                      + d_in * D if spec.kind == "mlstm"
                      else D * d_in + 8 * d_in * d_in + d_in * D)
        if spec.ffn == "moe":
            total += D * cfg.moe.n_experts + cfg.moe.top_k * 3 * D * \
                cfg.moe.d_ff
        elif spec.ffn == "dense":
            total += 3 * D * cfg.d_ff
        if cfg.enc_dec:
            total += 2 * D * H * hd
    return total * cfg.n_units + D * cfg.vocab


def frame_params(cfg) -> int:
    """Parameters an encoder-decoder multiplies a frame by: the frontend
    projection, every encoder layer's attention and MLP, and every
    decoder layer's cross-attention k and v."""
    D, H, KV, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    enc = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * cfg.d_ff
    return (cfg.frontend_dim * D + cfg.n_enc_layers * enc
            + cfg.n_layers * 2 * D * KV * hd)


def train_flops(cfg, batch: int, seq: int) -> int:
    """A training step's matrix-product FLOPs, 6 x parameters x the rows
    they act on: :func:`matmul_params` over the ``batch x seq`` tokens;
    an encoder-decoder's :func:`frame_params` over ``batch x
    frontend_len`` frames; a vision prefix's projection and decoder
    layers (not the head: its loss skips the prefix) over its
    embeddings."""
    mm = matmul_params(cfg)
    flops = 6 * mm * batch * seq
    frames = batch * cfg.frontend_len
    if cfg.enc_dec:
        flops += 6 * frame_params(cfg) * frames
    elif cfg.frontend != "none":
        flops += 6 * (mm - cfg.d_model * cfg.vocab
                      + cfg.frontend_dim * cfg.d_model) * frames
    return flops


def _is_matmul(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in ("gemm", "cutlass", "xmma", "cublas",
                                  "nvjet"))


def _kernels_under(evt) -> list:
    """``(name, device µs)`` of every kernel launched under a CPU event."""
    out = [(k.name, k.duration) for k in getattr(evt, "kernels", [])]
    for child in evt.cpu_children:
        out += _kernels_under(child)
    return out


def ranged_profile(fn, wrapped, fast: bool = False) -> dict:
    """One call of ``fn`` under the profiler, with ``record_function``
    ranges put around the functions ``wrapped`` (``(module, name,
    label)``, labels ``p11.*``; a label may be a function of the call's
    arguments that returns one of its ``labels``) for this call only:
    busy and wall µs, the flash kernels' and the matrix products' µs (by
    kernel name), for each label the µs of every kernel under its
    outermost ranges, of the matrix products and of the flash op's
    kernels (``FLASH_GROUP``) among them, and the µs under the
    cross-entropy's backward nodes (``CE_BACKWARD``).  ``fast`` reads the raw events
    instead (:func:`_fast_split`): for runs of millions of eager launches,
    whose event tree takes longer to build than the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    saved, labels = [], []
    for mod, name, label in wrapped:
        fn_ = getattr(mod, name)
        labels += list(label.labels) if callable(label) else [label]
        pick = label if callable(label) else \
            (lambda *a, _label=label, **kw: _label)

        def ranged(*a, _fn=fn_, _pick=pick, **kw):
            with record_function(_pick(*a, **kw)):
                return _fn(*a, **kw)

        saved.append((mod, name, fn_))
        setattr(mod, name, ranged)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
    finally:
        for mod, name, fn_ in saved:
            setattr(mod, name, fn_)
    if fast:
        return _fast_split(prof, labels, wall)
    events = prof.events()
    busy = flash = mm = 0.0
    by_name = collections.Counter()
    for e in events:
        # the ranges also show on the device timeline (as annotations
        # spanning their kernels): only kernels, copies and fills count
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("p11."):
            busy += e.device_time_total
            by_name[e.name[:90]] += e.device_time_total
            if any(f in e.name for f in FLASH_KERNELS):
                flash += e.device_time_total
            elif _is_matmul(e.name):
                mm += e.device_time_total
    ranges = {label: [0.0, 0.0, 0.0] for label in labels}
    ce_bwd = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in ranges and not any(
                a.name == e.name for a in _ancestors(e)):
            under = _kernels_under(e)
            ranges[e.name][0] += sum(us for _, us in under)
            ranges[e.name][1] += sum(us for n, us in under if _is_matmul(n))
            ranges[e.name][2] += sum(us for n, us in under
                                     if any(f in n for f in FLASH_GROUP))
        elif any(n in e.name for n in CE_BACKWARD) and \
                "evaluate_function" in e.name:
            ce_bwd += sum(us for _, us in _kernels_under(e))
    return dict(busy_us=busy, wall_us=wall, flash_us=flash, mm_us=mm,
                ranges=ranges, ce_bwd_us=ce_bwd,
                top=[(n, round(us, 1)) for n, us in by_name.most_common(6)])


def _fast_split(prof, labels, wall: float) -> dict:
    """:func:`ranged_profile`'s numbers from the profiler's raw events,
    without building its event tree: a kernel (or copy, or fill) belongs
    to a label when it starts inside one of that label's spans on the
    device timeline (a ``record_function`` range shows there as an
    annotation spanning the kernels launched inside it; one stream runs
    them in launch order).  The cross-entropy's backward nodes are not
    told apart (``ce_bwd_us`` 0: they fall among the rest);
    ``range_spans`` counts each label's spans, so a label that saw none
    reads as not measured rather than as zero."""
    import bisect
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans, kernels = [], []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith("p11."):
            if name in labels:
                spans.append((e.start_ns(), e.end_ns(), name))
        else:
            kernels.append((e.start_ns(), e.duration_ns() / 1e3, name))
    spans.sort()
    starts = [sp[0] for sp in spans]
    busy = flash = mm = 0.0
    by_name = collections.Counter()
    ranges = {label: [0.0, 0.0, 0.0] for label in labels}
    for start, us, name in kernels:
        busy += us
        by_name[name[:90]] += us
        is_mm = _is_matmul(name)
        if any(f in name for f in FLASH_KERNELS):
            flash += us
        elif is_mm:
            mm += us
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start <= spans[i][1]:
            r = ranges[spans[i][2]]
            r[0] += us
            r[1] += us if is_mm else 0.0
            r[2] += us if any(f in name for f in FLASH_GROUP) else 0.0
    return dict(busy_us=busy, wall_us=wall, flash_us=flash, mm_us=mm,
                ranges=ranges, ce_bwd_us=0.0,
                range_spans=dict(collections.Counter(sp[2] for sp in spans)),
                top=[(n, round(us, 1)) for n, us in by_name.most_common(6)])


def train_step_split(step, attn_mod, adamw, transformer,
                     moe_mod=None, recurrent=(), fast: bool = False) -> dict:
    """One training step under the profiler (:func:`ranged_profile`), its
    device time split into ``TRAIN_GROUPS``: the flash kernels (the
    forward, by name); the attention backward (every kernel under
    ``_flash_backward``, whose products are plain PyTorch); matrix
    products outside it (cuBLAS kernels by name); cross-entropy (its
    forward and the backward nodes ``CE_BACKWARD``); AdamW (every kernel
    under ``update``); the rest.  With ``moe_mod`` also the MoE layer's
    forward and its remat recompute (every kernel under ``apply_moe``):
    its expert products (``moe_products``) apart from its routing,
    dispatch and combine (``moe_dispatch``); the backward's products
    count among the matrix products.  With ``recurrent`` also the
    recurrent blocks' forward and remat recompute (``recurrent_fwd``,
    every kernel under their calls; their backward falls among the
    rest).  Returns µs by group, busy and wall µs."""
    wrapped = [(attn_mod, "_flash_backward", "p11.attn_bwd"),
               (adamw, "update", "p11.adamw"),
               (transformer, "cross_entropy", "p11.cross_entropy")]
    if moe_mod is not None:
        wrapped.append((moe_mod, "apply_moe", "p11.moe"))
    wrapped += [(mod, name, "p11.recurrent") for mod, name in recurrent]
    prof = ranged_profile(step, wrapped, fast)
    r = prof["ranges"]
    moe_us, moe_mm = r.get("p11.moe", (0.0, 0.0))[:2]
    rec_us, rec_mm = r.get("p11.recurrent", (0.0, 0.0))[:2]
    split = {"flash_fwd": prof["flash_us"], "attn_bwd": r["p11.attn_bwd"][0],
             "matmul": prof["mm_us"] - r["p11.attn_bwd"][1] - moe_mm
             - rec_mm,
             "cross_entropy": r["p11.cross_entropy"][0] + prof["ce_bwd_us"],
             "adamw": r["p11.adamw"][0]}
    if moe_mod is not None:
        split.update(moe_products=moe_mm, moe_dispatch=moe_us - moe_mm)
    if recurrent:
        split.update(recurrent_fwd=rec_us)
    split["other"] = prof["busy_us"] - sum(split.values())
    return dict(split=split, busy_us=prof["busy_us"],
                wall_us=prof["wall_us"], top=prof["top"],
                range_spans=prof.get("range_spans"))


def _ancestors(evt):
    p = evt.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def _attn_library_ms(q, k, v, qp, kp, scale: float, B: int) -> tuple:
    """SDPA (boolean causal mask, GQA) at the training shape: forward ms,
    and forward + backward ms (CUDA events); the yardsticks of a later
    backward kernel (never called by the port)."""
    import torch.nn.functional as F
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    ok = ((kp < 2.0 ** 29)[None, :] & (qp[:, None] >= kp[None, :]))
    q4 = q.view(B, H // B, Sq, hd).detach().requires_grad_()
    k4 = k.view(B, HK // B, Sk, hd).detach().requires_grad_()
    v4 = v.view(B, HK // B, Sk, hd).detach().requires_grad_()
    do = torch.randn_like(q4)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, attn_mask=ok[None, None],
                                           scale=scale, enable_gqa=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=ok[None, None], scale=scale,
            enable_gqa=True)
        torch.autograd.grad(out, (q4, k4, v4), do)

    return _event_ms(fwd, 5), _event_ms(fwd_bwd, 3)


def train_flash_timings(fa_kernel, fa_ref, attn_mod, cfg, dev,
                        seed: int, tag: str = "phase 11 (c)") -> dict:
    """The flash op at the cell's training shape (bf16, causal): the
    kernel's training launch (with the log-sum-exp) and the serving
    launch (without) in turns, the plain version, the port's plain
    backward for one layer (``_flash_backward``, chunks of
    ``cfg.attn_chunk``), and SDPA forward and forward + backward, beside
    the forward's bound."""
    B, KV = TRAIN_BATCH, cfg.n_kv_heads
    G, hd, S = cfg.n_heads // KV, cfg.resolved_head_dim, TRAIN_SEQ
    case = FACase("train", B, KV, G, S, S, hd, True, 0, 0.0, "tc")
    args, kw = fa_case_inputs(case, torch.bfloat16, dev, seed + 17)
    q, k, v, qp, kp = args
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)

    def with_lse():
        fa_kernel.launch(q, k, v, qp, kp, out, **kw, lse=lse)

    def without():
        fa_kernel.launch(q, k, v, qp, kp, out, **kw)

    rounds = {"lse": [], "no_lse": []}
    for _ in range(3):
        rounds["lse"].append(_event_ms(with_lse, 10))
        rounds["no_lse"].append(_event_ms(without, 10))
    ms, ms_serve = (float(np.median(rounds["lse"])),
                    float(np.median(rounds["no_lse"])))
    plain = _event_ms(lambda: fa_ref.flash_attention_flat_lse(*args, **kw),
                      2)
    q5 = q.view(B, KV, G, S, hd)
    k4, v4 = k.view(B, KV, S, hd), v.view(B, KV, S, hd)
    o5 = out.view(B, KV, G, S, hd)
    with_lse()
    l4 = lse.view(B, KV, G, S)
    do = torch.randn_like(q5)
    bwd_kw = dict(causal=True, window=0, attn_cap=0.0, scale=kw["scale"],
                  chunk=cfg.attn_chunk)
    bwd = _event_ms(lambda: attn_mod._flash_backward(
        q5, k4, v4, qp, kp, o5, l4, do, **bwd_kw), 2)
    lib_fwd, lib_fwd_bwd = _attn_library_ms(q, k, v, qp, kp, kw["scale"], B)
    pairs = _visible_pairs(qp, kp) * q.shape[0]
    flops = 4 * hd * pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    bound_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    res = dict(ms=ms, ms_no_lse=ms_serve, rounds=rounds, plain_ms=plain,
               bwd_ms=bwd, library_ms=lib_fwd,
               library_bwd_ms=lib_fwd_bwd - lib_fwd,
               library_fwd_bwd_ms=lib_fwd_bwd,
               bound_ms=max(bound_ops, bound_bytes),
               bound_by="operations" if bound_ops >= bound_bytes else "bytes")
    log(f"{tag}: flash at the training shape q [{q.shape[0]}, {S}, "
        f"{hd}] x k/v [{k.shape[0]}, {S}, {hd}] bf16 causal: training launch"
        f" (lse) {ms * 1e3:.1f} us, serving launch (no lse) "
        f"{ms_serve * 1e3:.1f} us (medians of 3 rounds in turns, CUDA "
        f"events: {json.dumps(rounds)}), plain {plain * 1e3:.1f} us, bound "
        f"{res['bound_ms'] * 1e3:.1f} us by {res['bound_by']} ({flops} "
        f"flops over {pairs} visible pairs); the port's plain backward "
        f"(chunks of {cfg.attn_chunk}) {bwd * 1e3:.1f} us a layer; SDPA "
        f"forward {lib_fwd * 1e3:.1f} us, backward "
        f"{res['library_bwd_ms'] * 1e3:.1f} us (forward + backward "
        f"{lib_fwd_bwd * 1e3:.1f} us)")
    del args, q, k, v, out, lse, do
    torch.cuda.empty_cache()
    return res


def train_cell(get_config, TrainModel, adamw, data, steps_mod, attn_mod,
               transformer, fa_kernel, dev, seed: int, cfg=None,
               name: str = "train_llama3_8b_L8_s4096",
               tag: str = "phase 11 (c)", moe_mod=None,
               recurrent=(), timed: int = TRAIN_TIMED,
               profile_first: bool = False) -> dict:
    """Phase 11 (c): ``train_llama3_8b_L8_s4096`` (or ``name`` at
    ``cfg``) through ``make_train_step`` with remat: one warm-up step and
    ``timed`` timed ones, the flash launches counted over all of
    them (``(1 + timed) x 2 x`` the forward's flash calls, every
    one on ``tc``), the losses finite, every master changed; step ms
    (median), tokens/s, MFU (:func:`train_flops` over the step time at
    989 TFLOP/s), peak memory; then one more step profiled for the
    device split (with ``profile_first`` the warm-up step is profiled
    instead, and no step is added).  An arch with a frontend gets seeded frame embeddings
    in every batch (:func:`with_frames`).  With ``moe_mod`` (an MoE config) each step's aux term
    (``aux_loss_weight x sum of the layers' aux / n_layers``, from the
    forward's ``apply_moe`` calls) is logged apart from the
    cross-entropy."""
    cfg = cfg or train_cell_config(get_config)
    model = TrainModel(cfg, device=dev, seed=seed)
    params = model.param_dict()
    n_params = sum(t.numel() for t in params.values())
    # one schedule for every training cell, however many steps it times
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                total_steps=1 + TRAIN_TIMED)
    opt = adamw.init_state(opt_cfg, params)
    stream = data.SyntheticStream(data.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    step = steps_mod.make_train_step(model, opt_cfg)
    probe = {n: (t.detach().flatten()[::max(1, t.numel() // 4096)].clone(),
                 float(t.detach().double().sum()))
             for n, t in params.items()}
    auxes, aux_terms = [], []
    if moe_mod is not None:
        apply_moe = moe_mod.apply_moe

        def recording(*a, **kw):
            y, aux = apply_moe(*a, **kw)
            auxes.append(aux.detach())
            return y, aux

        moe_mod.apply_moe = recording
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.reset_counts()
    losses, times = [], []
    try:
        with launches_by_form(attn_mod, fa_kernel) as forms:
            for i in range(1 + timed):
                batch = {k: torch.as_tensor(v, device=dev) for k, v in
                         with_frames(cfg, stream.next_batch(),
                                     seed + i).items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == 0 and profile_first:
                    stepped = []
                    prof = train_step_split(
                        lambda: stepped.append(step(params, opt, batch)),
                        attn_mod, adamw, transformer, moe_mod, recurrent,
                        fast=bool(recurrent))
                    params, opt, m = stepped.pop()
                else:
                    params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if moe_mod is not None:   # the forward's calls, not remat's
                    aux_terms.append(cfg.moe.aux_loss_weight * float(
                        sum(auxes[:cfg.n_layers])) / cfg.n_layers)
                    auxes.clear()
    finally:
        if moe_mod is not None:
            moe_mod.apply_moe = apply_moe
    launches = fa_kernel.flash_attention_cuda.launches
    routes = dict(fa_kernel.flash_attention_cuda.route_launches)
    forms = dict(forms)
    peak = torch.cuda.max_memory_allocated()
    want = 2 * flash_calls(cfg)[0] * (1 + timed)
    check(launches == want and routes["tc"] == want,
          f"training cell: {launches} flash launches by route {routes}, not "
          f"{want} on tc")
    check(sum(forms.values()) == launches, f"training cell: flash launches "
          f"by call form {forms} do not add up to {launches}")
    check(all(np.isfinite(losses)), f"training cell: losses {losses}")
    unchanged = [n for n, t in params.items()
                 if torch.equal(t.detach().flatten()[
                     ::max(1, t.numel() // 4096)], probe[n][0])
                 and float(t.detach().double().sum()) == probe[n][1]]
    check(not unchanged, f"training cell: masters unchanged: {unchanged}")
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mm = matmul_params(cfg)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    frames = (f" + 6 x {frame_params(cfg)} params x "
              f"{TRAIN_BATCH * cfg.frontend_len} frames"
              if cfg.enc_dec else "")
    mfu = flops / step_s / H100_BF16_FLOPS
    if not profile_first:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 with_frames(cfg, stream.next_batch(), seed + 99).items()}
        prof = train_step_split(lambda: step(params, opt, batch), attn_mod,
                                adamw, transformer, moe_mod, recurrent,
                                fast=bool(recurrent))
    busy, wall = prof["busy_us"], prof["wall_us"]
    shares = ", ".join(f"{g} {us / 1e3:.1f} ms ({us / busy:.3f})"
                       for g, us in prof["split"].items()) if busy else \
        "not measured (the profiler saw no device time)"
    experts = (f" ({cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
               f"d_ff {cfg.moe.d_ff})" if cfg.moe else "")
    ce = [round(x - a, 4) for x, a in zip(losses, aux_terms)]
    aux = (f"; aux terms {json.dumps([round(x, 6) for x in aux_terms])}, "
           f"cross-entropy (loss less the aux term) {json.dumps(ce)}"
           if aux_terms else "")
    log(f"{tag}: {name}: {cfg.n_layers} layers at "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
        f"d_ff {cfg.d_ff}{experts}, vocab {cfg.vocab}; {n_params} f32 "
        f"masters; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens; losses "
        f"{json.dumps([round(x, 4) for x in losses])}; step s "
        f"{json.dumps([round(t, 4) for t in times])} (first: warm-up), "
        f"median {step_s * 1e3:.1f} ms, {tokens / step_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} ({flops} matrix-product FLOPs: 6 x {mm} params x "
        f"{tokens} tokens{frames} over the step at "
        f"{H100_BF16_FLOPS:.3g} FLOP/s); peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated); flash launches "
        f"{launches} {json.dumps(routes)} (by call form and route "
        f"{json.dumps(forms)}); every master changed{aux}")
    spans = (f"; device spans by range {json.dumps(prof['range_spans'])}"
             f" (the cross-entropy's backward among the rest)"
             if prof["range_spans"] is not None else "")
    which = "the warm-up step profiled" if profile_first else \
        "a profiled step"
    log(f"{tag}: {which}{spans}: device busy {busy / 1e3:.1f} ms of "
        f"{wall / 1e3:.1f} ms wall, idle share "
        f"{(1 - busy / wall) if busy else float('nan'):.4f}; by group: "
        f"{shares}; clocks, power, temperature {_clocks()}; the largest "
        f"kernels (us) {json.dumps(prof['top'])}")
    res = dict(cfg=cfg, losses=losses, aux_terms=aux_terms, times=times,
               step_ms=step_s * 1e3, flops=flops,
               tokens_per_s=tokens / step_s, mfu=mfu, mm_params=mm,
               n_params=n_params, peak_bytes=peak, launches=launches,
               routes=routes, forms=forms, split_us=prof["split"],
               busy_us=busy,
               wall_us=wall)
    del model, params, opt, step, batch, probe
    torch.cuda.empty_cache()
    return res


# (d) the paper's guarantee in training: test_system.py's crash at step 24
# of 40 with a checkpoint every 10, on the card, at the smoke config.  The
# resumed run against the uninterrupted one, relative norm: 0 when the
# card's step is deterministic (PERF.md section 6)
CRASH_STEPS, CRASH_EVERY, CRASH_AT = 40, 10, 24
CRASH_REL_TOL = 1e-5


def _trees_equal(a, b) -> bool:
    if isinstance(b, dict):
        return isinstance(a, dict) and sorted(a) == sorted(b) and all(
            _trees_equal(a[k], b[k]) for k in b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


def trainer_crash_restart(get_config, TrainModel, adamw, data, runtime,
                          convert, fa_kernel, dev, seed: int) -> dict:
    """Phase 11 (d): ``Trainer`` (llama3-8b smoke config on the card,
    checkpoints in the temporary directory through the 9p pool) crashed
    at step ``CRASH_AT`` of ``CRASH_STEPS``, restarted: the restored
    params, m, v, step and stream state equal what the step-20 save
    committed, bit for bit; the resumed run's final params against an
    uninterrupted run's; an ``AsyncCheckpointManager`` run restores at
    its last step."""
    cfg = get_config("llama3-8b", smoke=True)

    def trainer(root, async_=False):
        return runtime.Trainer(
            TrainModel(cfg, device=dev, init=False),
            adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                              total_steps=CRASH_STEPS, weight_decay=0.0),
            data.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4),
            runtime.TrainerConfig(total_steps=CRASH_STEPS,
                                  ckpt_every=CRASH_EVERY, ckpt_async=async_,
                                  ckpt_dir=str(root)), device=dev)

    t0 = time.perf_counter()
    before = fa_kernel.flash_attention_cuda.launches
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t1 = trainer(root / "crash")
        saved = {}
        orig_save = t1.ckpt.save

        def recording_save(step, state):
            saved[step] = copy.deepcopy(state)
            return orig_save(step, state)

        t1.ckpt.save = recording_save
        crashed = False
        try:
            t1.run(seed=seed, crash_at_step=CRASH_AT)
        except RuntimeError:
            crashed = True
        check(crashed, "the injected crash did not happen")
        t2 = trainer(root / "crash")
        _, opt, stream, start = t2.restore_or_init(seed)
        want = saved[start]
        restored = {"params": convert.params_to_numpy(t2.model),
                    "opt": convert.opt_state_to_numpy(opt, t2.model),
                    "data_state": {k: np.asarray(v)
                                   for k, v in stream.state().items()}}
        check(start == 20 and all(_trees_equal(restored[g], want[g])
                                  for g in restored),
              f"restored at step {start}, or the restore differs from what "
              f"the step-{start} save committed")
        t2 = trainer(root / "crash")
        params_c, _, losses_c = t2.run(seed=seed)
        t3 = trainer(root / "whole")
        params_r, _, losses_r = t3.run(seed=seed)
        with torch.no_grad():
            diff = max(float((params_c[n] - p).abs().max())
                       for n, p in params_r.items())
            rel = max(float((params_c[n] - p).norm()
                            / p.norm().clamp_min(1e-30))
                      for n, p in params_r.items())
        exact = diff == 0.0
        check(rel <= CRASH_REL_TOL, f"resumed run's final params differ "
              f"from the uninterrupted run's by {rel:.3e} relative")
        t4 = trainer(root / "async", async_=True)
        _, _, losses_a = t4.run(seed=seed)
        start_a = trainer(root / "async").restore_or_init(seed)[3]
        check(start_a == CRASH_STEPS, f"the async run restores at step "
              f"{start_a}, not {CRASH_STEPS}")
        check(losses_r[-1] < losses_r[0] and all(np.isfinite(losses_r)),
              f"the uninterrupted run's loss did not fall: {losses_r[0]} -> "
              f"{losses_r[-1]}")
    wall = time.perf_counter() - t0
    launches = fa_kernel.flash_attention_cuda.launches - before
    log(f"phase 11 (d): Trainer (llama3-8b smoke, {cfg.dtype}) crashed at "
        f"step {CRASH_AT} of {CRASH_STEPS} (checkpoints every "
        f"{CRASH_EVERY}), restored at step {start}: params, m, v, step and "
        f"stream state equal the step-{start} save bit for bit; resumed "
        f"final params vs uninterrupted: max abs diff {diff:.3e}, rel "
        f"{rel:.3e} ({'bit for bit' if exact else 'within ' + str(CRASH_REL_TOL)}"
        f"); losses {losses_r[0]:.4f} -> {losses_r[-1]:.4f}; the resumed "
        f"run's {len(losses_c)} losses "
        f"{'equal' if losses_c == losses_r[start:] else 'differ from'} the "
        f"uninterrupted run's; async run restores at {start_a}; "
        f"{launches} flash launches; {wall:.1f} s")
    return dict(restored_step=start, exact=exact, max_abs_diff=diff,
                rel=rel, async_start=start_a, launches=launches, wall_s=wall)


def train_phase(fa_kernel, fa_ref, dev, seed: int) -> dict:
    """Phase 11: training on the card: (a) the flash kernel's training
    launch against its plain version; (b) small training, card against
    CPU, beside planted faults; (c) the full-width cell; (d) the
    ``Trainer``'s crash and restart, and an async run."""
    import repro_torch.data as data
    import repro_torch.runtime as runtime
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import convert
    from repro_torch.models import transformer
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    log(f"phase 11: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"on the card at the start")
    out = dict(lse=fa_lse_vs_plain(fa_kernel, fa_ref, seed, dev))
    out["small"] = {dt: small_train_matches_cpu(
        get_config, TrainModel, adamw, data, attn_mod, fa_kernel, dt, seed,
        dev) for dt in ("float32", "bfloat16")}
    cell = train_cell(get_config, TrainModel, adamw, data, steps_mod,
                      attn_mod, transformer, fa_kernel, dev, seed)
    out["timings"] = train_flash_timings(fa_kernel, fa_ref, attn_mod,
                                         cell.pop("cfg"), dev, seed)
    out["cell"] = cell
    out["crash"] = trainer_crash_restart(get_config, TrainModel, adamw,
                                         data, runtime, convert, fa_kernel,
                                         dev, seed)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 11 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the MoE sublayer (granite-moe-3b-a800m)
# ---------------------------------------------------------------------------

# Where the card's own top-k may differ from the CPU's (whose choice it then
# takes, routing_record): the CPU's smallest gap between neighbours of its
# k+1 largest probabilities under this.  float32: an ulp of a router logit
# summed in another order.  bfloat16: the router's input is a bf16
# activation that the two devices round at other places; the spread of the
# probabilities on the smoke configs (tests/test_torch_moe_models.py).
ROUTE_GAP_EPS = {"float32": 1e-5, "bfloat16": 2e-2}


@contextlib.contextmanager
def routing_record(moe_mod, follow=None):
    """Records every MoE call's ``(probs, expert ids)`` (on the CPU) in a
    list; with ``follow`` (an earlier run's list) each call then takes
    that run's expert ids of the same call, with its own gate values at
    them, so that a near-tie cannot send two runs apart.  The records
    copy to the host: not for timed runs."""
    rec = []
    orig = moe_mod.topk_stable

    def recording(probs, k):
        vals, ids = orig(probs, k)
        rec.append((probs.detach().float().cpu(), ids.cpu()))
        if follow is None:
            return vals, ids
        ids = follow[len(rec) - 1][1].to(probs.device)
        vals = probs.gather(-1, ids)
        return vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9), ids

    moe_mod.topk_stable = recording
    try:
        yield rec
    finally:
        moe_mod.topk_stable = orig


def routing_flips(got, want, eps: float) -> tuple:
    """``got``'s top-k against ``want``'s (two :func:`routing_record`
    lists), call by call: where a token's experts or their order differ,
    ``want``'s smallest gap between neighbours of its k+1 largest
    probabilities must be under ``eps``.  Returns (tokens that differ,
    the smallest such gap, inf if none)."""
    check(len(got) == len(want), f"{len(got)} MoE calls against "
          f"{len(want)}")
    n, smallest = 0, float("inf")
    for (pw, iw), (_, ig) in zip(want, got):
        differ = (iw != ig).any(dim=-1)
        if not differ.any():
            continue
        k = iw.shape[-1]
        s = torch.sort(pw, dim=-1, descending=True).values
        gap = (s[:, :k] - s[:, 1:k + 1]).min(dim=-1).values[differ]
        check(float(gap.max()) < eps, f"a token routed otherwise than on "
              f"the CPU where the CPU's gap is {float(gap.max()):.3e} "
              f"(limit {eps})")
        smallest = min(smallest, float(gap.min()))
        n += int(differ.sum())
    return n, smallest


# (a) the routing function on the card against the CPU, fed the same f32
# probabilities: name, tokens, experts, top-k, capacity factor, groups,
# ties (duplicated columns and whole rows of equal probabilities).  Up to
# the serve cell's prefill: 13 x 2,048 tokens, top-8 of 40.
MOE_ROUTE_CASES = (
    ("ties", 512, 8, 2, 1.25, 1, True),
    ("drops_cf0.05", 4096, 40, 8, 0.05, 1, False),
    ("cf1.25_groups2", 4096, 40, 8, 1.25, 2, True),
    ("cf8", 4096, 40, 8, 8.0, 1, False),
    ("serve_prefill", 26624, 40, 8, 1.25, 1, True),
    ("serve_prefill_groups2", 26624, 40, 8, 1.25, 2, False),
)
# apply_moe / apply_moe_dense card against CPU, the card on the CPU's
# routing: the largest error over the output's largest magnitude.  f32:
# products summed in another order.  bf16: 8 significant bits, rounded at
# other places (cuBLAS against the CPU's kernels), as the unit tests'
# limit (tests/test_torch_moe.py); each planted fault must read above it.
MOE_APPLY_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MOE_APPLY_FAULTS = ("tie_rule_dropped", "pos_shifted")
MOE_APPLY_SHAPE = dict(D=256, E=8, F=128, B=4, S=128, K=2)


def moe_probs(rng, N: int, E: int, ties: bool) -> torch.Tensor:
    logits = rng.standard_normal((N, E)).astype(np.float32)
    if ties:
        logits[:, E - 1] = logits[:, 0]
        logits[:, 2] = logits[:, 1]
        logits[::7] = 0.0
    return torch.softmax(torch.from_numpy(logits), dim=-1)


def moe_routing_vs_cpu(moe_mod, dev, seed: int) -> dict:
    """Phase 12 (a), routing: ``moe.route`` on the card against the CPU
    over ``MOE_ROUTE_CASES`` (with groups, each group routed alone at its
    own capacity): expert ids, capacity ranks, kept slots and counts
    equal, gate values within 1e-6."""
    rng = np.random.default_rng(seed + 29)
    worst, drops = 0.0, {}
    for name, N, E, K, cf, groups, ties in MOE_ROUTE_CASES:
        probs = moe_probs(rng, N, E, ties)
        n = N // groups
        C = moe_mod._capacity(n, E, K, cf)
        kept = 0
        for g in range(groups):
            p = probs[g * n:(g + 1) * n]
            cpu = moe_mod.route(p, K, C)
            card = moe_mod.route(p.to(dev), K, C)
            for field in ("expert_ids", "pos", "keep", "counts"):
                check(torch.equal(getattr(card, field).cpu(),
                                  getattr(cpu, field)),
                      f"routing {name}, group {g}: {field} differs on the "
                      f"card from the CPU")
            err = float((card.gate_vals.cpu() - cpu.gate_vals).abs().max())
            check(err <= 1e-6, f"routing {name}: gate values differ by "
                  f"{err:.3e}")
            worst = max(worst, err)
            kept += int(cpu.keep.sum())
        drops[name] = round(1 - kept / (N * K), 6)
    log(f"phase 12 (a): moe.route card == CPU (expert ids, capacity ranks, "
        f"kept slots, counts exact; gate values max abs err {worst:.3e}, "
        f"limit 1e-6) over {len(MOE_ROUTE_CASES)} cases up to 26,624 "
        f"tokens x top-8 of 40; dropped shares {json.dumps(drops)}")
    return dict(gate_err=worst, dropped=drops)


def moe_apply_inputs(moe_mod, seed: int):
    """Weights and tokens for (a)'s apply checks, float32 on the CPU: the
    tokens carry a constant feature that makes expert 0 lead and experts
    1 and 3 (equal router columns, different weights) tie for second a
    logit behind (the rest of the router scaled down so that the order
    holds for every token), so the tie order shows in the output; every
    token goes to experts 0 and 1, so capacity drops most of them."""
    from repro_torch.models.layers import KeyGen
    sh = MOE_APPLY_SHAPE
    p = moe_mod.init_moe(KeyGen(seed + 31), sh["D"], sh["E"], sh["F"],
                         torch.float32)
    r = p["router"]
    r[1:] *= 0.1
    r[0] = torch.tensor([1.2, 1.0, -10.0, 1.0] + [-10.0] * (sh["E"] - 4))
    r[:, 3] = r[:, 1]
    x = torch.from_numpy(np.random.default_rng(seed + 37).standard_normal(
        (sh["B"], sh["S"], sh["D"])).astype(np.float32))
    x[..., 0] = 5.0
    return p, x


def _rel_err(got, want) -> float:
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def moe_apply_vs_cpu(moe_mod, attn_mod, dev, seed: int) -> dict:
    """Phase 12 (a), the layer: ``apply_moe`` (capacity 1.25: drops) and
    ``apply_moe_dense`` (one token a sequence) on the card against the
    CPU in f32 and bf16, the card taking the CPU's routing (its own may
    differ only at near-ties); the output within ``MOE_APPLY_TOL`` of the
    largest magnitude, the aux within 1e-5; then the CPU's output with
    each planted fault (the tie order reversed, every capacity rank one
    too high) against the card's reads above the limit."""
    p32, x32 = moe_apply_inputs(moe_mod, seed)
    K = MOE_APPLY_SHAPE["K"]
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        p = {k: v.to(dt) for k, v in p32.items()}
        pc = {k: v.to(dev) for k, v in p.items()}
        for path in ("capacity", "dense"):
            x = x32.to(dt) if path == "capacity" else x32[:, :1].to(dt)

            def run(params, xx):
                if path == "dense":
                    return moe_mod.apply_moe_dense(params, xx, top_k=K)
                return moe_mod.apply_moe(params, xx, top_k=K,
                                         capacity_factor=1.25)

            with routing_record(moe_mod) as cpu_rec:
                y_cpu, a_cpu = run(p, x)
            with routing_record(moe_mod, follow=cpu_rec) as card_rec:
                y_card, a_card = run(pc, x.to(dev))
            _sync(dev)
            flips = routing_flips(card_rec, cpu_rec, ROUTE_GAP_EPS["float32"])
            err = _rel_err(y_card, y_cpu)
            aux_err = abs(float(a_card) - float(a_cpu))
            tol = MOE_APPLY_TOL[dtype]
            check(y_card.dtype == dt and err <= tol and aux_err <= 1e-5,
                  f"{path} MoE {dtype}: card != CPU (err {err:.3e}, limit "
                  f"{tol}; aux err {aux_err:.3e})")
            faults = {}
            for fault in MOE_APPLY_FAULTS:
                if path == "dense" and fault == "pos_shifted":
                    continue                     # no capacity to shift
                with planted(attn_mod, fault, moe_mod):
                    faults[fault] = _rel_err(run(p, x)[0], y_card)
                check(faults[fault] > tol, f"{path} MoE {dtype}: planted "
                      f"fault {fault} reads {faults[fault]:.3e}, within the "
                      f"limit {tol}")
            out[f"{path}_{dtype}"] = dict(err=err, aux_err=aux_err,
                                          flips=flips[0], faults=faults)
    log("phase 12 (a): apply_moe (capacity 1.25) and apply_moe_dense at "
        f"{json.dumps(MOE_APPLY_SHAPE)} card == CPU on the CPU's routing, "
        f"errors over the largest magnitude (limits "
        f"{json.dumps(MOE_APPLY_TOL)}) with the planted faults' readings: "
        + json.dumps(out))
    return out


def moe_small_vs_cpu(serve_mod, build_model, get_config, TrainModel, adamw,
                     data, attn_mod, fa_kernel, seed: int, dev) -> dict:
    """Phase 12 (b): the granite-moe smoke config served (f32; bf16 at
    granite's head_dim 64, the ``tc`` and ``decode`` routes) and trained
    (f32, bf16 at head_dim 64) on the card against the CPU from the same
    weights, as phases 2 and 11 (b) do for llama3, with the attention and
    MoE faults planted in the CPU's training; then the bf16 serve of
    qwen1.5's smoke config (QKV biases, head_dim 128; prompts of 32 so
    that its prefill, one q head a kv head, has more than the decode
    route's 16 rows), whose every flash call must take ``tc`` or
    ``decode``: its biases are held in bf16, so q and k reach the kernel
    in bf16 (a bias held in f32 widens them, and the prefill then takes
    ``simt``)."""
    arch = "granite-moe-3b-a800m"
    tag = "phase 12 (b)"
    out = {"serve_f32": small_serve_matches_cpu(
        serve_mod, build_model, get_config, seed, dev, arch=arch, tag=tag)}
    n_layers = get_config(arch, smoke=True).n_layers
    out["serve_bf16"] = routes = small_serve_matches_cpu(
        serve_mod, build_model, get_config, seed, dev, dtype="bfloat16",
        head_dim=64, tol=SERVE_BF16_TOL, rtol=0.0, arch=arch, tag=tag)
    if dev.type == "cuda":
        check(routes == dict(tc=n_layers, decode=n_layers * 8, simt=0),
              f"granite bf16 small serve flash routes {routes}")
    for dt in ("float32", "bfloat16"):
        out[f"train_{dt}"] = small_train_matches_cpu(
            get_config, TrainModel, adamw, data, attn_mod, fa_kernel, dt,
            seed, dev, arch=arch, head_dim=64, tag=tag)
    qwen = "qwen1.5-32b"
    out["qwen_serve_bf16"] = routes = small_serve_matches_cpu(
        serve_mod, build_model, get_config, seed, dev, dtype="bfloat16",
        head_dim=128, tol=SERVE_BF16_TOL, rtol=0.0, arch=qwen, tag=tag,
        prompt_len=32)
    q_layers = get_config(qwen, smoke=True).n_layers
    if dev.type == "cuda":
        check(routes == dict(tc=q_layers, decode=q_layers * 8, simt=0),
              f"qwen1.5 bf16 small serve flash routes {routes}: a simt "
              f"call means q or k was widened to f32")
    return out


MOE_ARCH = "granite-moe-3b-a800m"


def moe_serve_split(lm, moe_mod, dev, seed: int, steps: int = 8,
                    tag: str = "phase 12 (c)") -> dict:
    """The granite serve's device split: one prefill and a window of
    ``steps`` decode steps profiled with ranges around ``apply_moe`` and
    ``apply_moe_dense``: flash, the MoE layers' expert products and their
    routing, dispatch and combine, the other matrix products, the rest,
    and the idle share."""
    model, cfg, B = lm["model"], lm["cfg"], lm["B"]
    rng = np.random.default_rng(seed + 13)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, LM_PROMPT)),
                             device=dev)
    tok = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    wrapped = [(moe_mod, "apply_moe", "p11.moe"),
               (moe_mod, "apply_moe_dense", "p11.moe_dense")]
    out = {}
    with torch.inference_mode():
        cache = model.init_cache(B, LM_PROMPT + LM_STEPS)

        def window():
            for _ in range(steps):
                model.decode_step(tok, cache)

        runs = (("prefill", lambda: model.prefill(prompt, cache)),
                ("decode", window))
        for what, fn in runs:
            if what == "decode":
                window()                       # warm
                cache["index"] = LM_PROMPT
            prof = ranged_profile(fn, wrapped)
            moe_us = sum(v[0] for v in prof["ranges"].values())
            moe_mm = sum(v[1] for v in prof["ranges"].values())
            busy, wall = prof["busy_us"], prof["wall_us"]
            groups = {"flash": prof["flash_us"], "moe_products": moe_mm,
                      "moe_dispatch": moe_us - moe_mm,
                      "matmul": prof["mm_us"] - moe_mm}
            groups["other"] = busy - sum(groups.values())
            out[what] = dict(groups=groups, busy_us=busy, wall_us=wall)
            shares = ", ".join(f"{g} {us:.1f} us ({us / busy:.3f})"
                               for g, us in groups.items()) if busy else \
                "not measured (the profiler saw no device time)"
            head = (f"one prefill of {B} x {LM_PROMPT} tokens"
                    if what == "prefill" else
                    f"decode window of {steps} steps")
            log(f"{tag}: {head}: device busy {busy:.1f} us of {wall:.1f} us "
                f"wall, idle share "
                f"{(1 - busy / wall) if busy else float('nan'):.4f}; by "
                f"group: {shares}; the largest kernels (us) "
                f"{json.dumps(prof['top'])}")
    log(f"{tag}: clocks, power, temperature after it: {_clocks()}")
    return out


def moe_serve_cell(serve_mod, build_model, get_config, pm_ref, fa_ops,
                   fa_ref, fa_kernel, pm_kernel, moe_mod, seed: int,
                   dev) -> dict:
    """Phase 12 (c): ``serve_granite_moe_3b``, phase 5's traffic on
    granite-moe-3b-a800m at its published width and depth (admission
    equal to the plain version's, finite logits, 32 ``tc`` + 1,024
    ``decode`` flash launches, the MoE capacity path at every prefill
    layer and the dense path at every decode layer, the dropped share);
    the flash op at its head_dim-64 prefill and decode shapes (phase 6's
    checks and timings); the device split."""
    tag = "phase 12 (c)"
    lm = lm_slice(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                  pm_kernel, seed, dev, arch=MOE_ARCH, tag=tag)
    ft = flash_timings(fa_ops, fa_ref, fa_kernel, lm, dev, seed, tag=tag)
    split = moe_serve_split(lm, moe_mod, dev, seed, tag=tag)
    res = {k: lm[k] for k in ("B", "fa_launches", "fa_routes", "pm_launches",
                              "pm_routes", "timings", "moe_calls")}
    res.update(flash=ft, split=split)
    del lm
    torch.cuda.empty_cache()
    return res


def moe_train_cell(get_config, TrainModel, adamw, data, steps_mod, attn_mod,
                   transformer, fa_kernel, fa_ref, moe_mod, seed: int,
                   dev) -> dict:
    """Phase 12 (d): ``train_granite_moe_3b_s4096``, phase 11 (c)'s cell
    on granite-moe-3b-a800m at its published width and depth (f32 masters
    drawn on the card, batch 2 x 4,096, remat, AdamW): 320 flash launches
    on ``tc`` with the log-sum-exp, finite losses, every master changed
    (the routers too), the aux term beside the cross-entropy, step ms,
    tokens/s, MFU (the router and the top-k experts a token takes),
    peak memory and a profiled step's split with the MoE layer's
    products and dispatch; then the flash op at the head_dim-64 training
    shape."""
    cfg = get_config(MOE_ARCH)
    tag = "phase 12 (d)"
    cell = train_cell(get_config, TrainModel, adamw, data, steps_mod,
                      attn_mod, transformer, fa_kernel, dev, seed, cfg=cfg,
                      name="train_granite_moe_3b_s4096", tag=tag,
                      moe_mod=moe_mod)
    cell["timings"] = train_flash_timings(fa_kernel, fa_ref, attn_mod,
                                          cell.pop("cfg"), dev, seed,
                                          tag=tag)
    return cell


def moe_phase(serve_mod, build_model, fa_ops, fa_ref, fa_kernel, pm_ref,
              pm_kernel, dev, seed: int) -> dict:
    """Phase 12: the MoE sublayer on the card: (a) routing and the layer
    card against CPU, with planted faults; (b) the granite-moe smoke
    config served and trained card against CPU, and qwen1.5's bf16 serve
    on ``tc``/``decode`` only; (c) ``serve_granite_moe_3b``; (d)
    ``train_granite_moe_3b_s4096``."""
    import repro_torch.data as data
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    log(f"phase 12: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"on the card at the start")
    out = dict(routing=moe_routing_vs_cpu(moe_mod, dev, seed),
               apply=moe_apply_vs_cpu(moe_mod, attn_mod, dev, seed))
    out["small"] = moe_small_vs_cpu(serve_mod, build_model, get_config,
                                    TrainModel, adamw, data, attn_mod,
                                    fa_kernel, seed, dev)
    out["serve"] = moe_serve_cell(serve_mod, build_model, get_config, pm_ref,
                                  fa_ops, fa_ref, fa_kernel, pm_kernel,
                                  moe_mod, seed, dev)
    out["train"] = moe_train_cell(get_config, TrainModel, adamw, data,
                                  steps_mod, attn_mod, transformer,
                                  fa_kernel, fa_ref, moe_mod, seed, dev)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the xLSTM and Mamba sublayers (xlstm-125m, jamba-v0.1)
# ---------------------------------------------------------------------------

XLSTM_ARCH, JAMBA_ARCH = "xlstm-125m", "jamba-v0.1-52b"
# (a) each block on the card against the CPU on the same weights and
# inputs, at full width: the largest error over the output's (or the
# state's) largest magnitude, at least 1.  float32: cuBLAS and the CPU's
# products sum in another order, and the recurrences carry that over
# their steps; the mLSTM's normalizer |q.n| cancels where one input gate
# dominates, and with its preactivations spanning +-100 the sequential
# form's output read 2.4e-4 on the H100 (PERF.md section 6); bf16: 8
# significant bits, the products rounded at other places.  Each planted
# fault (BLOCK_FAULTS, in the CPU's run) must read above the limit.
BLOCK_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
BLOCK_FAULTS = {"mlstm": "b_f_dropped", "slstm": "no_n_floor",
                "mamba": "conv_state_shifted"}
# mLSTM's stabilizer without its running maximum is read on weights whose
# input gate is scaled up, so that its preactivations span about +-100
# and only the running maximum keeps exp() finite; in float32 only: in
# bf16 such gates round to half-units, and the sound card and CPU runs
# part by 0.665 of the output's scale (PERF.md section 6)
MLSTM_GATE_SCALE = 30.0
XLSTM_BLOCK = dict(B=2, S=256, S_seq=100)    # 4 chunks of 64; sequential
MAMBA_BLOCK = dict(B=1, S=300, decode=2)     # chunks of 256 and 44
# (b) the bf16 small serve of jamba's smoke config: eight layers (Mamba,
# attention, MoE, MLP) round in bf16 where the llama3 smoke's two do, and
# the reference's own jitted and op-by-op runs of one set of weights part
# by up to 0.158 in a logit (tests/test_torch_hybrid_models.py)
JAMBA_SERVE_BF16_TOL = 0.2
# (e) jamba at its published width, depth cut from 32 to 16 layers: 32
# layers are 103 GB of bf16 weights, 16 are 52.1 GB
JAMBA_SERVE_LAYERS = 16
# (d) one timed step after the warm-up: the eager sLSTM loop makes a step
# the host's, 16-55 s on the H100 machines, and the smoke must finish
# within its time limit (the whole smoke took 1,049.9 s with four timed
# steps, PERF.md section 6).  The warm-up step is the profiled one: a
# separate profiled step took 64 s more (PERF.md section 6)
XLSTM_TRAIN_TIMED = 1


def _block_err(got, want) -> float:
    """The largest error over ``want``'s largest magnitude (at least 1);
    inf where ``got`` is not finite."""
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        return float("inf")
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _to(tree, dev=None, dtype=None):
    return {k: v.to(device=dev, dtype=dtype if v.is_floating_point()
                    else None) for k, v in tree.items()}


def xlstm_block_runs(xlstm_mod, p, x, state0, slstm_state):
    """The runs (a) holds for the xLSTM blocks: mLSTM chunkwise over
    ``x`` from ``state0`` (its output and state), then one decode step
    from that state, and the sequential form over the first ``S_seq``
    tokens; sLSTM over ``x`` from its init state, and over the first 16
    tokens from ``slstm_state``."""
    H = 4
    out = {}
    y, st = xlstm_mod.apply_mlstm(p["mlstm"], x, n_heads=H, chunk=64,
                                  state=state0)
    out["mlstm_chunkwise"] = y
    out.update({f"mlstm_state_{k}": v for k, v in st.items()})
    out["mlstm_decode"], _ = xlstm_mod.apply_mlstm(
        p["mlstm"], x[:, -1:], n_heads=H, chunk=64, state=st)
    out["mlstm_sequential"], _ = xlstm_mod.apply_mlstm(
        p["mlstm"], x[:, :XLSTM_BLOCK["S_seq"]], n_heads=H, chunk=64,
        state=state0)
    B, D = x.shape[0], x.shape[2]
    y, st = xlstm_mod.apply_slstm(p["slstm"], x, state=_to(
        xlstm_mod.init_slstm_state(B, D), x.device))
    out["slstm"] = y
    out.update({f"slstm_state_{k}": v for k, v in st.items()})
    out["slstm_floor"], _ = xlstm_mod.apply_slstm(
        p["slstm"], x[:, :16], state=_to(slstm_state, x.device))
    return out


def mamba_block_runs(ssm_mod, p, x, state0):
    """Mamba over ``x`` from ``state0`` (prefill: its output and state),
    then ``MAMBA_BLOCK["decode"]`` decode steps from that state."""
    out = {}
    y, st = ssm_mod.apply_mamba(p, x, chunk=256, state=state0)
    out["mamba_prefill"] = y
    out.update({f"mamba_state_{k}": v for k, v in st.items()})
    for t in range(MAMBA_BLOCK["decode"]):
        y, st = ssm_mod.apply_mamba(p, x[:, t:t + 1], chunk=256, state=st)
        out[f"mamba_decode{t}"] = y
    out.update({f"mamba_decoded_{k}": v for k, v in st.items()})
    return out


def block_inputs(xlstm_mod, ssm_mod, get_config, seed: int):
    """(a)'s float32 weights and inputs on the CPU: xlstm-125m's mLSTM and
    sLSTM (d_model 768, d_in 1,536, 4 heads of 384; the biases moved off
    their constants), an sLSTM state the normalizer floor binds from (``n`` 0,
    ``m`` 30: from its init ``n`` stays at least 1, so the floor never
    binds there), and jamba's Mamba (d_model 4,096, d_in 8,192, d_state
    16, d_conv 4, dt_rank 256)."""
    from repro_torch.models.layers import KeyGen
    xc, jc = get_config(XLSTM_ARCH), get_config(JAMBA_ARCH)
    D, H = xc.d_model, xc.n_heads
    rng = np.random.default_rng(seed + 41)
    xl = {"mlstm": xlstm_mod.init_mlstm(KeyGen(seed + 41), D, H,
                                        torch.float32),
          "slstm": xlstm_mod.init_slstm(KeyGen(seed + 42), D, H,
                                        torch.float32)}
    for block in xl.values():
        for k, v in block.items():
            if v.ndim == 1:
                v += torch.from_numpy(0.2 * rng.standard_normal(
                    v.shape).astype(np.float32))
    B, S = XLSTM_BLOCK["B"], XLSTM_BLOCK["S"]
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    d_in = 2 * D
    floor_state = {"c": torch.from_numpy(0.3 * rng.standard_normal(
        (B, d_in)).astype(np.float32)),
        "n": torch.zeros(B, d_in), "m": torch.full((B, d_in), 30.0),
        "h": torch.from_numpy(0.3 * rng.standard_normal(
            (B, d_in)).astype(np.float32))}
    m = jc.mamba
    mp = ssm_mod.init_mamba(KeyGen(seed + 43), jc.d_model, torch.float32,
                            m.d_state, m.d_conv, m.expand, m.dt_rank)
    for k, v in mp.items():
        if v.ndim == 1:
            v += torch.from_numpy(0.1 * rng.standard_normal(
                v.shape).astype(np.float32))
    mx = torch.from_numpy(rng.standard_normal(
        (MAMBA_BLOCK["B"], MAMBA_BLOCK["S"], jc.d_model)).astype(np.float32))
    mstate = {k: torch.from_numpy(0.3 * rng.standard_normal(tuple(v.shape))
                                  .astype(np.float32))
              for k, v in ssm_mod.init_mamba_state(
                  MAMBA_BLOCK["B"], jc.d_model, m.d_state, m.d_conv,
                  m.expand).items()}
    return xl, x, floor_state, mp, mx, mstate


def mlstm_gate_check(xlstm_mod, attn_mod, xl, x, state0, dev) -> dict:
    """(a)'s float32 mLSTM run on an input gate scaled by
    ``MLSTM_GATE_SCALE``: chunkwise, card against CPU within the limit,
    and the CPU without the running maximum (``no_cummax``) above it."""
    p = dict(xl["mlstm"], w_i=xl["mlstm"]["w_i"] * MLSTM_GATE_SCALE)

    def run(d):
        return xlstm_mod.apply_mlstm(_to(p, d), x.to(d), n_heads=4,
                                     chunk=64, state=_to(state0, d))[0]

    cpu, card = run(torch.device("cpu")), run(dev)
    err = _block_err(card, cpu)
    with planted(attn_mod, "no_cummax"):
        fault = _block_err(run(torch.device("cpu")), card)
    tol = BLOCK_TOL["float32"]
    check(err <= tol < fault, f"mLSTM on strong input gates: card err "
          f"{err:.3e}, no_cummax reads {fault:.3e}, limit {tol}")
    return dict(err=err, faults={"no_cummax": fault})


def ssm_blocks_vs_cpu(xlstm_mod, ssm_mod, attn_mod, get_config, dev,
                      seed: int) -> dict:
    """Phase 13 (a): ``apply_mlstm`` (chunkwise, a decode step from its
    state, sequential), ``apply_slstm`` (from its init state and from a
    state the floor binds from) at xlstm-125m's widths and
    ``apply_mamba`` (a 300-token prefill, two decode steps from its
    state) at jamba's, on the card against the CPU in f32 and bf16 (every
    weight cast, as the serving model holds them), outputs and states
    within ``BLOCK_TOL``; then each block's planted fault
    (``BLOCK_FAULTS``) in the CPU's run read against the card's, above
    the limit, and in float32 mLSTM's stabilizer without its running
    maximum on strong input gates (:func:`mlstm_gate_check`)."""
    xl, x, floor_state, mp, mx, mstate = block_inputs(xlstm_mod, ssm_mod,
                                                      get_config, seed)
    B, D, H = x.shape[0], x.shape[2], 4
    state0 = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator()
                                       .manual_seed(seed + 44))
              for k, v in xlstm_mod.init_mlstm_state(B, D, H).items()}
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        runs = {
            "xlstm": lambda d: xlstm_block_runs(
                xlstm_mod, {k: _to(v, d, dt) for k, v in xl.items()},
                x.to(d, dt), _to(state0, d), floor_state),
            "mamba": lambda d: mamba_block_runs(
                ssm_mod, _to(mp, d, dt), mx.to(d, dt), _to(mstate, d))}
        res = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            cpu = run(torch.device("cpu"))
            card = run(dev)
            _sync(dev)
            errs = {k: _block_err(card[k], cpu[k]) for k in cpu}
            bad = {k: e for k, e in errs.items() if not e <= BLOCK_TOL[dtype]}
            check(not bad, f"{name} blocks {dtype}: card != CPU beyond "
                  f"{BLOCK_TOL[dtype]}: {bad}")
            check(all(card[k].dtype == cpu[k].dtype for k in cpu),
                  f"{name} blocks {dtype}: dtypes differ")
            faults = {}
            for kind in (("mlstm", "slstm") if name == "xlstm"
                         else ("mamba",)):
                fault = BLOCK_FAULTS[kind]
                with planted(attn_mod, fault):
                    bad_cpu = run(torch.device("cpu"))
                faults[fault] = max(_block_err(bad_cpu[k], card[k])
                                    for k in card if k.startswith(kind))
                check(faults[fault] > BLOCK_TOL[dtype], f"{name} {dtype}: "
                      f"planted fault {fault} reads {faults[fault]:.3e}, "
                      f"within the limit {BLOCK_TOL[dtype]}")
            res[name] = dict(err=max(errs.values()), errs=errs,
                             faults=faults,
                             wall_s=time.perf_counter() - t0)
        if dtype == "float32":
            res["mlstm_gates"] = mlstm_gate_check(xlstm_mod, attn_mod, xl,
                                                  x, state0, dev)
        out[dtype] = res
    log(f"phase 13 (a): xLSTM blocks at xlstm-125m's widths (d_model {D}, "
        f"d_in {2 * D}, {H} heads of {2 * D // H}; B {B}, S "
        f"{XLSTM_BLOCK['S']} chunkwise, {XLSTM_BLOCK['S_seq']} sequential) "
        f"and Mamba at jamba's (d_model 4096, d_in 8192, d_state 16, "
        f"dt_rank 256; B {MAMBA_BLOCK['B']}, S {MAMBA_BLOCK['S']} then "
        f"{MAMBA_BLOCK['decode']} decode steps) card == CPU, errors over "
        f"the largest magnitude (limits {json.dumps(BLOCK_TOL)}) with the "
        f"planted faults' readings: " + json.dumps(
            {dt: {n: dict(err=r["err"], faults=r["faults"],
                          wall_s=round(r.get("wall_s", 0.0), 2))
                  for n, r in res.items()} for dt, res in out.items()}))
    return out


def ssm_small_vs_cpu(serve_mod, build_model, get_config, TrainModel, adamw,
                     data, attn_mod, fa_kernel, seed: int, dev) -> dict:
    """Phase 13 (b): the xlstm-125m and jamba smoke configs served on the
    card against the CPU from the same weights (f32; bf16, jamba's at
    head_dim 128 so that its attention layer takes ``tc`` and
    ``decode``), jamba's MoE layers on the CPU's routing; then trained
    card against CPU (xlstm f32 and bf16, jamba f32) with the faults
    phases 11 (b) and 12 (b) plant and each recurrent block's
    (``BLOCK_TRAIN_FAULTS``) in the CPU's training."""
    tag = "phase 13 (b)"
    out = {}
    for arch, hd, tol in ((XLSTM_ARCH, 0, SERVE_BF16_TOL),
                          (JAMBA_ARCH, 128, JAMBA_SERVE_BF16_TOL)):
        n_attn = layer_counts(get_config(arch, smoke=True))["attn"]
        out[f"{arch} serve_f32"] = small_serve_matches_cpu(
            serve_mod, build_model, get_config, seed, dev, arch=arch,
            tag=tag)
        out[f"{arch} serve_bf16"] = routes = small_serve_matches_cpu(
            serve_mod, build_model, get_config, seed, dev, dtype="bfloat16",
            head_dim=hd, tol=tol, rtol=0.0, arch=arch, tag=tag)
        if dev.type == "cuda":
            check(routes == dict(tc=n_attn, decode=n_attn * 8, simt=0),
                  f"{arch} bf16 small serve flash routes {routes}")
    # jamba's smoke training drops no assignment at capacity (4 experts,
    # capacity 80 for 128 tokens x 2), so a rank shifted by one reads
    # nothing there: its MoE fault is the aux loss dropped
    jamba_faults = TRAIN_FAULTS + ("aux_dropped",
                                   BLOCK_TRAIN_FAULTS["mamba"])
    for arch, dtypes, faults in (
            (XLSTM_ARCH, ("float32", "bfloat16"), None),
            (JAMBA_ARCH, ("float32",), jamba_faults)):
        for dt in dtypes:
            out[f"{arch} train_{dt}"] = small_train_matches_cpu(
                get_config, TrainModel, adamw, data, attn_mod, fa_kernel, dt,
                seed, dev, arch=arch, tag=tag, faults_of=faults)
    return out


def profile_serve_windows(lm, wrapped, dev, seed: int,
                          steps: int = 8) -> dict:
    """One prefill of a serve cell's batch (seeded prompts; an arch with a
    frontend gets the launcher's ``0.02 * ones`` embeddings and a cache
    ``frontend_len`` longer) and a window of ``steps`` decode steps after
    it (warmed once, then from the prefill's index again), each profiled
    with ranges around the functions ``wrapped`` (:func:`ranged_profile`,
    read from the raw events).  The decode tokens are arbitrary: the work
    depends only on the shapes and positions."""
    model, cfg, B = lm["model"], lm["cfg"], lm["B"]
    rng = np.random.default_rng(seed + 13)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, LM_PROMPT)),
                             device=dev)
    fe = (torch.full((B, cfg.frontend_len, cfg.frontend_dim), 0.02,
                     device=dev) if cfg.frontend != "none" else None)
    tok = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    out = {}
    with torch.inference_mode():
        cache = model.init_cache(B, LM_PROMPT + LM_STEPS + cfg.frontend_len)

        def window():
            for _ in range(steps):
                model.decode_step(tok, cache)

        out["prefill"] = ranged_profile(
            lambda: model.prefill(prompt, cache, fe), wrapped, fast=True)
        start = cache["index"]
        window()                                   # warm
        cache["index"] = start
        out["decode"] = ranged_profile(window, wrapped, fast=True)
    return out


def _log_window(tag: str, what: str, B: int, steps: int, prof: dict,
                groups: dict, extra: str = "") -> dict:
    """Log one profiled window's split (:func:`profile_serve_windows`) and
    return its record."""
    busy, wall = prof["busy_us"], prof["wall_us"]
    shares = ", ".join(f"{g} {us:.1f} us ({us / busy:.3f})"
                       for g, us in groups.items()) if busy else \
        "not measured (the profiler saw no device time)"
    head = (f"one prefill of {B} x {LM_PROMPT} tokens" if what == "prefill"
            else f"decode window of {steps} steps")
    log(f"{tag}: {head}: device busy {busy:.1f} us of {wall:.1f} us wall, "
        f"idle share {(1 - busy / wall) if busy else float('nan'):.4f}; by "
        f"group: {shares}{extra}; device spans by range "
        f"{json.dumps(prof['range_spans'])}; the largest kernels (us) "
        f"{json.dumps(prof['top'])}")
    return dict(groups=groups, busy_us=busy, wall_us=wall, top=prof["top"],
                spans=prof["range_spans"])


def serve_split(lm, wrapped, dev, seed: int, steps: int = 8,
                tag: str = "phase 13 (c)") -> dict:
    """A serve cell's device split (:func:`profile_serve_windows`): flash,
    every kernel under each label of ``wrapped`` (``(module, name,
    label)``, labels ``p11.*``), the other matrix products, the rest, and
    the idle share."""
    out = {}
    for what, prof in profile_serve_windows(lm, wrapped, dev, seed,
                                            steps).items():
        groups = {"flash": prof["flash_us"]}
        mm = prof["mm_us"]
        for label, (us, mm_in, _) in prof["ranges"].items():
            groups[label[len("p11."):]] = us
            mm -= mm_in
        groups["matmul"] = mm
        groups["other"] = prof["busy_us"] - sum(groups.values())
        out[what] = _log_window(tag, what, lm["B"], steps, prof, groups)
    log(f"{tag}: clocks, power, temperature after it: {_clocks()}")
    return out


def ssm_serve_cell(serve_mod, build_model, get_config, pm_ref, fa_ops,
                   fa_ref, fa_kernel, pm_kernel, seed: int, dev,
                   cfg, tag: str, wrapped) -> dict:
    """Phase 13 (c) / (e): phase 5's traffic on ``cfg`` at its published
    width (admission equal to the plain version's, finite logits, the
    flash launches of its attention layers, the MoE paths); for an arch
    with attention the flash op at its prefill and decode shapes (phase
    6's checks and timings); the device split with ranges around
    ``wrapped``."""
    lm = lm_slice(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                  pm_kernel, seed, dev, tag=tag, cfg=cfg)
    res = {k: lm[k] for k in ("B", "fa_launches", "fa_routes", "pm_launches",
                              "pm_routes", "timings", "moe_calls",
                              "peak_bytes")}
    if layer_counts(cfg)["attn"]:
        res["flash"] = flash_timings(fa_ops, fa_ref, fa_kernel, lm, dev,
                                     seed, tag=tag)
    res["split"] = serve_split(lm, wrapped, dev, seed, tag=tag)
    del lm
    torch.cuda.empty_cache()
    return res


def ssm_phase(serve_mod, build_model, fa_ops, fa_ref, fa_kernel, pm_ref,
              pm_kernel, dev, seed: int) -> dict:
    """Phase 13: the xLSTM and Mamba sublayers on the card: (a) the blocks
    at full width card against CPU, with planted faults; (b) the
    xlstm-125m and jamba smoke configs served and trained card against
    CPU; (c) ``serve_xlstm_125m``; (d) ``train_xlstm_125m_s4096``; (e)
    ``serve_jamba_v01_L16``."""
    import repro_torch.data as data
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    log(f"phase 13: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"on the card at the start")
    marks = [("start", time.perf_counter())]

    def mark(part):
        marks.append((part, time.perf_counter()))
        log(f"phase 13 {part} took {marks[-1][1] - marks[-2][1]:.1f} s")

    out = dict(blocks=ssm_blocks_vs_cpu(xlstm_mod, ssm_mod, attn_mod,
                                        get_config, dev, seed))
    mark("(a)")
    out["small"] = ssm_small_vs_cpu(serve_mod, build_model, get_config,
                                    TrainModel, adamw, data, attn_mod,
                                    fa_kernel, seed, dev)
    mark("(b)")
    xlstm_ranges = [(xlstm_mod, "apply_mlstm", "p11.mlstm"),
                    (xlstm_mod, "apply_slstm", "p11.slstm")]
    out["serve_xlstm"] = ssm_serve_cell(
        serve_mod, build_model, get_config, pm_ref, fa_ops, fa_ref,
        fa_kernel, pm_kernel, seed, dev, get_config(XLSTM_ARCH),
        "phase 13 (c)", xlstm_ranges)
    mark("(c)")
    cell = train_cell(get_config, TrainModel, adamw, data, steps_mod,
                      attn_mod, transformer, fa_kernel, dev, seed,
                      cfg=get_config(XLSTM_ARCH),
                      name="train_xlstm_125m_s4096", tag="phase 13 (d)",
                      recurrent=[(m, n) for m, n, _ in xlstm_ranges],
                      timed=XLSTM_TRAIN_TIMED, profile_first=True)
    cell.pop("cfg")
    out["train_xlstm"] = cell
    mark("(d)")
    jamba = dataclasses.replace(get_config(JAMBA_ARCH),
                                n_layers=JAMBA_SERVE_LAYERS)
    out["serve_jamba"] = ssm_serve_cell(
        serve_mod, build_model, get_config, pm_ref, fa_ops, fa_ref,
        fa_kernel, pm_kernel, seed, dev, jamba, "phase 13 (e)",
        [(ssm_mod, "apply_mamba", "p11.mamba"),
         (moe_mod, "apply_moe", "p11.moe"),
         (moe_mod, "apply_moe_dense", "p11.moe_dense")])
    mark("(e)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 13 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: encoder-decoder stacks, cross-attention and the frontends
# (seamless-m4t-medium, paligemma-3b)
# ---------------------------------------------------------------------------

SEAMLESS_ARCH, PALIGEMMA_ARCH = "seamless-m4t-medium", "paligemma-3b"
ENCDEC_FAULTS = TRAIN_FAULTS + ("cross_causal",)
# (b) the bf16 small serves: seamless's smoke config at head_dim 64 with
# 32 frames and 32-token prompts (so the encoder, the decoder's prefill
# and the cross-attention's prefill take tc, one head per kv head), and
# paligemma's at head_dim 256 (its 8-embedding prefix and 16 tokens x 4
# heads of one kv head: tc; a decode step's 4 rows: decode)
ENCDEC_SMALL = {SEAMLESS_ARCH: dict(head_dim=64, prompt_len=32,
                                    over=dict(frontend_len=32)),
                PALIGEMMA_ARCH: dict(head_dim=256, prompt_len=16, over={})}


class FlashShape(NamedTuple):
    """One call form of phase 14 (a) at its full size: flat ``q [B *
    heads, Sq, hd]`` at positions ``q_at + arange(Sq)``, ``k/v [B *
    kv_heads, Sk, hd]`` at ``arange(Sk)``; ``lse`` a training launch;
    ``want`` its launches on ``cell``'s path, where the calls of ``form``
    (:func:`launches_by_form`) on ``route`` are counted."""
    name: str
    B: int
    heads: int
    kv_heads: int
    Sq: int
    Sk: int
    hd: int
    causal: bool
    q_at: int
    route: str
    lse: bool
    cell: str
    form: str
    want: int


def encdec_flash_shapes(get_config, B: int) -> list:
    """The call forms the three cells give the flash op, at ``B`` admitted
    requests (the serves) and ``TRAIN_BATCH`` sequences (training): the
    decode rows at the last step's position."""
    sm, pg = get_config(SEAMLESS_ARCH), get_config(PALIGEMMA_ARCH)
    F, L = sm.frontend_len, LM_PROMPT + LM_STEPS
    last = L - 1
    n_train = 2 * (1 + TRAIN_TIMED)             # remat: twice a step
    sh = (sm.n_heads, sm.n_kv_heads)
    pgh = (pg.n_heads, pg.n_kv_heads)
    ss, sp, st = "serve_seamless", "serve_paligemma", "train_seamless"
    return [
        FlashShape("seamless_encoder", B, *sh, F, F, 64, False, 0, "tc",
                   False, ss, "enc", sm.n_enc_layers),
        FlashShape("seamless_cross_prefill", B, *sh, LM_PROMPT, F, 64, False,
                   0, "tc", False, ss, "cross", sm.n_layers),
        FlashShape("seamless_self_prefill", B, *sh, LM_PROMPT, L + F, 64,
                   True, 0, "tc", False, ss, "self", sm.n_layers),
        FlashShape("seamless_cross_decode", B, *sh, 1, F, 64, False, last,
                   "decode", False, ss, "cross", sm.n_layers * LM_STEPS),
        FlashShape("seamless_self_decode", B, *sh, 1, L + F, 64, True, last,
                   "decode", False, ss, "self", sm.n_layers * LM_STEPS),
        FlashShape("paligemma_prefill", B, *pgh, LM_PROMPT + pg.frontend_len,
                   L + pg.frontend_len, 256, True, 0, "tc", False, sp,
                   "self", pg.n_layers),
        FlashShape("paligemma_decode", B, *pgh, 1, L + pg.frontend_len, 256,
                   True, L + pg.frontend_len - 1, "decode", False, sp,
                   "self", pg.n_layers * LM_STEPS),
        FlashShape("seamless_train_cross", TRAIN_BATCH, *sh, TRAIN_SEQ, F,
                   64, False, 0, "tc", True, st, "cross",
                   sm.n_layers * n_train),
        FlashShape("seamless_train_encoder", TRAIN_BATCH, *sh, F, F, 64,
                   False, 0, "tc", True, st, "enc", sm.n_enc_layers * n_train),
    ]


def encdec_flash_vs_plain(fa_ref, fa_kernel, get_config, B: int, dev,
                          seed: int) -> dict:
    """Phase 14 (a): the flash op at every call form of the three cells
    (:func:`encdec_flash_shapes`).  The kernel (the training launches
    with the log-sum-exp) against the plain version: bf16 on as many
    requests as the free memory lets the plain version hold (2e-2 and
    ``FA_ROW_TOL`` per row; lse within ``FA_LSE_TOL``), f32 at one
    request (2e-5); each call on its route.  Planted faults
    (:func:`fa_fault_errs`: a middle key tile dropped or served stale,
    the tile of the last row's key dropped, and a causal mask on a
    non-causal call where a row has later keys) must read above the row
    limit.  Then
    the kernel's, the plain version's and SDPA's stream time per call
    (CUDA events) beside the bound: the bf16 FLOPs of the visible pairs
    at 989 TFLOP/s or the bytes the call needs (q, out and lse once, K
    and V of the keys some row sees) at 3.35 TB/s, whichever is
    larger."""
    out = {}
    for shape in encdec_flash_shapes(get_config, B):
        s = shape
        H, HK, G = s.B * s.heads, s.B * s.kv_heads, s.heads // s.kv_heads
        rng = np.random.default_rng(seed + 23)
        mk = (lambda *sz: torch.from_numpy(rng.standard_normal(
            sz, dtype=np.float32)).to(device=dev))
        q32, k32, v32 = mk(H, s.Sq, s.hd), mk(HK, s.Sk, s.hd), \
            mk(HK, s.Sk, s.hd)
        qp = torch.arange(s.Sq, device=dev, dtype=torch.float32) + s.q_at
        kp = torch.arange(s.Sk, device=dev, dtype=torch.float32)
        kw = dict(g=G, scale=1.0 / np.sqrt(s.hd), causal=s.causal, window=0,
                  attn_cap=0.0)
        plain = (fa_ref.flash_attention_flat_lse if s.lse
                 else fa_ref.flash_attention_flat)
        # f32 at one request
        a32 = (q32[:s.heads], k32[:s.kv_heads], v32[:s.kv_heads], qp, kp)
        got = fa_kernel.flash_attention_cuda(*a32, **kw, lse=s.lse)
        want = plain(*a32, **kw)
        _sync(dev)
        if s.lse:
            (got, lse32), (want, want_lse32) = got, want
            lerr32 = float((lse32 - want_lse32).abs().max())
            check(lerr32 <= FA_LSE_TOL[torch.float32],
                  f"{s.name} f32 lse err {lerr32}")
        ok, err32 = fa_close(got, want, torch.float32)
        check(ok, f"flash {s.name}: kernel != plain in f32: {err32}")
        del got, want
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        del q32, k32, v32
        before = dict(fa_kernel.flash_attention_cuda.route_launches)
        got = fa_kernel.flash_attention_cuda(q, k, v, qp, kp, **kw,
                                             lse=s.lse)
        after = fa_kernel.flash_attention_cuda.route_launches
        took = [r for r in after if after[r] != before[r]]
        check(took == [s.route], f"flash {s.name} took {took}, not "
              f"{s.route}")
        lse = None
        if s.lse:
            got, lse = got
        free, _ = torch.cuda.mem_get_info()
        per_req = 4 * s.heads * s.Sq * s.Sk * 4
        Bc = max(1, min(s.B, int(0.7 * free) // per_req))
        cmp = (q[:Bc * s.heads], k[:Bc * s.kv_heads], v[:Bc * s.kv_heads],
               qp, kp)
        want = plain(*cmp, **kw)
        _sync(dev)
        lerr = None
        if s.lse:
            want, want_lse = want
            lerr = float((lse[:Bc * s.heads] - want_lse).abs().max())
            check(lerr <= FA_LSE_TOL[torch.bfloat16],
                  f"{s.name} bf16 lse err {lerr}")
        ok, err = fa_close(got[:Bc * s.heads], want, torch.bfloat16)
        row = fa_row_err(got[:Bc * s.heads], want)
        check(ok, f"flash {s.name}: kernel != plain in bf16: max abs err "
              f"{err}, row err {row}")
        tile, stages = route_tile(s.route, s.hd)
        one = (q[:s.heads], k[:s.kv_heads], v[:s.kv_heads], qp, kp)
        faults = fa_fault_errs(fa_ref, one, kw, want[:s.heads], tile,
                               stages)
        check(min(faults.values()) > FA_ROW_TOL,
              f"a planted fault at {s.name} reads {json.dumps(faults)}, "
              f"within the row limit {FA_ROW_TOL}")
        del want
        route, splits = fa_kernel.plan(q.dtype, s.hd, G * s.Sq, s.Sk, HK,
                                       fa_kernel.n_sms(dev.index or 0),
                                       lse=s.lse)
        o = torch.empty_like(q)
        lse_buf = (torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
                   if s.lse else None)
        ws = (torch.empty(fa_kernel.workspace_floats(HK, splits, G * s.Sq,
                                                     s.hd),
                          dtype=torch.float32, device=dev)
              if route == "decode" and fa_kernel.needs_workspace(
                  q.dtype, s.hd, splits) else None)

        def run_kernel():
            fa_kernel.launch(q, k, v, qp, kp, o, **kw, workspace=ws,
                             lse=lse_buf)

        def run_plain():
            plain(*cmp, **kw)

        run_lib = _sdpa_library(q, k, v, qp, kp, kw["scale"], s.B, s.causal)
        n_k = 20 if s.Sq == 1 else 5
        ms = _event_ms(run_kernel, n_k)
        plain_ms = _event_ms(run_plain, 2)
        lib = _event_ms(run_lib, n_k)
        ok_pairs = (kp < 2.0 ** 29)[None, :].expand(s.Sq, s.Sk)
        if s.causal:
            ok_pairs = ok_pairs & (qp[:, None] >= kp[None, :])
        pairs = int(ok_pairs.sum()) * H
        keys = int(ok_pairs.any(dim=0).sum())     # keys some row sees
        flops = 4 * s.hd * pairs
        n_bytes = 2 * (2 * q.numel() + 2 * HK * keys * s.hd) + (
            4 * H * s.Sq if s.lse else 0)
        bound_ops = flops / H100_BF16_FLOPS * 1e3
        bound_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        by = "operations" if bound_ops >= bound_bytes else "bytes"
        res = dict(shape=[list(q.shape), list(k.shape)], route=route,
                   splits=splits, causal=s.causal, lse=s.lse,
                   want=s.want, ms=ms, plain_ms=plain_ms,
                   plain_B=Bc, library_ms=lib, bound_ms=bound, bound_by=by,
                   flops=flops, bytes=n_bytes, err=max(err, err32),
                   err32=err32, row_err=row, lse_err=lerr, faults=faults)
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if by == "operations"
                else f"{n_bytes / ms / 1e9:.4f} TB/s")
        log(f"phase 14 (a): flash {s.name}: q {list(q.shape)} x k/v "
            f"{list(k.shape)} bf16, g = {G}, "
            f"{'causal' if s.causal else 'non-causal'}"
            f"{', with lse' if s.lse else ''}, rows at {s.q_at}..; route "
            f"{route}, splits {splits}; {s.want} launches due on the "
            f"{s.cell} path; "
            f"kernel {ms * 1e3:.3f} us ({rate}), plain {plain_ms * 1e3:.3f}"
            f" us (B = {Bc}), SDPA {lib * 1e3:.3f} us (stream time per call"
            f", CUDA events); bound {bound * 1e3:.3f} us by {by} ({flops} "
            f"flops over {pairs} visible pairs, {n_bytes} bytes); kernel vs"
            f" plain: f32 max abs err {err32:.3e}, bf16 {err:.3e} (B = "
            f"{Bc}), row {row:.3e} (limit {FA_ROW_TOL})"
            + (f", lse {lerr:.3e}" if s.lse else "")
            + f"; planted faults ({tile}-key tile, ring of {stages}) "
            f"{json.dumps({n: round(e, 6) for n, e in faults.items()})}")
        out[s.name] = res
        del q, k, v, o, got, ws, lse_buf, lse, cmp, one
        torch.cuda.empty_cache()
    log(f"phase 14 (a): clocks, power, temperature after it: {_clocks()}")
    return out


def encdec_small_vs_cpu(serve_mod, build_model, get_config, TrainModel,
                        adamw, data, attn_mod, fa_kernel, seed: int,
                        dev) -> dict:
    """Phase 14 (b): the seamless and paligemma smoke configs served on
    the card against the CPU from the same weights (f32; bf16 at
    ``ENCDEC_SMALL``'s head_dim, every flash call on ``tc`` or
    ``decode``), then trained card against CPU in f32 and bf16 with
    phase 11's faults planted in the CPU's training, and for seamless
    also its cross-attention made causal."""
    tag = "phase 14 (b)"
    out = {}
    for arch, small in ENCDEC_SMALL.items():
        out[f"{arch} serve_f32"] = small_serve_matches_cpu(
            serve_mod, build_model, get_config, seed, dev, arch=arch,
            tag=tag)
        out[f"{arch} serve_bf16"] = routes = small_serve_matches_cpu(
            serve_mod, build_model, get_config, seed, dev, dtype="bfloat16",
            tol=SERVE_BF16_TOL, rtol=0.0, arch=arch, tag=tag, **small)
        cfg = small_serve_config(get_config, "bfloat16", small["head_dim"],
                                 arch, small["over"])
        prompt, step = flash_calls(cfg)
        if dev.type == "cuda":
            check(routes == dict(tc=prompt, decode=step * 8, simt=0),
                  f"{arch} bf16 small serve flash routes {routes}")
    for arch, small in ENCDEC_SMALL.items():
        faults = ENCDEC_FAULTS if get_config(arch).enc_dec else TRAIN_FAULTS
        for dt in ("float32", "bfloat16"):
            out[f"{arch} train_{dt}"] = small_train_matches_cpu(
                get_config, TrainModel, adamw, data, attn_mod, fa_kernel, dt,
                seed, dev, arch=arch, head_dim=small["head_dim"], tag=tag,
                faults_of=faults)
    return out


def encdec_serve_split(lm, attn_mod, dev, seed: int, steps: int = 8,
                       tag: str = "phase 14 (c)") -> dict:
    """A serve cell's device split (:func:`profile_serve_windows`) with
    ranges around every attention call by its form
    (:func:`attention_form`): the flash kernels of the encoder's, the
    decoder's self and the cross-attention's calls (the decode route's
    combine included), all matrix products, the rest, and the idle
    share; beside it each form's whole layer (projections included)."""
    out = {}
    wrapped = [(attn_mod, "attention", attention_form)]
    for what, prof in profile_serve_windows(lm, wrapped, dev, seed,
                                            steps).items():
        r = prof["ranges"]
        forms = [label for label in attention_form.labels if r[label][0]]
        groups = {f"flash_{label[4:-5]}": r[label][2] for label in forms}
        groups["matmul"] = prof["mm_us"]
        groups["other"] = prof["busy_us"] - sum(groups.values())
        layers = {label[4:]: round(r[label][0], 1) for label in forms}
        out[what] = _log_window(
            tag, what, lm["B"], steps, prof, groups,
            f"; whole attention layers by form (us, projections included) "
            f"{json.dumps(layers)}")
        out[what]["attention_us"] = layers
    log(f"{tag}: clocks, power, temperature after it: {_clocks()}")
    return out


def encdec_serve_cell(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                      pm_kernel, attn_mod, seed: int, dev, arch: str,
                      tag: str) -> dict:
    """Phase 14 (c) / (d): phase 5's traffic on ``arch`` at its published
    size through ``serve`` (admission equal to the plain version's with
    one ``smem`` launch, finite logits, the flash launches by route, the
    cross K/V once a unit at the prefill), then the device split."""
    lm = lm_slice(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                  pm_kernel, seed, dev, tag=tag, cfg=get_config(arch))
    res = {k: lm[k] for k in ("B", "fa_launches", "fa_routes", "fa_forms",
                              "pm_launches", "pm_routes", "timings",
                              "peak_bytes", "kv_bytes", "cross_bytes",
                              "cross_kv_calls")}
    res["split"] = encdec_serve_split(lm, attn_mod, dev, seed, tag=tag)
    del lm
    torch.cuda.empty_cache()
    return res


def encdec_phase(serve_mod, build_model, fa_ref, fa_kernel, pm_ref,
                 pm_kernel, dev, seed: int) -> dict:
    """Phase 14: encoder-decoder stacks, cross-attention and the frontends
    on the card: (a) the flash op at the cells' call forms against its
    plain version, with planted faults, timed beside the bound and SDPA;
    (b) the seamless and paligemma smoke configs served and trained card
    against CPU; (c) ``serve_seamless_m4t_medium``; (d)
    ``serve_paligemma_3b``; (e) ``train_seamless_m4t_medium_s4096``."""
    import repro_torch.data as data
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    log(f"phase 14: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"on the card at the start")
    marks = [("start", time.perf_counter())]

    def mark(part):
        marks.append((part, time.perf_counter()))
        log(f"phase 14 {part} took {marks[-1][1] - marks[-2][1]:.1f} s")

    B = int(plain_grants(serve_mod, pm_ref, seed, "cpu").sum())
    out = dict(flash=encdec_flash_vs_plain(fa_ref, fa_kernel, get_config, B,
                                           dev, seed))
    mark("(a)")
    out["small"] = encdec_small_vs_cpu(serve_mod, build_model, get_config,
                                       TrainModel, adamw, data, attn_mod,
                                       fa_kernel, seed, dev)
    mark("(b)")
    for part, arch, name in (("(c)", SEAMLESS_ARCH, "serve_seamless"),
                             ("(d)", PALIGEMMA_ARCH, "serve_paligemma")):
        out[name] = encdec_serve_cell(
            serve_mod, build_model, get_config, pm_ref, fa_kernel,
            pm_kernel, attn_mod, seed, dev, arch, f"phase 14 {part}")
        check(out[name]["B"] == B, f"{arch}: {out[name]['B']} admitted, "
              f"(a) timed {B}")
        mark(part)
    cell = train_cell(get_config, TrainModel, adamw, data, steps_mod,
                      attn_mod, transformer, fa_kernel, dev, seed,
                      cfg=get_config(SEAMLESS_ARCH),
                      name="train_seamless_m4t_medium_s4096",
                      tag="phase 14 (e)")
    cell.pop("cfg")
    out["train_seamless"] = cell
    mark("(e)")
    forms = dict(serve_seamless=out["serve_seamless"]["fa_forms"],
                 serve_paligemma=out["serve_paligemma"]["fa_forms"],
                 train_seamless=cell["forms"])
    for s in encdec_flash_shapes(get_config, B):
        got = forms[s.cell].get(f"{s.form} {s.route}", 0)
        check(got == s.want, f"{s.name}: {got} {s.form} launches on "
              f"{s.route} on the {s.cell} path, not {s.want}")
        out["flash"][s.name]["launches"] = got
    log(f"phase 14: flash launches by call form and route, counted on each "
        f"cell's path: {json.dumps(forms)}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the int8 KV cache (qwen1.5-32b at its published size)
# ---------------------------------------------------------------------------

INT8_ARCH = "qwen1.5-32b"
# serve_llama3_8b's traffic but 32 proposed requests, not 128: 13 admitted
# requests' int8 cache (18.3 GB) does not fit beside qwen1.5-32b's 70.4 GB
# of weights on one card; 4 of 32 are admitted at seed 0
INT8_REQUESTS = 32
INT8_SMALL_ARCHS = ("llama3-8b", "qwen1.5-32b")
# _sdpa_chunked_quant card against CPU on the same int8 cache: float32
# sums in another order (2e-5, FA_TOL's); in bf16 one rounding of the
# float32 output may move by a bf16 ulp (2e-2)
INT8_ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
INT8_FAULTS = ("wrapped_cast", "flipped_value")
# bf16 magnitudes 0x3a80-0x4480 (2**-10 to 1024): among them the 420 whose
# max|x| / scale is 127.5 in bf16
INT8_MAG_BITS = np.arange(0x3A80, 0x4481, dtype=np.uint32)


class Int8Case(NamedTuple):
    name: str
    B: int
    KV: int
    G: int
    Sq: int
    Sk: int
    hd: int
    window: int = 0
    cap: float = 0.0
    chunk: int = 16384
    q_block: Optional[int] = None    # None: the port's QUANT_Q_BLOCK


# _sdpa_chunked_quant at the cells' forms: qwen1.5-32b's decode over its
# 2,080-position cache (one chunk, and chunks of 1,024 with the last
# padded), its prefill cut to 1 request and 8 heads, llama3-8b's GQA
# decode, and gemma2's window and softcap with short chunks and blocks
INT8_ATTN_CASES = (
    Int8Case("qwen_decode", 4, 40, 1, 1, 2080, 128),
    Int8Case("qwen_decode_chunks", 4, 40, 1, 1, 2080, 128, chunk=1024),
    Int8Case("qwen_prefill_cut", 1, 8, 1, 512, 2080, 128, chunk=1024),
    Int8Case("llama3_decode", 13, 8, 4, 1, 2080, 128),
    Int8Case("gemma2_window_cap", 1, 4, 2, 64, 600, 256, window=128,
             cap=50.0, chunk=256, q_block=32),
)


def wrapped_quant(x: torch.Tensor):
    """``models.attention._quant`` without its clamp: the cast wraps a
    rounded 128 to -128 (the planted fault ``wrapped_cast``)."""
    scale = torch.maximum(x.abs().amax(dim=-1) / x.new_full((), 127.0),
                          x.new_full((), 1e-8))
    return torch.round(x / scale[..., None]).to(torch.int8), scale.float()


def flip_one(q: torch.Tensor, pos: int = 0) -> torch.Tensor:
    """A copy of an int8 tensor ``[..., S, hd]`` with one value negated:
    the largest of row ``pos`` of its first ``[S, hd]`` slice (of a cache
    ``[B, KV, S, hd]``: batch 0, head 0, position ``pos``) -- the planted
    fault ``flipped_value``."""
    q = q.clone()
    row = q.view(-1, *q.shape[-2:])[0, pos]
    j = int(row.int().abs().argmax())
    row[j] = max(-127, min(127, -int(row[j])))
    return q


@contextlib.contextmanager
def int8_planted(attn_mod, fault: Optional[str]):
    """Within the block ``attn_mod`` quantizes with the wrapped cast
    (``wrapped_cast``) or flips one int8 value of the first value row
    written to an int8 cache (``flipped_value``: the largest of batch 0,
    head 0, at that write's first position, in the first layer)."""
    quant, update = attn_mod._quant, attn_mod.cache_update
    flipped = []

    def flipping_update(layer_cache, k_new, v_new, index):
        out = update(layer_cache, k_new, v_new, index)
        if not flipped and layer_cache["v"].dtype == torch.int8:
            v = layer_cache["v"][:, :, index:]
            v.copy_(flip_one(v))
            flipped.append(index)
        return out

    if fault == "wrapped_cast":
        attn_mod._quant = wrapped_quant
    elif fault == "flipped_value":
        attn_mod.cache_update = flipping_update
    try:
        yield
    finally:
        attn_mod._quant, attn_mod.cache_update = quant, update


def int8_rows(sign: float, hd: int, seed: int) -> np.ndarray:
    """One row a magnitude of ``INT8_MAG_BITS``: that magnitude with
    ``sign`` at column 3, the rest uniform within 0.9 of it."""
    mag = (INT8_MAG_BITS << 16).view(np.float32)
    rng = np.random.default_rng(seed)
    rows = (rng.uniform(-0.9, 0.9, (len(mag), hd)) * mag[:, None]
            ).astype(np.float32)
    rows[:, 3] = sign * mag
    return rows


def int8_quant_vs_cpu(attn_mod, dev, seed: int) -> dict:
    """Phase 15 (a): ``_quant`` on the card against the CPU, bit for bit
    (int8 values and float32 scales), on every bf16 magnitude of
    ``INT8_MAG_BITS`` of either sign (the 127.5 rows saturate: 127 for a
    positive maximum, -128 for a negative one) and on random keys of the
    qwen cell's decode write ``[4, 40, 1, 128]`` and prefill write cut to
    ``[4, 40, 64, 128]`` in bf16 and f32; the planted faults on the
    CPU's side differ in rows."""
    rng = np.random.default_rng(seed + 15)
    inputs = {f"bf16_magnitudes_{name}": torch.from_numpy(
        int8_rows(sign, 128, seed)).bfloat16()
        for name, sign in (("pos", 1.0), ("neg", -1.0))}
    for shape in ((4, 40, 1, 128), (4, 40, 64, 128)):
        x = rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1])[
            ..., None]
        for dt in (torch.bfloat16, torch.float32):
            inputs[f"{str(dt)[6:]}_{list(shape)}"] = torch.from_numpy(
                x.astype(np.float32)).to(dt)
    out = {}
    for name, x in inputs.items():
        q_cpu, s_cpu = attn_mod._quant(x)
        q, s = attn_mod._quant(x.to(dev))
        q, s = q.cpu(), s.cpu()
        rows = int((q != q_cpu).any(-1).sum() + (s != s_cpu).sum())
        check(rows == 0, f"_quant {name}: {rows} rows differ card vs CPU")
        mags = x.abs().amax(-1, keepdim=True)
        half = int(((x.abs() == mags) & (x.abs() / (mags / 127.0)
                                        == 127.5)).any(-1).sum())
        faults = {"wrapped_cast": int((wrapped_quant(x)[0] != q).any(-1)
                                      .sum()),
                  "flipped_value": int((flip_one(q_cpu) != q).any(-1)
                                       .sum())}
        check(faults["flipped_value"] > 0, f"_quant {name}: a flipped "
              f"value not seen")
        if name.startswith("bf16_magnitudes"):
            check(half == 840 // 2, f"{name}: {half} rows at 127.5, not 420")
            at = (x.abs() / (mags / 127.0) == 127.5).any(-1)
            want = 127 if name.endswith("pos") else -128
            check(bool((q[at].int() == want).any(-1).all()),
                  f"{name}: a 127.5 row does not saturate to {want}")
            check((faults["wrapped_cast"] > 0) == name.endswith("pos"),
                  f"{name}: the wrapped cast differs in "
                  f"{faults['wrapped_cast']} rows")
        out[name] = dict(rows=int(x.numel() // x.shape[-1]), differ=rows,
                         rows_at_127_5=half, faults=faults)
    log(f"phase 15 (a): _quant card == CPU bit for bit (int8 values and "
        f"f32 scales) on {sum(r['rows'] for r in out.values())} rows; rows "
        f"whose max|x| / scale is 127.5 and the rows each planted fault "
        f"changes (CPU side): " + json.dumps(
            {k: (v["rows_at_127_5"], v["faults"]) for k, v in out.items()}))
    return out


def int8_attn_inputs(attn_mod, case: Int8Case, dtype, seed: int) -> tuple:
    """q ``[B, KV, G, Sq, hd]`` in ``dtype`` (a prefill's rows at
    positions ``0 .. Sq - 1``; a decode row at the last written
    position), and the CPU's int8 cache of random keys and values in
    ``dtype``, its last 32 positions unwritten (zeros, as a serve's cache
    holds them): ``(q, (k8, ks, v8, vs), k, v, q_pos, k_pos)`` on the
    CPU."""
    rng = np.random.default_rng(seed + case.Sk + case.Sq)
    B, KV, G, Sq, Sk, hd = case[1:7]
    q = torch.from_numpy(rng.standard_normal((B, KV, G, Sq, hd)).astype(
        np.float32) * 2).to(dtype)
    k = torch.from_numpy(rng.standard_normal((B, KV, Sk, hd)).astype(
        np.float32) * 2).to(dtype)
    v = torch.from_numpy(rng.standard_normal((B, KV, Sk, hd)).astype(
        np.float32)).to(dtype)
    written = Sk - 32
    k[:, :, written:] = 0
    v[:, :, written:] = 0
    k8, ks = attn_mod._quant(k)
    v8, vs = attn_mod._quant(v)
    q_pos = torch.arange(Sq) if Sq > 1 else torch.tensor([written - 1])
    return q, (k8, ks, v8, vs), k, v, q_pos, torch.arange(Sk)


def heaviest_key(q, k8, ks, q_pos, k_pos, window: int) -> int:
    """The key that query row 0 of batch 0, head 0 weighs most: its
    largest visible score (a softcap keeps the order)."""
    k = k8[0, 0].float() * ks[0, 0, :, None]
    s = k @ q[0, 0, 0, 0].float()
    ok = k_pos <= q_pos[0]
    if window > 0:
        ok &= (q_pos[0] - k_pos) < window
    return int(s.masked_fill(~ok, -float("inf")).argmax())


def int8_attention_vs_cpu(attn_mod, dev, seed: int) -> dict:
    """Phase 15 (a): ``_sdpa_chunked_quant`` on the card against the CPU
    on the same int8 cache over ``INT8_ATTN_CASES`` in f32 and bf16,
    within ``INT8_ATTN_TOL``; the planted faults on the CPU's side read
    above it in every case: one int8 value flipped (the largest of the
    value row at the key that query row 0 of batch 0, head 0 weighs
    most, :func:`heaviest_key`: a prefill's first row attends to key 0
    alone, a decode row over 2,048 keys gives its heaviest key a share
    no spread dilutes), and the keys and values quantized with the
    wrapped cast (bf16: ~1 row in 6 lands on 127.5)."""
    out = {}
    for case in INT8_ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, cache, k, v, q_pos, k_pos = int8_attn_inputs(attn_mod, case,
                                                            dtype, seed)
            kw = dict(causal=True, window=case.window, attn_cap=case.cap,
                      scale=1.0 / np.sqrt(case.hd), chunk=case.chunk)
            if case.q_block:
                kw["q_block"] = case.q_block

            def run(q, cache, device):
                return attn_mod._sdpa_chunked_quant(
                    q.to(device), *(t.to(device) for t in cache),
                    q_pos.to(device), k_pos.to(device), **kw).cpu().float()

            cpu = run(q, cache, "cpu")
            card = run(q, cache, dev)
            err = float((card - cpu).abs().max())
            tol = INT8_ATTN_TOL[dtype]
            name = f"{case.name} {str(dtype)[6:]}"
            check(bool(torch.isfinite(card).all()) and err <= tol,
                  f"_sdpa_chunked_quant {name}: card vs CPU {err:.3e} > "
                  f"{tol}")
            k8, ks, v8, vs = cache
            at = heaviest_key(q, k8, ks, q_pos, k_pos, case.window)
            faults = {"flipped_value": float(
                (run(q, (k8, ks, flip_one(v8, at), vs), "cpu") - card)
                .abs().max())}
            if dtype == torch.bfloat16:
                wk, wks = wrapped_quant(k)
                wv, wvs = wrapped_quant(v)
                faults["wrapped_cast"] = float(
                    (run(q, (wk, wks, wv, wvs), "cpu") - card).abs().max())
            check(all(e > tol for e in faults.values()),
                  f"_sdpa_chunked_quant {name}: a planted fault within the "
                  f"limit {tol}: {faults}")
            out[name] = dict(err=err, tol=tol, faults=faults, key=at)
    log("phase 15 (a): _sdpa_chunked_quant card vs CPU (max abs diff, "
        "limit, planted faults on the CPU's side, the flipped key): "
        + json.dumps(
            {k: (f"{v['err']:.3e}", v["tol"], {f: f"{e:.3e}" for f, e in
                                               v["faults"].items()},
                 v["key"]) for k, v in out.items()}))
    return out


def int8_small_vs_cpu(serve_mod, build_model, get_config, attn_mod,
                      fa_kernel, seed: int, dev) -> dict:
    """Phase 15 (b): the llama3-8b and qwen1.5-32b smoke configs with an
    int8 cache served on the card against the CPU from the same weights
    (phase 2's small serve: f32 within 1e-3, bf16 within
    ``SERVE_BF16_TOL``), no flash launch on the card; the planted faults
    in the CPU's serve (the wrapped cast in bf16, where 127.5 rows occur;
    one flipped value in both) move its prefill logits past the limit."""
    tag = "phase 15 (b)"
    out = {}
    for arch in INT8_SMALL_ARCHS:
        for dtype, tol, rtol in (("float32", 1e-3, 1e-3),
                                 ("bfloat16", SERVE_BF16_TOL, 0.0)):
            cfg = small_serve_config(get_config, dtype, arch=arch,
                                     over={"kv_dtype": "int8"})
            cpu_model = build_model(cfg, device="cpu", seed=seed)
            card_model = copy.deepcopy(cpu_model).to(dev)
            kw = small_serve_kwargs(seed)
            cpu = serve_mod.serve(cfg, device="cpu", model=cpu_model, **kw)
            before = fa_kernel.flash_attention_cuda.launches
            card = serve_mod.serve(cfg, device=dev, model=card_model, **kw)
            flash = fa_kernel.flash_attention_cuda.launches - before
            check(flash == 0, f"{arch} int8 small serve: {flash} flash "
                  f"launches")
            check(np.array_equal(card.admitted, cpu.admitted),
                  "card and CPU admitted different requests")
            check(card.logits_finite and cpu.logits_finite,
                  "non-finite logits")
            worst, steps = serve_logits_agree(card, cpu, tol, rtol, tag)
            faults = {}
            for fault in INT8_FAULTS:
                if fault == "wrapped_cast" and dtype == "float32":
                    continue            # no row lands on 127.5 in f32
                with int8_planted(attn_mod, fault):
                    bad = serve_mod.serve(cfg, device="cpu", model=cpu_model,
                                          **kw)
                faults[fault] = float((bad.logits[0] - card.logits[0])
                                      .abs().max())
                check(faults[fault] > tol, f"{arch} {dtype} int8 small "
                      f"serve: the planted {fault} moves the prefill "
                      f"logits by only {faults[fault]:.3e}")
            out[f"{arch} {dtype}"] = dict(err=worst, steps=steps, tol=tol,
                                          flash=flash, faults=faults)
            log(f"{tag}: small serve ({cfg.name} smoke, {dtype}, int8 "
                f"cache) on the card == on the CPU: {len(card.admitted)} "
                f"admitted, logits within atol {tol} rtol {rtol} over "
                f"{steps} steps (max abs diff {worst:.3e}), {flash} flash "
                f"launches; planted faults in the CPU's serve move the "
                f"prefill logits by " + json.dumps(
                    {f: f"{e:.3e}" for f, e in faults.items()}))
    return out


def int8_beside_bf16(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                     pm_kernel, seed: int, dev) -> dict:
    """Phase 15 (c): serve_llama3_8b's cell (llama3-8b at its published
    size, 128 proposed, the same seed and so the same weights) with a
    bf16 cache and with an int8 one: cache bytes, prefill s, decode ms a
    step, the correlation of the prefill logits and the share of greedy
    tokens that agree (reported, not gated); no flash launch with the
    int8 cache.  The prefill's logits are kept by a copy on the card
    (``[B, vocab]``, no sync) inside these two serves' prefill only."""
    runs = {}
    for kv in ("bfloat16", "int8"):
        cfg = dataclasses.replace(get_config("llama3-8b"), kv_dtype=kv)
        first = []

        def keeping_model(*a, **kw):
            model = build_model(*a, **kw)
            prefill = model.prefill

            def kept_prefill(*pa, **pkw):
                logits, cache = prefill(*pa, **pkw)
                first.append(logits.clone())
                return logits, cache

            model.prefill = kept_prefill
            return model

        lm = lm_slice(serve_mod, keeping_model, get_config, pm_ref,
                      fa_kernel, pm_kernel, seed, dev,
                      tag=f"phase 15 (c) {kv}", cfg=cfg)
        runs[kv] = {k: lm[k] for k in ("B", "timings", "kv_bytes",
                                       "peak_bytes", "fa_launches",
                                       "fa_routes", "pm_launches",
                                       "generated")}
        runs[kv]["prefill_logits"] = first[0].float().cpu()
        del lm["model"].prefill          # the wrapper's cycle to the model
        del lm, first
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    a, b = runs["bfloat16"], runs["int8"]
    corr = float(np.corrcoef(a["prefill_logits"].numpy().ravel(),
                             b["prefill_logits"].numpy().ravel())[0, 1])
    agree = float((a["generated"] == b["generated"]).mean())
    first = (a["generated"] != b["generated"]).any(0)
    out = dict(corr=corr, token_agreement=agree,
               first_diverging_step=int(first.argmax()) if first.any()
               else None)
    for kv, r in runs.items():
        out[kv] = {k: r[k] for k in ("B", "timings", "kv_bytes",
                                     "peak_bytes", "fa_launches",
                                     "pm_launches")}
    log(f"phase 15 (c): llama3-8b, {a['B']} requests, bf16 cache against "
        f"int8: cache {a['kv_bytes'] / 1e9:.3f} / {b['kv_bytes'] / 1e9:.3f}"
        f" GB; prefill {a['timings']['prefill_s']:.3f} / "
        f"{b['timings']['prefill_s']:.3f} s; decode "
        f"{a['timings']['decode_ms_per_step']:.3f} / "
        f"{b['timings']['decode_ms_per_step']:.3f} ms a step; prefill "
        f"logits correlation {corr:.6f}; greedy tokens agreeing "
        f"{agree:.4f} (first step where a request's tokens part: "
        f"{out['first_diverging_step']}); flash launches "
        f"{a['fa_launches']} / {b['fa_launches']}")
    return out


def int8_reckoning(cfg, B: int, weight_bytes: int) -> dict:
    """The qwen cell's memory by reckoning: the weights; while they are
    built, the largest float32 draw (the ``[padded vocab, d_model]``
    embedding or head) beside them; at the serve, the int8 cache, the
    prefill's MLP intermediates (gate, up and their product in bf16) and
    the query-blocked score tiles (scores, probabilities and the
    exponential's temporary in f32)."""
    from repro_torch.models.attention import QUANT_Q_BLOCK
    L = LM_PROMPT + LM_STEPS
    r = dict(weights=weight_bytes, init_draw=cfg.padded_vocab * cfg.d_model
             * 4, cache=B * L * kv_position_bytes(cfg),
             mlp=3 * B * LM_PROMPT * cfg.d_ff * 2,
             tiles=3 * B * cfg.n_heads * min(QUANT_Q_BLOCK, LM_PROMPT) * L
             * 4)
    r["serve_peak"] = weight_bytes + r["cache"] + r["mlp"] + r["tiles"]
    return r


def int8_serve_cell(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                    pm_kernel, attn_mod, steps_mod, seed: int, dev) -> dict:
    """Phase 15 (d): ``serve_qwen15_32b_int8``, qwen1.5-32b at its
    published width and depth with the cache the reference's own rule
    picks (``cell_model_config(cfg, SHAPES["decode_32k"])``: int8), on
    ``INT8_REQUESTS`` proposed requests: admission equal to the plain
    version's with one ``smem`` launch, no flash launch, finite logits;
    the memory reckoned beside the measured peaks; a profiled prefill and
    decode window split into the int8 attention (``_sdpa_chunked_quant``
    under a range), the matrix products and the rest."""
    from repro_torch.configs.base import SHAPES
    tag = "phase 15 (d)"
    cfg = steps_mod.cell_model_config(get_config(INT8_ARCH),
                                      SHAPES["decode_32k"])
    check(cfg.kv_dtype == "int8", f"{cfg.name}'s decode cell picks "
          f"{cfg.kv_dtype}")
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info()
        log(f"{tag}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
            f", {free / 1e9:.2f} of {total / 1e9:.2f} GB free before the "
            f"build")
    lm = lm_slice(serve_mod, build_model, get_config, pm_ref, fa_kernel,
                  pm_kernel, seed, dev, tag=tag, cfg=cfg,
                  requests=INT8_REQUESTS, min_admitted=1)
    res = {k: lm[k] for k in ("B", "fa_launches", "fa_routes", "pm_launches",
                              "pm_routes", "timings", "peak_bytes",
                              "build_peak_bytes", "kv_bytes",
                              "weight_bytes")}
    want = int(plain_grants(serve_mod, pm_ref, seed, "cpu",
                            INT8_REQUESTS).sum())
    check(res["B"] == want, f"{res['B']} admitted, the plain version {want}")
    check(res["fa_launches"] == 0, f"{res['fa_launches']} flash launches "
          f"with an int8 cache")
    r = res["reckoning"] = int8_reckoning(cfg, res["B"], res["weight_bytes"])
    check(r["cache"] == res["kv_bytes"], "the cache's bytes")
    gb = {k: round(v / 1e9, 3) for k, v in r.items()}
    log(f"{tag}: memory by reckoning (GB) {json.dumps(gb)}; measured peak "
        f"of the build {res['build_peak_bytes'] / 1e9:.3f} GB (reckoned "
        f"{(r['weights'] + r['init_draw']) / 1e9:.3f} at most), of the "
        f"serve {res['peak_bytes'] / 1e9:.3f} GB (reckoned "
        f"{r['serve_peak'] / 1e9:.3f}); tokens/s "
        f"{res['timings']['tokens_per_s']:.1f}")
    res["split"] = serve_split(lm, [(attn_mod, "_sdpa_chunked_quant",
                                     "p11.int8_attn")], dev, seed, tag=tag)
    del lm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def int8_phase(serve_mod, build_model, pm_ref, pm_kernel, fa_kernel, dev,
               seed: int) -> dict:
    """Phase 15: the int8 KV cache on the card: (a) ``_quant`` and
    ``_sdpa_chunked_quant`` card against CPU, with planted faults; (b)
    the llama3-8b and qwen1.5-32b smoke configs served with an int8 cache
    card against CPU; (c) llama3-8b's serve cell with a bf16 and an int8
    cache; (d) ``serve_qwen15_32b_int8``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn_mod
    t0 = time.perf_counter()
    if dev.type == "cuda":
        log(f"phase 15: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"allocated on the card at the start")
    marks = [("start", time.perf_counter())]

    def mark(part):
        marks.append((part, time.perf_counter()))
        log(f"phase 15 {part} took {marks[-1][1] - marks[-2][1]:.1f} s")

    out = dict(quant=int8_quant_vs_cpu(attn_mod, dev, seed),
               attention=int8_attention_vs_cpu(attn_mod, dev, seed))
    mark("(a)")
    out["small"] = int8_small_vs_cpu(serve_mod, build_model, get_config,
                                     attn_mod, fa_kernel, seed, dev)
    mark("(b)")
    out["llama3"] = int8_beside_bf16(serve_mod, build_model, get_config,
                                     pm_ref, fa_kernel, pm_kernel, seed, dev)
    mark("(c)")
    out["serve_qwen"] = int8_serve_cell(serve_mod, build_model, get_config,
                                        pm_ref, fa_kernel, pm_kernel,
                                        attn_mod, steps_mod, seed, dev)
    mark("(d)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 15 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: sharding rules, cell programs and the dry run
# ---------------------------------------------------------------------------

CELL_ARCH = "llama3-8b"
# prefill_32k's batch 32 -> 1 and decode_32k's 128 -> 8: 32 requests'
# prefill cache is 137 GB and 128 requests' decode cache 550 GB, against
# the card's 80 GB
CELL_BATCH = {"prefill_32k": 1, "decode_32k": 8}
CELL_ROWS = 256          # the prefill check's query rows: the last 256
CELL_DECODE_STEPS = 5    # timed decode steps (host clock, synchronized)


def dryrun_every_cell(dev) -> dict:
    """Phase 16 (a): ``dryrun.run_cell`` (no file written) for every arch
    x ``shapes_for(cfg)`` cell at both production meshes and the host
    mesh: every spec divides (``run_cell`` raises otherwise); one line a
    cell with its per-device argument GB and whether they fit the card;
    jamba-v0.1 at 32 layers does not fit one card."""
    from repro_torch.configs import ALIASES, get_config, shapes_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.report import device_memory
    t0 = time.perf_counter()
    memory, _ = device_memory()
    fits = {}
    for arch in ALIASES:
        for shape in shapes_for(get_config(arch)):
            for mesh in ("single", "multi", "host"):
                rep = dryrun.run_cell(arch, shape.name, mesh, write=False,
                                      device=dev)
                b = rep["argument_bytes_per_device"]
                fit = fits[arch, shape.name, mesh] = b["total"] <= memory
                log(f"phase 16 (a): {arch} {shape.name} {rep['mesh']}: "
                    f"{b['total'] / 1e9:.3f} GB of arguments a device "
                    f"(params {b['params'] / 1e9:.3f}, opt state "
                    f"{b['opt_state'] / 1e9:.3f}, cache "
                    f"{b['cache'] / 1e9:.3f}); "
                    f"{'fits' if fit else 'does not fit'} on the card's "
                    f"{memory / 1e9:.2f} GB")
    check(not fits["jamba-v0.1-52b", "prefill_32k", "host"],
          "jamba-v0.1 at 32 layers fits one card by the dry run")
    out = dict(cells=len(fits), fit=sum(fits.values()),
               seconds=time.perf_counter() - t0)
    log(f"phase 16 (a): {out['cells']} cells, every spec dividing, "
        f"{out['fit']} fit one card, in {out['seconds']:.1f} s")
    return out


def causal_pairs(Sq: int, Sk: int) -> int:
    """(q row, key) pairs a causal mask leaves visible, one head: the
    rows at the last ``Sq`` of ``Sk`` positions."""
    return sum(Sk - Sq + i + 1 for i in range(Sq))


def _sdpa_32k(q, k, v, B: int, causal: bool):
    """SDPA at a flash call's shape: ``is_causal`` (``Sq == Sk``) or no
    mask (a decode row that sees every key), GQA, the math backend
    excluded (at 32k it would hold the [H, S, S] f32 scores). Where no
    other backend takes ``enable_gqa``, K/V are expanded to every head
    first, outside the timed call.  Returns ``(fn, how)``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backends = [getattr(SDPBackend, n) for n in (
        "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
        if hasattr(SDPBackend, n)]
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    q4 = q.view(B, H // B, Sq, hd)
    k4, v4 = k.view(B, HK // B, Sk, hd), v.view(B, HK // B, Sk, hd)

    def call(kk, vv, gqa):
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(q4, kk, vv,
                                                  is_causal=causal,
                                                  enable_gqa=gqa)
    try:
        call(k4, v4, True)
        return (lambda: call(k4, v4, True)), "enable_gqa"
    except RuntimeError:
        G = H // HK
        ke, ve = k4.repeat_interleave(G, 1), v4.repeat_interleave(G, 1)
        call(ke, ve, False)
        return (lambda: call(ke, ve, False)), "K/V expanded to every head"


def flash_32k(fa_ref, fa_kernel, cfg, B: int, Sq: int, Sk: int, dev,
              seed: int, tag: str, hot: float = 1.0) -> dict:
    """The flash call of a 32k cell (one layer, seeded bf16 q/k/v): q
    ``[B * n_heads, Sq, hd]`` at the last ``Sq`` of ``Sk`` positions, k/v
    ``[B * n_kv_heads, Sk, hd]``, causal.  The kernel's rows against the
    plain version within 2e-2 and ``FA_ROW_TOL`` a row: all of them at a
    decode row, the last ``CELL_ROWS`` at their own positions against
    every key at prefill (the plain version cannot hold all
    ``[H, Sq, Sk]`` f32 scores); the planted faults of phase 6 on one
    request's heads of those rows above the row limit.  Times: at
    prefill stream time (CUDA events) of the kernel, SDPA and the plain
    version on the checked rows; at decode device time in replayed CUDA
    graphs, kernel and SDPA in turns, and the plain version by events;
    the bound: the bf16 FLOPs of the visible pairs at 989 TFLOP/s or
    q, k, v and the output once at 3.35 TB/s, whichever is larger.
    ``hot`` scales the K rows of the tiles the planted faults touch
    (:func:`fault_tiles`), so that they carry a share of each row's
    weight where the keys are so many that one tile's share of them
    would leave a fault under the row limit."""
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    H, HK = B * cfg.n_heads, B * cfg.n_kv_heads
    gen = torch.Generator(device=dev).manual_seed(seed + 16)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    route, splits = fa_kernel.plan(torch.bfloat16, hd, G * Sq, Sk, HK,
                                   fa_kernel.n_sms(dev.index or 0))
    tile, stages = route_tile(route, hd)
    q, k, v = mk(H, Sq, hd), mk(HK, Sk, hd), mk(HK, Sk, hd)
    if hot != 1.0:
        for keys in fault_tiles(Sk, Sk - 1, tile, stages):
            k[:, keys] *= hot
    qp = torch.arange(Sk - Sq, Sk, device=dev, dtype=torch.float32)
    kp = torch.arange(Sk, device=dev, dtype=torch.float32)
    kw = dict(g=G, scale=1.0 / np.sqrt(hd), causal=True, window=0,
              attn_cap=0.0)
    o = torch.empty_like(q)
    ws = (torch.empty(fa_kernel.workspace_floats(HK, splits, G * Sq, hd),
                      dtype=torch.float32, device=dev)
          if route == "decode" and fa_kernel.needs_workspace(
              q.dtype, hd, splits) else None)

    def run_kernel():
        fa_kernel.launch(q, k, v, qp, kp, o, **kw, workspace=ws)

    run_kernel()
    rows = slice(Sq - min(CELL_ROWS, Sq), Sq)
    qs, qps = q[:, rows], qp[rows]

    def run_plain():
        return fa_ref.flash_attention_flat(qs, k, v, qps, kp, **kw)

    want = run_plain()
    torch.cuda.synchronize()
    got = o[:, rows]
    ok, err = fa_close(got, want, torch.bfloat16)
    row = fa_row_err(got, want)
    check(ok, f"{tag}: flash kernel != plain at q [{H}, {Sq}, {hd}] x "
          f"k/v [{HK}, {Sk}, {hd}]: max abs err {err}, row err {row}")
    nq, nk = cfg.n_heads, cfg.n_kv_heads
    faults = fa_fault_errs(fa_ref, (qs[:nq], k[:nk], v[:nk], qps, kp), kw,
                           want[:nq], tile, stages)
    check(min(faults.values()) > FA_ROW_TOL,
          f"{tag}: a planted fault reads {json.dumps(faults)}, within the "
          f"row limit {FA_ROW_TOL}")
    del want
    lib, how = _sdpa_32k(q, k, v, B, causal=Sq > 1)
    lib_err = float((lib().reshape(q.shape)[:, rows].float()
                     - got.float()).abs().max())
    plain = _event_ms(run_plain, 2)
    res = dict(route=route, splits=splits, rows=rows.stop - rows.start,
               err=err, row_err=row, faults=faults, library_how=how,
               plain_rows_ms=plain)
    if Sq > 1:
        res.update(ms=_event_ms(run_kernel, 3), library_ms=_event_ms(lib, 3),
                   timed_by="CUDA events, 3 calls after 10")
    else:
        rounds = _interleaved_ms({"kernel": run_kernel, "sdpa": lib}, 50, 9)
        res.update(ms=float(np.median(rounds["kernel"])),
                   library_ms=float(np.median(rounds["sdpa"])),
                   rounds_ms=rounds["kernel"],
                   library_rounds_ms=rounds["sdpa"],
                   timed_by="CUDA graphs of 50 calls, 9 rounds in turns")
    pairs = causal_pairs(Sq, Sk) * H
    flops = 4 * hd * pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    bound_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    res.update(bound_ms=max(bound_ops, bound_bytes), flops=flops,
               bytes=n_bytes, visible_pairs=pairs,
               bound_by="operations" if bound_ops >= bound_bytes
               else "bytes")
    log(f"{tag}: flash q [{H}, {Sq}, {hd}] x k/v [{HK}, {Sk}, {hd}] bf16 "
        f"causal: route {route}, splits {splits}; kernel "
        f"{res['ms'] * 1e3:.3f} us, SDPA ({how}) "
        f"{res['library_ms'] * 1e3:.3f} us, plain at the last "
        f"{res['rows']} positions {plain * 1e3:.3f} us ({res['timed_by']});"
        f" bound {res['bound_ms'] * 1e3:.3f} us by {res['bound_by']} "
        f"({flops} flops over {pairs} visible pairs, {n_bytes} bytes); "
        f"kernel vs plain at the last {res['rows']} positions: max abs err "
        f"{err:.3e}, row err {row:.3e} (limit {FA_ROW_TOL}; planted "
        f"faults, {tile}-key "
        f"tile, ring of {stages}: "
        f"{json.dumps({n: round(e, 6) for n, e in faults.items()})}); vs "
        f"SDPA {lib_err:.3e}; clocks, power, temperature {_clocks()}")
    del q, k, v, o, ws
    torch.cuda.empty_cache()
    return res


def _held_vs_dryrun(cell, state, tag: str) -> dict:
    """The bytes the materialized cell holds on the card, group by group,
    equal to the dry run's per-device argument bytes."""
    held, want = state.held_bytes(), cell.argument_bytes()
    check(held == want, f"{tag}: the card holds {held}, the dry run says "
          f"{want}")
    return held


def _cell_launches(fa_kernel) -> tuple:
    fa = fa_kernel.flash_attention_cuda
    return fa.launches, {r: n for r, n in fa.route_launches.items() if n}


def prefill_32k_cell(steps_mod, mesh_mod, fa_kernel, cfg, dev, seed: int,
                     batch: int = CELL_BATCH["prefill_32k"]) -> tuple:
    """Phase 16 (b): ``prefill_32k`` reduced to ``batch`` requests through
    ``build_cell(cfg, shape, one_card_mesh())``: the materialized
    weights and cache equal to the dry run's argument bytes, one prefill
    (one ``tc`` launch a layer, the cache's index at the prompt's end,
    finite logits), its time and the peak memory.  Returns (the model,
    the record)."""
    from repro_torch.configs.base import SHAPES
    tag = "phase 16 (b)"
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=batch)
    cell = steps_mod.build_cell(cfg, shape, one_card_mesh())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = cell.materialize(dev, seed)
    _sync(dev)
    build_s = time.perf_counter() - t0
    held = _held_vs_dryrun(cell, state, tag)
    fa_kernel.reset_counts()
    t0 = time.perf_counter()
    logits, cache = cell.run(state)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    launches, routes = _cell_launches(fa_kernel)
    n_attn = layer_counts(cfg)["attn"]
    check(launches == n_attn and routes == {"tc": n_attn},
          f"{tag}: {launches} flash launches {routes}, want {n_attn} tc")
    check(cache["index"] == shape.seq_len, f"{tag}: index {cache['index']}")
    check(tuple(logits.shape) == (batch, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), f"{tag}: logits")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    res = dict(batch=batch, seq_len=shape.seq_len, held=held,
               launches=launches, routes=routes, build_s=build_s,
               prefill_s=prefill_s, peak_bytes=peak,
               tokens_per_s=batch * shape.seq_len / prefill_s)
    log(f"{tag}: prefill_32k_{cfg.name.replace('-', '_').replace('.', '')}"
        f"_B{batch}: {sum(p.numel() for p in state.model.parameters())} "
        f"parameters; the card holds {held['params'] / 1e9:.3f} GB of "
        f"weights + {held['cache'] / 1e9:.3f} GB of cache + "
        f"{held['batch']} B of tokens = {held['total']} B, equal to the "
        f"dry run's per-device argument bytes; build {build_s:.3f} s; one "
        f"prefill of {shape.seq_len} tokens {prefill_s:.3f} s "
        f"({res['tokens_per_s']:.1f} tokens/s); flash launches {routes}; "
        f"max_memory_allocated {peak / 1e9:.3f} GB")
    model = state.model
    del state, cache, logits
    return model, res


def decode_32k_cell(steps_mod, mesh_mod, fa_kernel, cfg, model, dev,
                    seed: int, batch: int = CELL_BATCH["decode_32k"],
                    steps: int = CELL_DECODE_STEPS,
                    keep: Optional[dict] = None) -> dict:
    """Phase 16 (c): ``decode_32k`` reduced to ``batch`` requests through
    ``build_cell`` on ``model``'s weights: the cache filled with seeded
    random bf16 K/V and its index at ``seq_len - 1`` (the step writes the
    last position and attends over all of them; a fresh cache would
    read one key), its bytes and the weights' equal to the dry run's; one
    step (one ``decode`` launch a layer, the split count the plan gives)
    whose logits equal ``Model.decode_step``'s on the same weights and
    cache bit for bit; the step's time over ``steps`` repeats against
    its bound, the weights and the cache read once at 3.35 TB/s.  With
    ``keep`` the cell, its filled state and the step's logits are put
    there (phase 17 runs the same step through a process group)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.parallel.sharding import leaves
    tag = "phase 16 (c)"
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=batch)
    L = shape.seq_len
    cell = steps_mod.build_cell(cfg, shape, one_card_mesh())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = cell.materialize(dev, seed, model=model)
    cache = state.args["cache"]
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    t0 = time.perf_counter()
    for _, t in leaves(cache):
        t.normal_(generator=gen)
    _sync(dev)
    fill_s = time.perf_counter() - t0
    held = _held_vs_dryrun(cell, state, tag)
    cache["index"] = L - 1
    fa_kernel.reset_counts()
    logits, _ = cell.run(state)
    _sync(dev)
    launches, routes = _cell_launches(fa_kernel)
    n_attn = layer_counts(cfg)["attn"]
    check(launches == n_attn and routes == {"decode": n_attn},
          f"{tag}: {launches} flash launches {routes}, want {n_attn} "
          f"decode")
    check(cache["index"] == L, f"{tag}: index {cache['index']}")
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    splits = (fa_kernel.plan(torch.bfloat16, hd, G, L,
                             batch * cfg.n_kv_heads,
                             fa_kernel.n_sms(dev.index or 0))[1]
              if dev.type == "cuda" else None)
    cache["index"] = L - 1
    with torch.inference_mode():
        again, _ = state.model.decode_step(state.args["token"], cache)
    check(torch.equal(logits, again), f"{tag}: the cell's decode step "
          f"!= Model.decode_step, max diff "
          f"{float((logits - again).abs().max())}")
    check(bool(torch.isfinite(logits).all()), f"{tag}: logits")
    times = []
    for _ in range(steps):
        cache["index"] = L - 1
        t0 = time.perf_counter()
        cell.run(state)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    bound = (held["params"] + held["cache"]) / H100_BYTES_PER_S * 1e3
    res = dict(batch=batch, seq_len=L, held=held, launches=launches,
               routes=routes, splits=splits, fill_s=fill_s,
               step_ms=float(np.median(times)), step_ms_all=times,
               bound_ms=bound, peak_bytes=peak)
    log(f"{tag}: decode_32k_{cfg.name.replace('-', '_').replace('.', '')}"
        f"_B{batch}: the card holds {held['params'] / 1e9:.3f} GB of "
        f"weights + {held['cache'] / 1e9:.3f} GB of cache (seeded random "
        f"bf16, filled in {fill_s:.3f} s) + {held['batch']} B of tokens = "
        f"{held['total']} B, equal to the dry run's per-device argument "
        f"bytes; flash launches {routes}, {splits} splits; logits equal "
        f"Model.decode_step's bit for bit; a step {res['step_ms']:.3f} ms "
        f"(median of {steps}: {[round(t, 3) for t in times]}) against its "
        f"bound {bound:.3f} ms (the weights and the cache once at "
        f"{H100_BYTES_PER_S:.3g} B/s); max_memory_allocated "
        f"{peak / 1e9:.3f} GB")
    if keep is not None:
        keep.update(cell=cell, state=state, logits=logits)
    del state, cache, logits, again
    return res


CELL_SMALL = {"prefill": (64, 2), "decode": (96, 2)}   # (seq_len, batch)


def one_card_mesh():
    """The mesh of one card (phase 16's cells run there on a host of any
    number of cards)."""
    from repro_torch.parallel.sharding import Mesh
    return Mesh((1, 1), ("data", "model"))


def cell_small_vs_cpu(get_config, fa_kernel, dev, seed: int, mode: str,
                      dtype: str = "float32") -> dict:
    """``build_cell``'s prefill or decode step at llama3-8b's smoke config
    (:func:`small_serve_config`; bf16 at head_dim 128, where the ``tc``
    and ``decode`` routes run) on the card against the CPU, the same
    weights and inputs on both (a decode step from a cache of seeded
    K/V at its last position): logits within 1e-3 in f32 and within
    ``SERVE_BF16_TOL`` (absolute) in bf16, as the small serves.  Returns
    the largest difference and the card's flash launches by route."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.parallel.sharding import leaves
    head_dim = SERVE_BF16_HEAD_DIM if dtype == "bfloat16" else 0
    cfg = small_serve_config(get_config, dtype, head_dim)
    S, B = CELL_SMALL[mode]
    shape = ShapeConfig(f"{mode}_small", S, B, mode)
    cell = steps_mod.build_cell(cfg, shape, one_card_mesh())
    cpu = cell.materialize("cpu", seed)
    card = cell.materialize(dev, seed, model=copy.deepcopy(cpu.model).to(dev))
    if mode == "decode":
        gen = torch.Generator().manual_seed(seed + 17)
        cards = dict(leaves(card.args["cache"]))
        for path, t in leaves(cpu.args["cache"]):
            t.normal_(generator=gen)
            cards[path].copy_(t)
        cpu.args["cache"]["index"] = card.args["cache"]["index"] = S - 1
    lc, _ = cell.run(cpu)
    fa_kernel.reset_counts()
    lk, _ = cell.run(card)
    _, routes = _cell_launches(fa_kernel)
    tol = 1e-3 if dtype == "float32" else SERVE_BF16_TOL
    rtol = tol if dtype == "float32" else 0.0
    lk, lc = lk.float().cpu().numpy(), lc.float().numpy()
    err = float(np.abs(lk - lc).max())
    check(np.allclose(lk, lc, rtol=rtol, atol=tol), f"build_cell {mode} "
          f"{dtype}: card logits differ from the CPU's by {err:.3e}")
    log(f"build_cell {mode} ({cfg.name} smoke, {dtype}, head_dim "
        f"{cfg.resolved_head_dim}, {B} x {S}) on the card == on the CPU: "
        f"logits within atol {tol} rtol {rtol} (max abs diff {err:.3e}), "
        f"flash calls by route {json.dumps(routes)}")
    return dict(err=err, tol=tol, routes=routes)


def cells_phase(fa_ref, fa_kernel, dev, seed: int,
                keep: Optional[dict] = None) -> dict:
    """Phase 16: (a) the dry run of every cell; (b) ``prefill_32k`` and
    (c) ``decode_32k`` of llama3-8b at its published size through
    ``build_cell`` on the card, the weights drawn once; then the flash
    call of each cell held to its plain version and timed.  ``keep``
    receives (c)'s cell, state and logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    t0 = time.perf_counter()
    if dev.type == "cuda":
        log(f"phase 16: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"allocated on the card at the start")
    cfg = get_config(CELL_ARCH)
    out = {"dryrun": dryrun_every_cell(dev)}
    model, out["prefill"] = prefill_32k_cell(steps_mod, mesh_mod, fa_kernel,
                                             cfg, dev, seed)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["decode"] = decode_32k_cell(steps_mod, mesh_mod, fa_kernel, cfg,
                                    model, dev, seed, keep=keep)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from repro_torch.configs.base import SHAPES
    L = SHAPES["prefill_32k"].seq_len
    out["flash"] = {
        "prefill_32k": flash_32k(fa_ref, fa_kernel, cfg,
                                 CELL_BATCH["prefill_32k"], L, L, dev,
                                 seed, "phase 16 (b)"),
        "decode_32k": flash_32k(fa_ref, fa_kernel, cfg,
                                CELL_BATCH["decode_32k"], 1, L, dev, seed,
                                "phase 16 (c)")}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 16 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: one cell across the cards of a mesh
# ---------------------------------------------------------------------------

# name -> (shape, mesh ("data", "model"), requests): llama3-8b at its
# published size; 32 requests' 32k cache is 137.4 GB, 34.36 GB a card
MESH_CELLS = {
    "prefill_32k_llama3_8b_B32_4x1": ("prefill_32k", (4, 1), 32),
    "decode_32k_llama3_8b_B32_1x4": ("decode_32k", (1, 4), 32)}
# the same meshes at llama3-8b's smoke config in bf16 at head_dim 128
# (the tc and decode routes) with 4 kv heads (2 would shard the cache's
# sequence over a model axis of 4): 8 x 256 tokens, 8 requests over 512
MESH_SMALL = {"prefill_32k": (256, 8), "decode_32k": (512, 8)}
MESH_RANKS = 4
MESH_CHECKED = 4          # decode requests held against one card
MESH_STEPS = 5            # timed decode steps
# the ranks' join deadline: phase 17 (b) took 85.8 s at full size on four
# H100s, so a hung rank fails the phase inside the smoke's own limit
MESH_TIMEOUT_S = 240.0
# rank 0's logits against one card's: the prefill's FSDP gathers every
# weight whole and sums no product in another order, so bit for bit (0).
# The decode's all-reduce over "model" adds the cards' bf16 partial
# products of wo (each rounded) where one card's product rounds once; its
# gate is rank 0's distance from the same step run in f32 on one card
# (the exact result) against one card's own: within MESH_F32_FACTOR times
# it (full size on four H100s: 0.257 against 0.225; the planted faults
# read above 6).  Beside it, rank 0 against one card within
# MESH_ONE_CARD_FACTOR times that distance (0.273 read against 0.449).
MESH_F32_FACTOR = 1.5
MESH_ONE_CARD_FACTOR = 2.0
MESH_FAULTS = ("head_slice", "no_wo_all_reduce")
# jamba's: an expert slice, Mamba's out_proj unreduced, in_proj cut plainly
JAMBA_MESH_FAULTS = ("expert_slice", "no_out_proj_all_reduce",
                     "in_proj_contiguous")


def _gathered_model(cell, model, group, dev):
    """A one-card ``Model`` of ``cell``'s config holding the whole of every
    parameter, all-gathered from the ranks' shards in ``model`` (every
    rank gets it)."""
    from repro_torch.launch.steps import model_holding
    return model_holding(cell.cfg, _gathered_params(cell, model, group, dev))


def _gathered_params(cell, model, group, dev) -> dict:
    """Every parameter of ``model`` gathered whole from the ranks' shards,
    by name."""
    from repro_torch.parallel.collectives import Collectives
    from repro_torch.parallel.group import gather_full
    from repro_torch.parallel.sharding import param_blocks
    coll = Collectives(group)
    return {name: gather_full(t.detach(), cell.specs["params"][name], coll,
                              blocks=param_blocks(name)).to(dev)
            for name, t in model.named_parameters()}


# the product whose all-reduce each skipping fault leaves out
SKIPPED_REDUCE = {"no_wo_all_reduce": "attn/wo",
                  "no_out_proj_all_reduce": "mamba/out_proj"}


def plant_mesh_fault(model, fault: str, rank: int):
    """Plant ``fault`` in this rank's sharded model and return its undo:
    ``head_slice``, rank 0's query heads rolled by one head in every
    attention layer (it attends with another head's query);
    ``expert_slice``, rank 0's local experts rolled by one in every MoE
    layer (each of its slots runs the next expert's weights);
    ``in_proj_contiguous``, every rank's Mamba ``in_proj`` replaced by a
    plain contiguous cut of the whole (the first ranks then hold only
    ``x`` columns, the last only ``z`` columns); ``no_wo_all_reduce`` and
    ``no_out_proj_all_reduce``, every rank skips the all-reduce after the
    attention's ``wo`` or after Mamba's ``out_proj``."""
    layers = [layer for unit in model.units for layer in unit.values()]

    def rolled(ws, by, dim):
        if rank != 0:
            return lambda: None
        for w in ws:
            w.data = torch.roll(w.data, by, dims=dim)
        return lambda: [setattr(w, "data", torch.roll(w.data, -by, dims=dim))
                        for w in ws]

    if fault == "head_slice":
        return rolled([layer.attn["wq"] for layer in layers
                       if "attn" in layer.groups],
                      model.cfg.resolved_head_dim, 1)
    if fault == "expert_slice":
        return rolled([layer.moe[k] for layer in layers
                       if "moe" in layer.groups
                       for k in ("wi_gate", "wi_up", "wo")], 1, 0)
    par = model.par
    if fault == "in_proj_contiguous":
        from repro_torch.parallel.collectives import Collectives
        from repro_torch.parallel.group import gather_full, local_shard
        coll, saved = Collectives(par.coll.group), []
        for name, w in model.named_parameters():
            if name.endswith("mamba.in_proj"):
                spec = par.pspecs[name]
                whole = gather_full(w.data, spec, coll, blocks=2)
                saved.append((w, w.data))
                w.data = local_shard(whole, spec, par.coll.group)
        return lambda: [setattr(w, "data", d) for w, d in saved]
    reduce, skipped = par.reduce, SKIPPED_REDUCE[fault]
    par.reduce = lambda t, name: t if name == skipped else reduce(t, name)
    return lambda: setattr(par, "reduce", reduce)


def _barrier(dev) -> None:
    import torch.distributed as dist
    _sync(dev)
    dist.barrier()


def _mesh_cell_config(small: bool):
    from repro_torch.configs import get_config
    if small:
        return small_serve_config(get_config, "bfloat16", SERVE_BF16_HEAD_DIM,
                                  over={"n_kv_heads": 4})
    return get_config(CELL_ARCH)


def _mesh_shape(shape_name: str, batch: int, small: bool):
    from repro_torch.configs.base import SHAPES
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
    if small:
        L, B = MESH_SMALL[shape_name]
        shape = dataclasses.replace(shape, seq_len=L, global_batch=B)
    return shape


def _run_rank_cell(fa_kernel, cell, state, dev):
    """One step of this rank's part, the collectives timed: (logits,
    seconds, collective seconds, launches, routes, records)."""
    coll = state.model.par.coll
    coll.reset()
    fa_kernel.reset_counts()
    _barrier(dev)
    t0 = time.perf_counter()
    logits, _ = cell.run(state)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches, routes = _cell_launches(fa_kernel)
    return (logits, secs, coll.seconds(), launches, routes,
            list(coll.records))


def _mesh_prefill(steps_mod, fa_ref, fa_kernel, cfg, shape, group, rank,
                  dev, seed, small) -> dict:
    """The prefill cell on this rank: held bytes, one timed prefill (the
    plan's route on every layer, the collectives against the trace), the
    head-slice fault, then rank 0's request 0 against one card's
    ``Model.prefill`` on the gathered weights."""
    from repro_torch.parallel.collectives import tally
    cell = steps_mod.build_cell(cfg, shape, group.mesh)
    traced, _ = cell.trace()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = cell.materialize(dev, seed, group=group)
    _sync(dev)
    build_s = time.perf_counter() - t0
    state.model.par.coll.timed = dev.type == "cuda"
    out = dict(held=state.held_bytes(), want=cell.argument_bytes(),
               build_s=build_s)
    logits, out["step_s"], out["collective_s"], out["launches"], \
        out["routes"], records = _run_rank_cell(fa_kernel, cell, state, dev)
    out["records_equal_trace"] = records == traced
    out["collectives"], out["traced"] = tally(records), tally(traced)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if dev.type == "cuda" else 0)
    B_local, S = state.args["tokens"].shape
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    out["plan"] = (fa_kernel.plan(torch.bfloat16, hd, G * S, S,
                                  B_local * cfg.n_kv_heads,
                                  fa_kernel.n_sms(dev.index or 0))
                   if dev.type == "cuda" else None)
    mine = logits[0].float().cpu()
    out["finite"] = bool(torch.isfinite(logits).all())
    undo = plant_mesh_fault(state.model, "head_slice", rank)
    state.args["cache"]["index"] = 0
    faulted = cell.run(state)[0][0].float().cpu()
    undo()
    model = state.model
    del state, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    full = _gathered_model(cell, model, group, dev)
    del model
    if rank == 0:
        tok = np.random.default_rng(seed).integers(
            0, cfg.vocab, (shape.global_batch, shape.seq_len),
            dtype=np.int32)[:1]
        with torch.inference_mode():
            want, _ = full.prefill(torch.from_numpy(tok).to(dev),
                                   full.init_cache(1, shape.seq_len))
        want = want[0].float().cpu()
        out["one_card_err"] = float((mine - want).abs().max())
        out["limit"] = 0.0
        out["faults"] = {"head_slice": float((faulted - want).abs().max())}
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not small:
        out["flash"] = flash_32k(fa_ref, fa_kernel, cfg, B_local, S, S, dev,
                                 seed, f"phase 17 (b) rank {rank} prefill")
    return out


def _mesh_decode(steps_mod, fa_ref, fa_kernel, cfg, shape, group, rank, dev,
                 seed, small) -> dict:
    """The decode cell on this rank: the cache filled with seeded random
    bf16 (this rank's shard from its own generator) at index L - 1, held
    bytes, one step (the plan's route and splits on every layer, the
    collectives against the trace) and ``MESH_STEPS`` timed; the planted
    faults; then rank 0's first ``MESH_CHECKED`` requests against one
    card's ``Model.decode_step`` on the gathered weights and cache."""
    from repro_torch.parallel.collectives import Collectives, tally
    from repro_torch.parallel.group import gather_full
    from repro_torch.parallel.sharding import P
    cell = steps_mod.build_cell(cfg, shape, group.mesh)
    traced, _ = cell.trace()
    L = shape.seq_len
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = cell.materialize(dev, seed, group=group)
    gen = torch.Generator(device=dev).manual_seed(seed + 17 + group.rank)
    cache = state.args["cache"]
    _fill_normal(cache, gen)
    _sync(dev)
    build_s = time.perf_counter() - t0
    state.model.par.coll.timed = dev.type == "cuda"
    out = dict(held=state.held_bytes(), want=cell.argument_bytes(),
               build_s=build_s)
    cache["index"] = L - 1
    logits, _, _, out["launches"], out["routes"], records = _run_rank_cell(
        fa_kernel, cell, state, dev)
    out["records_equal_trace"] = records == traced
    out["collectives"], out["traced"] = tally(records), tally(traced)
    B_local = state.args["token"].shape[0]
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    kv_local = cfg.n_kv_heads // state.model.par.tp
    out["plan"] = (fa_kernel.plan(torch.bfloat16, hd, G, L,
                                  B_local * kv_local,
                                  fa_kernel.n_sms(dev.index or 0))
                   if dev.type == "cuda" else None)
    times, coll_s = [], []
    for _ in range(MESH_STEPS):
        cache["index"] = L - 1
        _, secs, cs, *_ = _run_rank_cell(fa_kernel, cell, state, dev)
        times.append(secs * 1e3)
        coll_s.append(cs * 1e3)
    out.update(step_ms=float(np.median(times)), step_ms_all=times,
               collective_ms=float(np.median(coll_s)),
               collective_ms_all=coll_s,
               peak_bytes=(torch.cuda.max_memory_allocated()
                           if dev.type == "cuda" else 0),
               finite=bool(torch.isfinite(logits).all()))
    gather = Collectives(group)
    n = MESH_CHECKED
    lspec = P(None, cell.hints["logits"][2])

    def head_logits(lg):
        return gather_full(lg[:n], lspec, gather).float().cpu()

    mine = head_logits(logits)
    faulted = {}
    for fault in MESH_FAULTS:
        undo = plant_mesh_fault(state.model, fault, rank)
        cache["index"] = L - 1
        faulted[fault] = head_logits(cell.run(state)[0])
        undo()
    token = state.args["token"]
    # the first requests' cache, every kv head (the batch is not split on
    # this mesh: "data" is one card)
    layers = {name: {k: gather_full(t[:, :n].contiguous(),
                                    cell.specs["cache"][f"layers/{name}/{k}"],
                                    gather)
                     for k, t in layer.items()}
              for name, layer in cache["layers"].items()}
    model = state.model
    del state, cache, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    full = _gathered_model(cell, model, group, dev)
    del model
    if rank == 0:
        from repro_torch.launch.steps import model_holding
        cache1 = {"layers": layers, "index": L - 1}
        with torch.inference_mode():
            want, _ = full.decode_step(token[:n].to(dev), cache1)
            exact = model_holding(
                dataclasses.replace(cfg, dtype="float32"),
                {k: t.float() for k, t in full.named_parameters()})
            del full
            cache1["index"] = L - 1
            truth, _ = exact.decode_step(token[:n].to(dev), cache1)
            del exact
        want, truth = want.float().cpu(), truth.float().cpu()
        floor = float((want - truth).abs().max())
        out.update(one_card_err=float((mine - want).abs().max()),
                   f32_err=float((mine - truth).abs().max()),
                   one_card_f32_err=floor,
                   f32_limit=MESH_F32_FACTOR * floor,
                   limit=MESH_ONE_CARD_FACTOR * floor,
                   faults={f: float((g - want).abs().max())
                           for f, g in faulted.items()},
                   faults_f32={f: float((g - truth).abs().max())
                               for f, g in faulted.items()})
    else:
        del full
    del layers
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not small:
        # the rank's call, q [B * n_heads / tp, 1, hd] x k/v [B *
        # n_kv_heads / tp, L, hd], is flash_32k's at B * kv_local /
        # n_kv_heads requests of every head
        out["flash"] = flash_32k(fa_ref, fa_kernel, cfg,
                                 B_local * kv_local // cfg.n_kv_heads, 1, L,
                                 dev, seed,
                                 f"phase 17 (b) rank {rank} decode")
    return out


def _fill_normal(cache, gen) -> None:
    """Every cache leaf drawn from ``gen`` (in a scope of its own: no name
    outlives the loop holding a leaf of the cache alive)."""
    from repro_torch.parallel.sharding import leaves
    for _, t in leaves(cache):
        t.normal_(generator=gen)


def _rank_device(rank: int, device: str) -> torch.device:
    """Set a rank's process up: its card alone (``CUDA_VISIBLE_DEVICES``)
    with expandable segments (a prefill's transients beside the held
    bytes must not be stranded between freed blocks), the port on the
    path, full float32 products (no TF32)."""
    import os
    if device == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(rank)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device)


def mesh_rank(rank: int, tmp: str, seed: int, small: bool,
              device: str) -> None:
    """One rank of phase 17 (b), a process of its own: its card alone
    (``CUDA_VISIBLE_DEVICES``), the two cells of ``MESH_CELLS`` on their
    meshes through ``build_cell`` and ``materialize(group=...)``, its
    results written to ``tmp/rank<r>.json``."""
    dev = _rank_device(rank, device)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import steps as steps_mod
    from repro_torch.parallel.group import destroy_mesh_group, init_mesh_group
    from repro_torch.parallel.sharding import Mesh
    cfg = _mesh_cell_config(small)
    out = {"rank": rank}
    try:
        for name, (shape_name, sizes, batch) in MESH_CELLS.items():
            mesh = Mesh(sizes, ("data", "model"))
            group = init_mesh_group(mesh, rank, pathlib.Path(tmp) / "store",
                                    dev)
            if dev.type == "cuda":
                dev = group.device
            shape = _mesh_shape(shape_name, batch, small)
            run = _mesh_prefill if shape.mode == "prefill" else _mesh_decode
            out[name] = run(steps_mod, fa_ref, fa_kernel, cfg, shape, group,
                            rank, dev, seed, small)
            out[name]["mesh"] = mesh.shape
    finally:
        destroy_mesh_group()
    (pathlib.Path(tmp) / f"rank{rank}.json").write_text(
        json.dumps(out, default=str))


def _spawn_ranks(target, seed: int, small: bool, device: str,
                 timeout: float, tag: str) -> list:
    """``MESH_RANKS`` processes (the ``spawn`` context) running
    ``target(rank, tmp, seed, small, device)``, joined within ``timeout``
    s (the rest terminated and the phase failed); returns what each
    wrote to ``tmp/rank<r>.json``."""
    import multiprocessing as mp
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target,
                             args=(r, tmp, seed, small, device))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.terminate()
                p.join(30)
        check(not alive, f"{tag}: {len(alive)} ranks still ran after "
              f"{timeout} s")
        codes = [p.exitcode for p in procs]
        check(not any(codes), f"{tag}: ranks exited {codes}")
        return [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                for r in range(MESH_RANKS)]


def mesh_cells(seed: int, small: bool = False, device: str = "cuda",
               timeout: float = MESH_TIMEOUT_S) -> dict:
    """Phase 17 (b): ``MESH_RANKS`` processes (``mesh_rank``, the
    ``spawn`` context) run the cells of ``MESH_CELLS`` (at the smoke
    config with ``small``), joined within ``timeout`` s (the rest
    terminated and the phase failed).  Checks: every rank holds the dry
    run's bytes and issued the traced collectives; every flash launch on
    every rank took the route ``plan`` gives (``tc`` at prefill, ``decode``
    at decode; on the card); rank 0's logits against one card's (the
    prefill bit for bit; the decode's distance from the f32 step within
    ``MESH_F32_FACTOR`` times one card's, and its distance from one card
    within ``MESH_ONE_CARD_FACTOR`` times it), which every planted fault
    exceeds.  Returns the ranks' records by cell."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(mesh_rank, seed, small, device, timeout,
                         "phase 17 (b)")
    out = {"wall_s": time.perf_counter() - t0, "small": small}
    for name, (shape_name, sizes, _) in MESH_CELLS.items():
        tag = f"phase 17 (b) {name}{' (smoke config)' if small else ''}"
        recs = [r[name] for r in ranks]
        for r, rec in enumerate(recs):
            check(rec["held"] == rec["want"], f"{tag}: rank {r} holds "
                  f"{rec['held']}, the dry run says {rec['want']}")
            check(rec["records_equal_trace"], f"{tag}: rank {r} issued "
                  f"{rec['collectives']}, the trace {rec['traced']}")
            check(rec["finite"], f"{tag}: rank {r}'s logits")
            if device == "cuda":
                route = rec["plan"][0]
                want = "tc" if shape_name == "prefill_32k" else "decode"
                n = _mesh_cell_config(small).n_layers
                check(route == want and rec["routes"] == {route: n},
                      f"{tag}: rank {r} launched {rec['routes']}, the plan "
                      f"gives {rec['plan']}, want {n} {want}")
        head = recs[0]
        if "f32_err" in head:
            check(head["f32_err"] <= head["f32_limit"], f"{tag}: rank 0's "
                  f"logits read {head['f32_err']} from the f32 step, above "
                  f"{MESH_F32_FACTOR} x one card's {head['one_card_f32_err']}")
            check(min(head["faults_f32"].values()) > head["f32_limit"],
                  f"{tag}: a planted fault reads {head['faults_f32']} from "
                  f"the f32 step, within {head['f32_limit']}")
        check(head["one_card_err"] <= head["limit"], f"{tag}: rank 0's "
              f"logits differ from one card's by {head['one_card_err']}, "
              f"above {head['limit']}")
        check(min(head["faults"].values()) > head["limit"], f"{tag}: a "
              f"planted fault reads {head['faults']}, within "
              f"{head['limit']}")
        step = ("step_s" if shape_name == "prefill_32k" else "step_ms")
        log(f"{tag}: mesh {dict(zip(('data', 'model'), sizes))}; per rank "
            f"held (GB) {[round(x['held']['total'] / 1e9, 3) for x in recs]}"
            f" == the dry run's; peak (GB) "
            f"{[round(x['peak_bytes'] / 1e9, 3) for x in recs]}; "
            f"{step} {[x[step] for x in recs]}"
            + (f" (median of {MESH_STEPS}; all {recs[0]['step_ms_all']})"
               if step == "step_ms" else "")
            + f"; in collectives "
            f"{[x.get('collective_ms', x.get('collective_s')) for x in recs]}"
            f" {'ms' if step == 'step_ms' else 's'}; flash launches "
            f"{[x['routes'] for x in recs]}, plan {recs[0]['plan']}; "
            f"collectives issued {json.dumps(recs[0]['collectives'])} == "
            f"traced; "
            + (f"rank 0 vs the f32 step: max abs err {head['f32_err']:.4e} "
               f"(limit {head['f32_limit']:.4e}: {MESH_F32_FACTOR} x one "
               f"card's {head['one_card_f32_err']:.4e}), planted faults "
               f"{json.dumps(head['faults_f32'])}; "
               if "f32_err" in head else "")
            + f"rank 0 vs one card: max abs err "
            f"{head['one_card_err']:.4e} (limit {head['limit']:.4e}"
            + (f": {MESH_ONE_CARD_FACTOR} x one card's distance from the "
               f"f32 step" if "f32_err" in head else ", bit for bit")
            + f"), planted faults "
            f"{json.dumps(head['faults'])}")
        for r, rec in enumerate(recs):
            if "flash" in rec:
                f = rec["flash"]
                log(f"{tag}: rank {r} flash route {f['route']} (splits "
                    f"{f['splits']}): kernel {f['ms']:.3f} ms, SDPA "
                    f"{f['library_ms']:.3f} ms, bound {f['bound_ms']:.3f} ms "
                    f"by {f['bound_by']}, err {f['err']:.3e}")
        out[name] = recs
    log(f"phase 17 (b) took {out['wall_s']:.1f} s")
    return out


def one_rank_decode(fa_kernel, kept: dict, dev, seed: int) -> dict:
    """Phase 17 (a): phase 16 (c)'s cell through a one-rank process group
    (NCCL on the card): ``materialize(group=..., model=..., cache=...)``
    holding (c)'s weights and filled cache (no copy), its token put in,
    the bytes equal to the dry run's; one
    step whose logits equal (c)'s bit for bit, with (c)'s flash launches
    (32 on ``decode``) and no collective."""
    from repro_torch.parallel.group import destroy_mesh_group, init_mesh_group
    tag = "phase 17 (a)"
    cell, state = kept["cell"], kept["state"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        group = init_mesh_group(cell.mesh, 0, pathlib.Path(tmp) / "store",
                                dev)
        try:
            init_s = time.perf_counter() - t0
            mine = cell.materialize(dev, seed, model=state.model,
                                    group=group, cache=state.args["cache"])
            mine.args["token"] = state.args["token"]
            held = _held_vs_dryrun(cell, mine, tag)
            mine.args["cache"]["index"] = cell.shape.seq_len - 1
            fa_kernel.reset_counts()
            t1 = time.perf_counter()
            logits, _ = cell.run(mine)
            _sync(dev)
            step_ms = (time.perf_counter() - t1) * 1e3
            launches, routes = _cell_launches(fa_kernel)
            records = list(mine.model.par.coll.records)
        finally:
            destroy_mesh_group()
    n_attn = layer_counts(cell.cfg)["attn"]
    check(torch.equal(logits, kept["logits"]), f"{tag}: logits differ from "
          f"phase 16 (c)'s by {float((logits - kept['logits']).abs().max())}")
    check(launches == n_attn and routes == {"decode": n_attn},
          f"{tag}: {launches} flash launches {routes}, want {n_attn} decode")
    check(records == [], f"{tag}: a one-rank group issued {records}")
    res = dict(mesh=cell.mesh.shape, cards=torch.cuda.device_count()
               if dev.type == "cuda" else 0, launches=launches,
               routes=routes, held=held, init_s=init_s, step_ms=step_ms,
               wall_s=time.perf_counter() - t0)
    log(f"{tag}: decode_32k_llama3_8b_B{cell.shape.global_batch} through a "
        f"one-rank {'NCCL' if dev.type == 'cuda' else 'gloo'} group on mesh "
        f"{cell.mesh.shape} ({res['cards']} cards on the host): the card "
        f"holds {held['total']} B, the dry run's; logits equal phase 16 "
        f"(c)'s bit for bit; flash launches {routes}; no collective; group "
        f"up in {init_s:.3f} s, the step {step_ms:.3f} ms (first call), the "
        f"phase {res['wall_s']:.3f} s")
    return res


def mesh_phase(fa_kernel, kept: dict, dev, seed: int) -> dict:
    """Phase 17: (a) :func:`one_rank_decode`; (b) on a host of
    ``MESH_RANKS`` or more cards, :func:`mesh_cells` at full size."""
    t0 = time.perf_counter()
    out = {"one_rank": one_rank_decode(fa_kernel, kept, dev, seed)}
    kept.clear()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= MESH_RANKS:
        torch.cuda.empty_cache()
        out["mesh"] = mesh_cells(seed)
    else:
        log(f"phase 17 (b): {cards} card(s) on this host; the four-card "
            f"cells {list(MESH_CELLS)} need {MESH_RANKS} "
            f"(scripts/mesh_cell.py runs them)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 17 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: jamba-v0.1 at its published 32 layers across four cards
# ---------------------------------------------------------------------------

JAMBA_ARCH = "jamba-v0.1-52b"
# name -> (shape, mesh ("data", "model"), requests, bytes a card holds by
# argument_bytes): jamba's 103 GB of bf16 weights need two cards, a batch
# of its 32k contexts four; prefill_32k's 32 requests cut to 8 (at 32 the
# capacity path's [4, 163840, 14336] bf16 expert buffers take 18.8 GB
# each beside 30.2 GB held)
JAMBA_CELLS = {
    "decode_32k_jamba_v01_52b_B128_1x4": ("decode_32k", (1, 4), 128,
                                          43_524_850_176),
    "long_500k_jamba_v01_52b_B1_1x4": ("long_500k", (1, 4), 1,
                                       27_938_979_844),
    "prefill_32k_jamba_v01_52b_B8_1x4": ("prefill_32k", (1, 4), 8,
                                         26_896_793_600)}
# each cell's flash call on a card (its 8 of 32 heads and 2 of 8 kv heads
# of every request; 4 attention layers a step): cell -> (requests, query
# rows, keys, route, splits)
JAMBA_FLASH = {
    "decode_32k_jamba_v01_52b_B128_1x4": (128, 1, 32768, "decode", 1),
    "long_500k_jamba_v01_52b_B1_1x4": (1, 1, 524288, "decode", 66),
    "prefill_32k_jamba_v01_52b_B8_1x4": (8, 32768, 32768, "tc", 1)}
JAMBA_TP = 4
# long_500k's call: one 64-key tile is 1/8192 of its 524,288 keys, and a
# fault there reads ~0.015 a row, under FA_ROW_TOL; with the faulted
# tiles' K rows doubled (flash_32k's ``hot``) they read 0.21-0.42 (the
# plain version on the CPU), the rest of the keys still most of a row
JAMBA_HOT = {"long_500k_jamba_v01_52b_B1_1x4": 2.0}
# the one-unit checks' traffic on the same mesh, (seq_len, requests):
# rank 0's first MESH_CHECKED requests of a decode, every request of a
# prefill, against one card's step on the gathered weights and states;
# the prefill at 4 x 4,096 tokens (at 8 x 32,768 one card's capacity
# path alone would take 56 GB, and its routing couples all 8 requests)
JAMBA_UNIT = {"decode_32k": (32768, 128), "long_500k": (524288, 1),
              "prefill_32k": (4096, 4)}
# phase 18 (a): one unit through a one-rank group, (seq_len, requests)
JAMBA_ONE_RANK = (4096, 4)
# --small: jamba's smoke config in bf16 at head_dim 128 (the tc and
# decode routes) with 4 kv heads and 8 experts (2 a rank: the expert-slice
# fault rolls something), the same meshes, (seq_len, requests)
JAMBA_SMALL = {"decode_32k": (512, 8), "long_500k": (2048, 1),
               "prefill_32k": (256, 8)}
# the ranks' join deadline: about three times the 125.4 s phase 18 (b)
# took at full size on four H100s (the prefill's eager scan 54.85 s of it)
JAMBA_TIMEOUT_S = 360.0


def _jamba_config(small: bool = False, n_units: int = 0):
    """jamba-v0.1 at its published widths (``n_units`` of its 8-layer
    units when given), or the ``--small`` smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    if small:
        cfg = small_serve_config(get_config, "bfloat16", SERVE_BF16_HEAD_DIM,
                                 arch=JAMBA_ARCH, over={"n_kv_heads": 4})
        cfg = dataclasses.replace(cfg, moe=MoEConfig(
            n_experts=8, top_k=cfg.moe.top_k, d_ff=cfg.moe.d_ff))
    else:
        cfg = get_config(JAMBA_ARCH)
    if n_units:
        cfg = dataclasses.replace(cfg, n_layers=n_units * len(cfg.unit))
    return cfg


def _jamba_shape(shape_name: str, batch: int, small: bool, unit: bool):
    from repro_torch.configs.base import SHAPES
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
    if small or unit:
        L, B = (JAMBA_SMALL if small else JAMBA_UNIT)[shape_name]
        shape = dataclasses.replace(shape, seq_len=L, global_batch=B)
    return shape


def jamba_flash_call(fa_ref, fa_kernel, name: str, dev, seed: int) -> dict:
    """Cell ``name``'s flash call on one card (``JAMBA_FLASH``: a card's
    8 query and 2 kv heads of every request, bf16) through
    :func:`flash_32k`: the kernel against its plain version within the
    existing limits, the planted faults above them, timed beside its
    bound and SDPA; the plan's route and splits as the table gives
    them."""
    from repro_torch.configs import get_config
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_heads=full.n_heads // JAMBA_TP,
                              n_kv_heads=full.n_kv_heads // JAMBA_TP,
                              head_dim=full.resolved_head_dim)
    B, Sq, Sk, route, splits = JAMBA_FLASH[name]
    res = flash_32k(fa_ref, fa_kernel, cfg, B, Sq, Sk, dev, seed,
                    f"phase 18 (a) {name}", hot=JAMBA_HOT.get(name, 1.0))
    check((res["route"], res["splits"]) == (route, splits),
          f"phase 18 (a) {name}: the plan gives {res['route']} at "
          f"{res['splits']} splits, want {route} at {splits}")
    return res


def _fresh_cache(cell, cache, dev, seed: int) -> None:
    """A step's starting cache: a decode's every leaf drawn from a
    generator seeded with ``seed`` (index at the last position), a
    prefill's zeros (it starts from the cache's states)."""
    from repro_torch.parallel.sharding import leaves
    if cell.mode == "decode":
        _fill_normal(cache, torch.Generator(device=dev).manual_seed(seed))
        cache["index"] = cell.shape.seq_len - 1
    else:
        for _, t in leaves(cache):
            t.zero_()
        cache["index"] = 0


def jamba_one_rank(fa_kernel, dev, seed: int) -> dict:
    """Phase 18 (a), second part: one jamba unit (8 layers at published
    widths) drawn on the card through ``build_cell`` on the mesh of one
    card and a one-rank NCCL group (its Mamba, MoE and attention layers
    on the mesh's path, every collective over groups of one), at
    ``JAMBA_ONE_RANK`` requests over a cache of seeded random K/V and
    states: the bytes the dry run's, one ``decode`` launch, no collective,
    logits equal to ``Model.decode_step``'s on the same weights and cache
    bit for bit."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.group import destroy_mesh_group, init_mesh_group
    tag = "phase 18 (a)"
    t0 = time.perf_counter()
    cfg = _jamba_config(n_units=1)
    L, B = JAMBA_ONE_RANK
    cell = steps_mod.build_cell(cfg, ShapeConfig("decode_32k", L, B,
                                                 "decode"), one_card_mesh())
    model = Model(cfg, device=dev, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        group = init_mesh_group(cell.mesh, 0, pathlib.Path(tmp) / "store",
                                dev)
        try:
            state = cell.materialize(dev, seed, model=model, group=group)
            held = _held_vs_dryrun(cell, state, tag)
            cache = state.args["cache"]
            _fresh_cache(cell, cache, dev, seed + 18)
            fa_kernel.reset_counts()
            logits, _ = cell.run(state)
            _sync(dev)
            launches, routes = _cell_launches(fa_kernel)
            records = list(state.model.par.coll.records)
        finally:
            destroy_mesh_group()
    _fresh_cache(cell, cache, dev, seed + 18)
    model.par = None
    with torch.inference_mode():
        want, _ = model.decode_step(state.args["token"], cache)
    n_attn = layer_counts(cfg)["attn"]
    check(torch.equal(logits, want), f"{tag}: logits differ from "
          f"Model.decode_step's by {float((logits - want).abs().max())}")
    check(launches == n_attn and routes == {"decode": n_attn},
          f"{tag}: {launches} flash launches {routes}, want {n_attn} decode")
    check(records == [], f"{tag}: a one-rank group issued {records}")
    res = dict(launches=launches, routes=routes, held=held,
               wall_s=time.perf_counter() - t0)
    log(f"{tag}: one jamba unit ({cfg.n_layers} layers, "
        f"{held['params'] / 1e9:.3f} GB of weights) through a one-rank "
        f"{'NCCL' if dev.type == 'cuda' else 'gloo'} group, {B} requests "
        f"over {L} positions: the card holds {held['total']} B, the dry "
        f"run's; logits equal Model.decode_step's bit for bit; flash "
        f"launches {routes}; no collective; {res['wall_s']:.3f} s")
    del state, model, cache, logits, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _jamba_cell(steps_mod, fa_kernel, cfg, shape, group, dev,
                seed: int) -> dict:
    """One cell on this rank: its weights drawn one parameter at a time
    and cut (``materialize``), a decode's cache filled with seeded random
    bf16 K/V and f32 states at index L - 1, held bytes, one step (the
    plan's route and splits on every attention layer, the collectives
    against the trace), a decode's ``MESH_STEPS`` steps timed, peak
    memory, and the cell's bound: the larger of the traced FLOPs at 989
    TFLOP/s and the held bytes once at 3.35 TB/s."""
    from repro_torch.parallel.collectives import tally
    cell = steps_mod.build_cell(cfg, shape, group.mesh)
    traced, flops = cell.trace()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = cell.materialize(dev, seed, group=group)
    cache = state.args["cache"]
    _fresh_cache(cell, cache, dev, seed + 18 + group.rank)
    _sync(dev)
    build_s = time.perf_counter() - t0
    state.model.par.coll.timed = dev.type == "cuda"
    out = dict(held=state.held_bytes(), want=cell.argument_bytes(),
               build_s=build_s)
    logits, secs, coll_s, out["launches"], out["routes"], records = \
        _run_rank_cell(fa_kernel, cell, state, dev)
    out.update(records_equal_trace=records == traced,
               collectives=tally(records), traced=tally(traced),
               finite=bool(torch.isfinite(logits).all()))
    B_local = (state.args["token"] if cell.mode == "decode"
               else state.args["tokens"]).shape[0]
    Sq = shape.seq_len if cell.mode == "prefill" else 1
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    kv_local = cfg.n_kv_heads // state.model.par.tp
    out["plan"] = (fa_kernel.plan(torch.bfloat16, hd, G * Sq, shape.seq_len,
                                  B_local * kv_local,
                                  fa_kernel.n_sms(dev.index or 0))
                   if dev.type == "cuda" else None)
    if cell.mode == "decode":
        times, colls = [], []
        for _ in range(MESH_STEPS):
            cache["index"] = shape.seq_len - 1
            _, t, c, *_ = _run_rank_cell(fa_kernel, cell, state, dev)
            times.append(t * 1e3)
            colls.append(c * 1e3)
        out.update(step_ms=float(np.median(times)), step_ms_all=times,
                   collective_ms=float(np.median(colls)),
                   collective_ms_all=colls)
    else:
        out.update(step_s=secs, collective_s=coll_s)
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    bound_bytes = out["held"]["total"] / H100_BYTES_PER_S * 1e3
    out.update(bound_ms=max(bound_ops, bound_bytes), traced_flops=flops,
               bound_by="operations" if bound_ops >= bound_bytes
               else "bytes",
               peak_bytes=(torch.cuda.max_memory_allocated()
                           if dev.type == "cuda" else 0))
    del state, cache, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _digest(t: torch.Tensor) -> str:
    """The hash of a tensor's bytes (copied to the host)."""
    import hashlib
    t = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha1(t.numpy().tobytes()).hexdigest()


@contextlib.contextmanager
def routing_digests(moe_mod):
    """Digests of every MoE call's router input and, on the capacity
    path, its kept assignments, a dict a call in call order: what every
    rank of a model axis must compute alike, bit for bit."""
    rec = []
    probs_of, route = moe_mod.router_probs, moe_mod.route

    def probs(xf, router):
        rec.append({"input": _digest(xf)})
        return probs_of(xf, router)

    def routed(p, k, capacity):
        r = route(p, k, capacity)
        rec[-1]["keep"] = _digest(r.keep)
        return r

    moe_mod.router_probs, moe_mod.route = probs, routed
    try:
        yield rec
    finally:
        moe_mod.router_probs, moe_mod.route = probs_of, route


def _jamba_unit_check(steps_mod, cfg, shape, group, dev, seed: int) -> dict:
    """One unit of jamba on this rank's mesh: one step, its routing
    recorded (:func:`routing_record`) and digested
    (:func:`routing_digests`: every rank's must agree), and the same step
    under each of ``JAMBA_MESH_FAULTS``; then rank 0's first
    ``MESH_CHECKED`` requests of a decode (every request of a prefill,
    whose capacity routing couples them) against one card's
    ``Model.prefill`` / ``decode_step`` on the weights and starting
    states gathered whole, in bf16 and in float32 (the bf16 weights freed
    one by one as they are widened: one unit's float32 model is 53 GB),
    as phase 17 (b) holds the decode.  Both one-card steps take rank 0's
    expert choices (``follow``): each step rounds the router's input
    otherwise (the mesh sums its partial products in another order), a
    prefill's assignments sit at near-ties by the hundreds (at the smoke
    config a bf16 step's choice differs from the f32 step's at ~350 of
    8,192, at gaps down to 4e-7), and one moved assignment moves the
    capacity path's drops: with each step on its own routing, which
    near-ties flipped would set the distances, not the arithmetic.  The
    tokens where rank 0's choice (and one card's) differs from the f32
    step's own, and the smallest such gap (:func:`routing_flips`), are
    logged."""
    from repro_torch.launch.steps import model_holding
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.collectives import Collectives
    from repro_torch.parallel.group import gather_full
    from repro_torch.parallel.sharding import P
    rank = group.rank
    cell = steps_mod.build_cell(cfg, shape, group.mesh)
    state = cell.materialize(dev, seed, group=group)
    cache, decode = state.args["cache"], cell.mode == "decode"
    start = seed + 19 + rank

    def step():
        _fresh_cache(cell, cache, dev, start)
        return cell.run(state)[0]

    gather = Collectives(group)
    # a prefill's requests share their MoE capacity groups (one group on
    # this mesh), so one card's step sees them all: all are checked
    n = (min(MESH_CHECKED, shape.global_batch) if decode
         else shape.global_batch)
    lspec = P(None, cell.hints["logits"][2])

    def head_logits(lg):
        return gather_full(lg[:n], lspec, gather).float().cpu()

    with routing_record(moe_mod) as routing, \
            routing_digests(moe_mod) as digests:
        mine = head_logits(step())
    for d, (probs, ids) in zip(digests, routing):
        d.update(probs=_digest(probs), ids=_digest(ids))
    # a decode's tokens are its requests: the checked ones' rows
    routing = [(p[:n], i[:n]) if decode else (p, i) for p, i in routing]
    faulted = {}
    for fault in JAMBA_MESH_FAULTS:
        undo = plant_mesh_fault(state.model, fault, rank)
        faulted[fault] = head_logits(step())
        undo()
    _fresh_cache(cell, cache, dev, start)
    # the first requests' starting states, every head and channel (the
    # requests are not split on this mesh: "data" is one card)
    layers = {name: {k: gather_full(t[:, :n].contiguous(),
                                    cell.specs["cache"][f"layers/{name}/{k}"],
                                    gather)
                     for k, t in layer.items()}
              for name, layer in cache["layers"].items()}
    tokens = (state.args["token"] if decode else state.args["tokens"])[:n]
    model = state.model
    del state, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params = _gathered_params(cell, model, group, dev)
    del model
    out = {"checked": n, "routing": digests}
    if rank == 0:
        def one_card(m):
            with torch.inference_mode(), \
                    routing_record(moe_mod, follow=routing) as rec:
                if decode:
                    c = {"layers": {name: {k: t.clone() for k, t in
                                           layer.items()}
                                    for name, layer in layers.items()},
                         "index": shape.seq_len - 1}
                    lg = m.decode_step(tokens, c)[0]
                else:
                    lg = m.prefill(tokens, m.init_cache(n, shape.seq_len))[0]
            return lg.float().cpu(), rec

        want, want_rec = one_card(model_holding(cfg, params))
        wide = {}
        for name in list(params):
            wide[name] = params.pop(name).float()
        truth, truth_rec = one_card(model_holding(
            dataclasses.replace(cfg, dtype="float32"), wide))
        del wide
        floor = float((want - truth).abs().max())
        out.update(one_card_err=float((mine - want).abs().max()),
                   f32_err=float((mine - truth).abs().max()),
                   one_card_f32_err=floor,
                   f32_limit=MESH_F32_FACTOR * floor,
                   faults={f: float((g - want).abs().max())
                           for f, g in faulted.items()},
                   faults_f32={f: float((g - truth).abs().max())
                               for f, g in faulted.items()},
                   flips={who: routing_flips(rec, truth_rec, float("inf"))
                          for who, rec in (("mesh", routing),
                                           ("one card", want_rec))})
    del params, layers
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def jamba_rank(rank: int, tmp: str, seed: int, small: bool,
               device: str) -> None:
    """One rank of phase 18 (b), a process of its own: the cells of
    ``JAMBA_CELLS`` at jamba's 32 layers, then each at one unit
    (``JAMBA_UNIT``) held against one card, all on mesh ``(1, 4)``; its
    results written to ``tmp/rank<r>.json``."""
    dev = _rank_device(rank, device)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import steps as steps_mod
    from repro_torch.parallel.group import destroy_mesh_group, init_mesh_group
    from repro_torch.parallel.sharding import Mesh
    out = {"rank": rank}
    meshes = {sizes for _, sizes, _, _ in JAMBA_CELLS.values()}
    check(len(meshes) == 1, f"phase 18 (b): one mesh, not {meshes}")
    mesh = Mesh(meshes.pop(), ("data", "model"))
    group = init_mesh_group(mesh, rank, pathlib.Path(tmp) / "store", dev)
    dev = group.device
    try:
        cfg = _jamba_config(small)
        for name, (shape_name, _, batch, _) in JAMBA_CELLS.items():
            out[name] = _jamba_cell(steps_mod, fa_kernel, cfg,
                                    _jamba_shape(shape_name, batch, small,
                                                 False), group, dev, seed)
        unit = _jamba_config(small, n_units=1)
        for name, (shape_name, _, batch, _) in JAMBA_CELLS.items():
            out["unit " + name] = _jamba_unit_check(
                steps_mod, unit, _jamba_shape(shape_name, batch, small,
                                              True), group, dev, seed)
    finally:
        destroy_mesh_group()
    (pathlib.Path(tmp) / f"rank{rank}.json").write_text(
        json.dumps(out, default=str))


def jamba_mesh_cells(seed: int, small: bool = False, device: str = "cuda",
                     timeout: float = JAMBA_TIMEOUT_S) -> dict:
    """Phase 18 (b): ``MESH_RANKS`` processes (``jamba_rank``) run
    ``JAMBA_CELLS`` at jamba's published size (the smoke config with
    ``small``) on ``(1, 4)``.  Checks on every rank: the held bytes the
    dry run's (and at full size the table's), the collectives the
    trace's, finite logits, and on the card every flash launch on the
    route and split count of ``JAMBA_FLASH`` (the plan's, at the smoke
    config); the time against the cell's bound is logged.  At one unit,
    every rank's router inputs, probabilities, experts and kept
    assignments bit for bit rank 0's, and phase 17's gate: rank 0's
    distance from the f32 step within ``MESH_F32_FACTOR`` times one
    card's, both one-card steps on rank 0's experts
    (:func:`_jamba_unit_check`), which every planted fault exceeds (its
    distance from one card's bf16 step is logged beside).  Returns the
    ranks' records by cell."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(jamba_rank, seed, small, device, timeout,
                         "phase 18 (b)")
    out = {"wall_s": time.perf_counter() - t0, "small": small}
    n_attn = layer_counts(_jamba_config(small))["attn"]
    for name, (shape_name, sizes, _, held) in JAMBA_CELLS.items():
        tag = f"phase 18 (b) {name}{' (smoke config)' if small else ''}"
        recs = [r[name] for r in ranks]
        for r, rec in enumerate(recs):
            check(rec["held"] == rec["want"] and (
                small or rec["held"]["total"] == held),
                f"{tag}: rank {r} holds {rec['held']}, the dry run says "
                f"{rec['want']}" + ("" if small else f", the table {held}"))
            check(rec["records_equal_trace"], f"{tag}: rank {r} issued "
                  f"{rec['collectives']}, the trace {rec['traced']}")
            check(rec["finite"], f"{tag}: rank {r}'s logits")
            if device == "cuda":
                _, _, _, route, splits = JAMBA_FLASH[name]
                want = (route, rec["plan"][1] if small else splits)
                check(tuple(rec["plan"]) == want
                      and rec["routes"] == {route: n_attn},
                      f"{tag}: rank {r} launched {rec['routes']}, the plan "
                      f"gives {rec['plan']}, want {n_attn} {want}")
        step = "step_s" if shape_name == "prefill_32k" else "step_ms"
        unit = ranks[0]["unit " + name]
        alike = [r["unit " + name]["routing"] == unit["routing"]
                 for r in ranks]
        per = [x[step] * (1e3 if step == "step_s" else 1.0) for x in recs]
        log(f"{tag}: mesh {dict(zip(('data', 'model'), sizes))}; per rank "
            f"held (B) {[x['held']['total'] for x in recs]} == the dry "
            f"run's; build (s) {[round(x['build_s'], 3) for x in recs]}; "
            f"peak (GB) {[round(x['peak_bytes'] / 1e9, 3) for x in recs]}; "
            f"{step} {[x[step] for x in recs]}"
            + (f" (median of {MESH_STEPS}; rank 0's all "
               f"{recs[0]['step_ms_all']})" if step == "step_ms" else "")
            + f" against the bound {recs[0]['bound_ms']:.3f} ms by "
            f"{recs[0]['bound_by']} ({max(per) / recs[0]['bound_ms']:.2f}x"
            f" at the slowest rank); in collectives "
            f"{[x.get('collective_ms', x.get('collective_s')) for x in recs]}"
            f" {'ms' if step == 'step_ms' else 's'}; flash launches "
            f"{[x['routes'] for x in recs]}, plan {recs[0]['plan']}; "
            f"collectives issued {json.dumps(recs[0]['collectives'])} == "
            f"traced; at one unit ({unit['checked']} requests checked): "
            f"rank 0 vs the f32 step {unit['f32_err']:.4e} (limit "
            f"{unit['f32_limit']:.4e}: {MESH_F32_FACTOR} x one card's "
            f"{unit['one_card_f32_err']:.4e}), vs one card "
            f"{unit['one_card_err']:.4e} (both one-card steps on rank 0's "
            f"experts; (tokens, smallest gap) where the f32 step's own "
            f"choice differs: {json.dumps(unit['flips'])}); ranks routing its "
            f"{len(unit['routing'])} MoE calls as rank 0: {alike}; planted "
            f"faults from the f32 step "
            f"{json.dumps(unit['faults_f32'])}, from one card "
            f"{json.dumps(unit['faults'])}")
        check(all(alike), f"{tag} at one unit: ranks' router inputs, "
              f"probabilities, experts or kept assignments against rank "
              f"0's: {alike}")
        check(unit["f32_err"] <= unit["f32_limit"], f"{tag} at one unit: "
              f"rank 0's logits read {unit['f32_err']} from the f32 step, "
              f"above {MESH_F32_FACTOR} x one card's "
              f"{unit['one_card_f32_err']}")
        check(min(unit["faults_f32"].values()) > unit["f32_limit"],
              f"{tag} at one unit: a planted fault reads "
              f"{unit['faults_f32']} from the f32 step, within "
              f"{unit['f32_limit']}")
        out[name] = recs
        out["unit " + name] = unit
    log(f"phase 18 (b) took {out['wall_s']:.1f} s")
    return out


def jamba_phase(fa_ref, fa_kernel, dev, seed: int) -> dict:
    """Phase 18: (a) :func:`jamba_flash_call` for each cell and
    :func:`jamba_one_rank`;
    (b) on a host of ``MESH_RANKS`` or more cards, :func:`jamba_mesh_cells`
    at full size."""
    t0 = time.perf_counter()
    out = {"flash": {name: jamba_flash_call(fa_ref, fa_kernel, name, dev,
                                            seed) for name in JAMBA_FLASH},
           "one_rank": jamba_one_rank(fa_kernel, dev, seed)}
    out["a_s"] = time.perf_counter() - t0
    log(f"phase 18 (a) took {out['a_s']:.1f} s")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= MESH_RANKS:
        torch.cuda.empty_cache()
        out["mesh"] = jamba_mesh_cells(seed)
    else:
        log(f"phase 18 (b): {cards} card(s) on this host; the four-card "
            f"cells {list(JAMBA_CELLS)} need {MESH_RANKS} "
            f"(scripts/mesh_cell.py runs them)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 18 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return smi[0] if smi else "unknown"


def build_kernels(builders) -> None:
    """Build every kernel's source at once (``builders``: one zero-argument
    build function per source, one nvcc each, in parallel); report the
    seconds and the compiler's register/spill/shared-memory lines."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    with ThreadPoolExecutor(len(builders)) as pool:
        built = list(pool.map(timed, builders))
    for lib, secs in built:
        log(f"phase 1: built {lib.name} in {secs:.3f} s")
        report = lib.with_name(lib.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    log("phase 1: ptxas " + line.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every workload, batch and weight draw "
                         "(default 0)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.obs as obs
        import repro_torch.pmwcas as pm
        import repro_torch.service as svc_mod
        import repro_torch.structures as st
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.pmwcas_apply import kernel
        from repro_torch.kernels.pmwcas_apply import ref
        from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
        import repro_torch.core as core
        import repro_torch.chaos as chaos
        from repro_torch.launch import serve as serve_mod
        from repro_torch.models import build_model
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}:"
              f" {e}", file=sys.stderr)
        return 3
    # float32 references run in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_start = time.perf_counter()
    build_kernels([kernel.build, sim_kernel.build]
                  + [functools.partial(fa_kernel.build, r)
                     for r in fa_kernel.ROUTES])

    dev = torch.device("cuda")
    worst = kernel_vs_plain(pm, ref, kernel, args.seed, dev)
    small_service_matches_cpu(svc_mod, st, args.seed, dev)
    fa_worst = fa_kernel_vs_plain(fa_ops, fa_ref, fa_kernel, args.seed, dev)
    small_serve_matches_cpu(serve_mod, build_model, get_config, args.seed,
                            dev)
    small_serve_bf16(serve_mod, build_model, get_config, args.seed, dev)
    run = full_slice(pm, svc_mod, st, obs, kernel, dev, args.seed)
    t = kernel_timings(pm, ref, kernel, run["svc"], args.seed, dev)
    del run["svc"]
    log(f"phases 1-4 took {time.perf_counter() - t_start:.1f} s")

    lm = lm_slice(serve_mod, build_model, get_config, ref, fa_kernel, kernel,
                  args.seed, dev)
    ft = flash_timings(fa_ops, fa_ref, fa_kernel, lm, dev, args.seed)
    where_time_goes(lm, ft, dev, args.seed)
    fa_serve = dict(launches=lm["fa_launches"], routes=lm["fa_routes"])
    del lm                       # the serve model's 16 GB, before phase 11
    torch.cuda.empty_cache()
    durable = durable_phase(pm, svc_mod, st, obs, kernel, dev, args.seed)
    log("durable: " + json.dumps({
        "differential": durable["differential"],
        "ycsb": durable["ycsb"],
        "ledger": durable["ledger"]}))
    tree = tree_phase(pm, ref, svc_mod, st, obs, kernel, dev, args.seed)
    log("tree: " + json.dumps(tree, default=str))
    sim = sim_phase(core, pm, st, sim_kernel, kernel, dev, args.seed)
    grid = sim["grid"]
    log("sim: " + json.dumps(sim, default=str))
    chaos_run = chaos_phase(chaos, obs, kernel, sim_kernel, dev, args.seed)
    log("chaos: " + json.dumps(chaos_run))
    train = train_phase(fa_kernel, fa_ref, dev, args.seed)
    tc, tt = train["cell"], train["timings"]
    log("train: " + json.dumps(train, default=str))
    moe = moe_phase(serve_mod, build_model, fa_ops, fa_ref, fa_kernel, ref,
                    kernel, dev, args.seed)
    ms, mt = moe["serve"], moe["train"]
    log("moe: " + json.dumps(moe, default=str))
    ssm = ssm_phase(serve_mod, build_model, fa_ops, fa_ref, fa_kernel, ref,
                    kernel, dev, args.seed)
    sx, sj = ssm["serve_xlstm"], ssm["serve_jamba"]
    log("ssm: " + json.dumps(ssm, default=str))
    encdec = encdec_phase(serve_mod, build_model, fa_ref, fa_kernel, ref,
                          kernel, dev, args.seed)
    es, ep = encdec["serve_seamless"], encdec["serve_paligemma"]
    et, ef = encdec["train_seamless"], encdec["flash"]
    log("encdec: " + json.dumps(encdec, default=str))
    torch.cuda.empty_cache()
    int8 = int8_phase(serve_mod, build_model, ref, kernel, fa_kernel, dev,
                      args.seed)
    iq, il = int8["serve_qwen"], int8["llama3"]
    log("int8: " + json.dumps(int8, default=str))
    torch.cuda.empty_cache()
    kept = {}
    cells = cells_phase(fa_ref, fa_kernel, dev, args.seed, keep=kept)
    log("cells: " + json.dumps(cells, default=str))
    torch.cuda.empty_cache()
    mesh = mesh_phase(fa_kernel, kept, dev, args.seed)
    log("mesh: " + json.dumps(mesh, default=str))
    torch.cuda.empty_cache()
    jamba = jamba_phase(fa_ref, fa_kernel, dev, args.seed)
    log("jamba: " + json.dumps(jamba, default=str))
    log(f"the whole smoke took {time.perf_counter() - t_start:.1f} s")

    pre, dec = ft["prefill"], ft["decode"]
    log("flash decode (bf16, the serve cell's shape): " + json.dumps({
        "route": dec["route"], "splits": dec["splits"],
        "graph_ms": dec["graph_ms"], "graph_plain_ms": dec["graph_plain_ms"],
        "graph_library_ms": dec["graph_library_ms"],
        "graph_rounds_ms": dec["graph_rounds_ms"],
        "graph_library_rounds_ms": dec["graph_library_rounds_ms"],
        "row_err": dec["row_err"], "faults": dec["faults"],
        "event_ms": dec["ms"],
        "event_plain_ms": dec["plain_ms"],
        "event_library_ms": dec["library_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"]}))
    log(card)
    print(json.dumps({"kernels": [{
        "name": "pmwcas_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/pmwcas_apply.cu",
        "route_launches": run["routes"],
        "replaces": "src/repro/kernels/pmwcas_apply/kernel.py:62",
        "launches": run["launches"],
        "differential_launches": durable["differential"]["launches"],
        "differential_route_launches": durable["differential"]["routes"],
        "max_abs_err": worst,
        "ms": t["ms"], "global_route_ms": t["global_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "latency_floor_ms": t["floor_ms"],
        "wave_dispatch_device_us": run["wave_split"]["dispatch"],
        "tree_launches": tree["run"]["launches"],
        "tree_route_launches": tree["run"]["routes"],
        "tree_gc_route_launches": tree["run"]["gc_routes"],
        "tree_global_ms": {str(K): t["ms"]
                           for K, t in tree["timings"].items()},
        "tree_global_plain_ms": {str(K): t["plain_ms"]
                                 for K, t in tree["timings"].items()},
        "tree_global_bound_ms": {str(K): t["bound_ms"]
                                 for K, t in tree["timings"].items()},
        "chaos_storm_route_launches": chaos_run["storm"]["routes"],
        "chaos_storm_dispatches": chaos_run["storm"]["dispatches"],
        "moe_serve_launches": ms["pm_launches"],
        "moe_serve_route_launches": ms["pm_routes"],
        "xlstm_serve_launches": sx["pm_launches"],
        "jamba_serve_launches": sj["pm_launches"],
        "seamless_serve_launches": es["pm_launches"],
        "seamless_serve_route_launches": es["pm_routes"],
        "paligemma_serve_launches": ep["pm_launches"],
        "paligemma_serve_route_launches": ep["pm_routes"],
        "qwen_int8_serve_launches": iq["pm_launches"],
        "qwen_int8_serve_route_launches": iq["pm_routes"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "sources": [f"src/repro_torch/csrc/{p.name}"
                    for p in fa_kernel.SOURCES.values()],
        "route_launches": fa_serve["routes"],
        "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
        "launches": fa_serve["launches"],
        "max_abs_err": max(fa_worst, pre["err"], dec["err"],
                           ms["flash"]["prefill"]["err"],
                           ms["flash"]["decode"]["err"],
                           sj["flash"]["prefill"]["err"],
                           sj["flash"]["decode"]["err"],
                           *(r["err"] for r in ef.values()),
                           *(r["err"] for r in jamba["flash"].values()),
                           *(w[0] for w in train["lse"]["worst"].values())),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"],
        "lse_routes": ["tc", "simt"],
        "lse_max_abs_err": max(w[1] for w in train["lse"]["worst"].values()),
        "train_launches": tc["launches"],
        "train_route_launches": tc["routes"],
        "train_ms": tt["ms"], "train_ms_no_lse": tt["ms_no_lse"],
        "train_plain_ms": tt["plain_ms"], "train_bound_ms": tt["bound_ms"],
        "train_bound_by": tt["bound_by"],
        "train_library_ms": tt["library_ms"],
        "train_library_bwd_ms": tt["library_bwd_ms"],
        "train_plain_bwd_ms": tt["bwd_ms"],
        "moe_serve_launches": ms["fa_launches"],
        "moe_serve_route_launches": ms["fa_routes"],
        "moe_train_launches": mt["launches"],
        "moe_train_route_launches": mt["routes"],
        "jamba_serve_launches": sj["fa_launches"],
        "jamba_serve_route_launches": sj["fa_routes"],
        "seamless_serve_launches": es["fa_launches"],
        "seamless_serve_route_launches": es["fa_routes"],
        "paligemma_serve_launches": ep["fa_launches"],
        "paligemma_serve_route_launches": ep["fa_routes"],
        "seamless_train_launches": et["launches"],
        "seamless_train_route_launches": et["routes"],
        "seamless_serve_form_launches": es["fa_forms"],
        "paligemma_serve_form_launches": ep["fa_forms"],
        "seamless_train_form_launches": et["forms"],
        "qwen_int8_serve_launches": iq["fa_launches"],
        "llama3_int8_serve_launches": il["int8"]["fa_launches"],
        "cells_32k": {name: dict(
            launches=cells[mode]["launches"],
            route_launches=cells[mode]["routes"],
            **{k: cells["flash"][name][k] for k in (
                "route", "splits", "ms", "plain_rows_ms", "rows",
                "bound_ms", "bound_by", "library_ms", "library_how", "err",
                "row_err")})
            for name, mode in (("prefill_32k", "prefill"),
                               ("decode_32k", "decode"))},
        "mesh_one_rank_launches": mesh["one_rank"]["launches"],
        "mesh_one_rank_route_launches": mesh["one_rank"]["routes"],
        "mesh_cells": {name: dict(
            mesh=recs[0]["mesh"],
            rank_launches=[r["launches"] for r in recs],
            rank_route_launches=[r["routes"] for r in recs])
            for name, recs in mesh.get("mesh", {}).items()
            if name in MESH_CELLS},
        "jamba_unit_one_rank_launches": jamba["one_rank"]["launches"],
        "jamba_unit_one_rank_route_launches": jamba["one_rank"]["routes"],
        "jamba_4card_shapes": {name: {k: r[k] for k in (
            "route", "splits", "ms", "plain_rows_ms", "rows", "bound_ms",
            "bound_by", "library_ms", "library_how", "err", "row_err")}
            for name, r in jamba["flash"].items()},
        "jamba_mesh_cells": {name: dict(
            mesh=dict(zip(("data", "model"), JAMBA_CELLS[name][1])),
            rank_launches=[r["launches"] for r in recs],
            rank_route_launches=[r["routes"] for r in recs])
            for name, recs in jamba.get("mesh", {}).items()
            if name in JAMBA_CELLS},
        "encdec_shapes": {name: {k: r[k] for k in (
            "route", "launches", "ms", "plain_ms", "plain_B", "bound_ms",
            "bound_by", "library_ms", "err")} for name, r in ef.items()},
        "jamba_hd128_g4": {shape: {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for shape, r in sj["flash"].items()
            if shape in ("prefill", "decode")},
        "hd64": {shape: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}
                 for shape, r in (("prefill", ms["flash"]["prefill"]),
                                  ("decode", ms["flash"]["decode"]),
                                  ("train", mt["timings"]))}}, {
        "name": "pmwcas_sim", "route": "cuda",
        "source": "src/repro_torch/csrc/pmwcas_sim.cu",
        "replaces": "src/repro/core/sim.py:175",
        "launches": sim["launches"], "route_launches": sim["routes"],
        "grid_launches": 1, "grid_route": "smem",
        "differential_launches": durable["differential"]["sim_launches"],
        "differential_route_launches": durable["differential"][
            "sim_routes"],
        "tree_sim_launches": tree["differential"]["sim_launches"],
        "tree_sim_route_launches": tree["differential"]["sim_routes"],
        "chaos_sim_native_launches": chaos_run["sim"]["launches"],
        "chaos_sim_native_route_launches": chaos_run["sim"]["routes"],
        "max_abs_err": sim["err"],
        "ms": grid["grid_ms"], "global_route_ms": grid["global_grid_ms"],
        "grid_cells": grid["cells"], "grid_steps": grid["grid_steps"],
        "plain_ms": grid["plain_grid_ms"],
        "plain_ms_is": "extrapolated from four full-size cells",
        "plain_us_step": grid["plain_us_step"],
        "bound_ms": grid["bound_ms"], "bound_by": "bytes",
        "latency_bound_ms": grid["latency_bound_ms"],
        "step_us": grid["step_us"],
        "global_route_step_us": grid["global_step_us"],
        "step_floor_us": grid["floor_us"],
        "slowest_cells": {r: v["slowest"]
                          for r, v in grid["routes"].items()},
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
