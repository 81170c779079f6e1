"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

The port of ``repro/models/moe.py``.  Tokens go to their top-k experts
through a per-expert capacity bound: an expert takes at most ``C``
assignments, in token order (the k slots of one token in k order), and
the assignments past ``C`` are dropped (the residual passes them
through).  The experts run as batched products over an ``[E, C, D]``
buffer.  Decode (one token a sequence) takes :func:`apply_moe_dense`,
every expert for every token with no drop.

The reference runs this as XLA outside any Pallas kernel, so the port's
products stay ``torch.einsum`` on both devices (a grouped-expert kernel
is later speed work).  What must match the reference exactly, and how:

- **Ties in the top-k.** ``jax.lax.top_k`` puts the lower expert index
  first among equal probabilities; ``torch.topk`` promises no order.
  :func:`topk_stable` takes the first ``k`` of a stable descending sort.
- **Capacity ranks.** An assignment's rank within its expert is its
  place in a stable sort of the flattened ``[N*K]`` expert ids
  (:func:`route`), so drops fall in token order, then k order.
- **The router in float32.** ``xf.float() @ router.float()``: the
  reference promotes a cast (bf16) router to float32 there.  On the card
  this product must stay full float32 (no TF32, which is torch's
  default for matrix products): routing flips on an ulp of a logit.

``ecd_hint``, ``gather_hint`` and ``group_hint`` are the reference's
sharding constraints; they are accepted and place nothing.  ``groups``
is honoured: it enforces capacity per group of tokens, which changes
which tokens drop.

On a mesh (``par``, a rank's
:class:`~repro_torch.parallel.collectives.Spmd`, with a model axis of
more than one device) the experts are split over the model axis, as the
reference's ``moe_ecd`` constraint places them: the rank holds
``E / tp`` experts' weights (``wi_* [E/tp, D, F]``, ``wo [E/tp, F, D]``)
and the whole router.  Its tokens are the same on every rank of the axis,
so the router, :func:`topk_stable`, :func:`route`, the capacity and the
drops are the same on every rank; each computes only its experts' slots
(the capacity path) or columns of the gate matrix (the dense path), adds
its experts' weighted outputs into a float32 partial ``y`` and the
partials are all-reduced over the model axis (``moe``), then rounded
once: one card's combine sums the same bf16 products in float32 and
rounds once, so a token whose experts sit on one rank gets one card's
``y`` and the rest differ by the order of a float32 sum.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import KeyGen, act_fn, make_param

# calls of each path (a prefill's capacity path, a decode step's dense
# path), counted so a run can show which path its layers took
calls: Dict[str, int] = {"capacity": 0, "dense": 0}


def reset_counts() -> None:
    calls.update(capacity=0, dense=0)


def init_moe(kg: Optional[KeyGen], d_model: int, n_experts: int, d_ff: int,
             dtype, router_dtype=torch.float32, mode: str = "normal",
             device=None) -> Dict[str, torch.Tensor]:
    """The router ``[D, E]`` (a float32 master in the reference) and the
    experts' ``wi_gate``/``wi_up [E, D, F]`` and ``wo [E, F, D]``, drawn
    in the reference's order."""
    gen = kg() if kg is not None else None
    kw = dict(mode=mode, device=device)
    return {
        "router": make_param(gen, (d_model, n_experts), router_dtype, **kw),
        "wi_gate": make_param(gen, (n_experts, d_model, d_ff), dtype, **kw),
        "wi_up": make_param(gen, (n_experts, d_model, d_ff), dtype, **kw),
        "wo": make_param(gen, (n_experts, d_ff, d_model), dtype, **kw),
    }


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8 for layout


def router_probs(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Softmax of the float32 router logits ``[N, E]``."""
    return torch.softmax(xf.float() @ router.float(), dim=-1)


def topk_stable(probs: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest probabilities of each row and their expert ids,
    the lower id first among equals (``jax.lax.top_k``'s order); the
    values renormalized to sum to 1."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :k], ids[..., :k]
    return vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9), ids


class Routing(NamedTuple):
    gate_vals: torch.Tensor      # [N, K] f32, normalized
    expert_ids: torch.Tensor     # [N, K] int64
    pos: torch.Tensor            # [N, K] rank of the assignment in its expert
    keep: torch.Tensor           # [N, K] bool: pos < C
    counts: torch.Tensor         # [E] assignments an expert got, drops too


def route(probs: torch.Tensor, k: int, capacity: int) -> Routing:
    """Top-k routing of ``probs [N, E]`` under capacity ``capacity``: each
    assignment's rank among its expert's assignments in token order (a
    stable sort of the flattened expert ids), and whether it is kept."""
    N, E = probs.shape
    gate_vals, expert_ids = topk_stable(probs, k)
    flat_e = expert_ids.reshape(N * k)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e))    # a bincount
    # that also runs on meta tensors (the dry run's trace)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(N * k, device=probs.device) - starts[flat_e[order]]
    pos = torch.empty_like(flat_e).scatter_(0, order, ranks).reshape(N, k)
    return Routing(gate_vals, expert_ids, pos, pos < capacity, counts)


def _split(par) -> bool:
    """Whether ``par`` splits the experts over a model axis of more than
    one device."""
    return par is not None and par.tp > 1


def _combine_f32(par, x: torch.Tensor, parts) -> torch.Tensor:
    """The sum over the ranks of this rank's partial ``y [N, D]`` in
    float32, rounded once to ``x``'s dtype: ``parts`` yields ``(outputs
    [N, D], weights [N])`` pairs (one at a time, so one is held), each
    added as ``outputs * weights`` (bf16 products are exact in float32)."""
    y = torch.zeros(x.shape[0] * x.shape[1], x.shape[2],
                    dtype=torch.float32, device=x.device)
    for out, w in parts:
        y.addcmul_(out, w[:, None])
    return par.reduce(y, "moe").to(x.dtype).reshape(x.shape)


def apply_moe(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              ecd_hint=None, gather_hint=None, groups: int = 1,
              group_hint=None, par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], the load-balancing aux loss, a 0-d
    float32 tensor).  ``groups > 1`` (dividing B*S) routes each group of
    tokens on its own, capacity per group, and averages their aux.
    ``par``: a rank of a mesh, its experts split over the model axis (the
    module's docstring)."""
    B, S, D = x.shape
    N = B * S
    if groups > 1 and N % groups == 0:
        xg = x.reshape(groups, N // groups, 1, D)
        outs = [apply_moe(p, xg[g], top_k=top_k,
                          capacity_factor=capacity_factor, act=act, par=par)
                for g in range(groups)]
        return (torch.stack([y for y, _ in outs]).reshape(B, S, D),
                torch.stack([a for _, a in outs]).mean())
    calls["capacity"] += 1
    E = p["router"].shape[1]
    C = _capacity(N, E, top_k, capacity_factor)
    xf = x.reshape(N, D)
    probs = router_probs(xf, p["router"])
    r = route(probs, top_k, C)
    # load-balancing auxiliary loss (Switch-style); counts include drops
    me = probs.mean(dim=0)
    aux = E * torch.sum(me * (r.counts.float() / (N * top_k)))

    # this rank's experts [e0, e0 + E_l): every expert on one device
    E_l = p["wi_gate"].shape[0]
    e0 = par.local_range(E)[0] if _split(par) else 0
    mine = r.keep & (r.expert_ids >= e0) & (r.expert_ids < e0 + E_l)
    # dispatch: src[e*C + c] = the token of expert e's c-th kept
    # assignment (the reference gathers it from the expert-sorted
    # stream); slot = where each assignment's output lands.  An empty
    # slot reads token (e*C + c) mod N where the reference reads a zero
    # row appended to xf: no output of an empty slot reaches y but with
    # weight 0 (a dropped assignment, or another rank's, reads slot
    # E_l*C - 1 with weight 0), so y is the same and so is every
    # gradient, up to the order of its sums; and the backward's
    # sort-based scatter of xe's gradient does not serialize over the one
    # row that every empty slot would share (a fifth of the slots at
    # capacity factor 1.25)
    slot = torch.where(mine, (r.expert_ids - e0) * C + r.pos, E_l * C)
    tokens = torch.arange(N, device=x.device)[:, None].expand(N, top_k)
    src = torch.arange(E_l * C + 1, device=x.device) % N
    src[slot.reshape(-1)] = tokens.reshape(-1)   # the rest land on E_l*C
    xe = xf[src[:E_l * C]].reshape(E_l, C, D)

    h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, p["wi_gate"])) * \
        torch.einsum("ecd,edf->ecf", xe, p["wi_up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["wo"]).reshape(E_l * C, D)
    del xe, h
    at = slot.clamp(max=E_l * C - 1)
    if _split(par):
        w = (r.gate_vals * mine).to(x.dtype).float()
        return _combine_f32(par, x, ((ye[at[:, k]], w[:, k])
                                     for k in range(top_k))), aux
    gathered = ye[at.reshape(-1)].reshape(N, top_k, D)
    w = (r.gate_vals * r.keep).to(x.dtype)                   # dropped -> 0
    y = torch.einsum("nkd,nk->nd", gathered, w)
    return y.reshape(B, S, D), aux


def apply_moe_dense(p, x: torch.Tensor, *, top_k: int, act: str = "silu",
                    par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE for decode: every expert on every token, combined with
    the normalized top-k gates; the aux loss is 0.  ``par``: a rank of a
    mesh, which computes its experts' columns of the gate matrix and
    sums their outputs over the ranks (the module's docstring)."""
    calls["dense"] += 1
    B, S, D = x.shape
    E = p["router"].shape[1]
    xf = x.reshape(B * S, D)
    gate_vals, expert_ids = topk_stable(router_probs(xf, p["router"]),
                                        top_k)
    w = (F.one_hot(expert_ids, E).float() * gate_vals[..., None]).sum(dim=1)

    h = act_fn(act)(torch.einsum("nd,edf->nef", xf, p["wi_gate"])) * \
        torch.einsum("nd,edf->nef", xf, p["wi_up"])
    ye = torch.einsum("nef,efd->ned", h, p["wo"])
    if _split(par):
        e0, e1 = par.local_range(E)
        w = w[:, e0:e1].to(ye.dtype).float()
        y = _combine_f32(par, x, ((ye[:, e], w[:, e])
                                  for e in range(e1 - e0)))
    else:
        y = torch.einsum("ned,ne->nd", ye, w.to(ye.dtype)).reshape(B, S, D)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)
