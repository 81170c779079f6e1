"""Batched serving launcher with PMwCAS-style KV-page admission.

The port of ``repro/launch/serve.py``.  Requests propose KV-cache page
groups; admission grants each group atomically through the batched
deterministic MwCAS primitive (``repro_torch.pmwcas.reserve_slots``: the
Hopper PMwCAS kernel on the card), with index order as the
linearization.  The admitted requests are prefilled and greedily decoded
through the model stack, whose attention layers run the Hopper
flash-attention kernel on the card (``attn_impl`` picks a plain version
on the CPU only).  With ``cfg.kv_dtype = "int8"`` the self-attention
layers keep an int8 cache and attend over it through the plain
chunk-dequantizing path (``models.attention._sdpa_chunked_quant``), on
the card too, with no flash launch; ``launch.steps.cell_model_config``
picks int8 for qwen1.5-32b's decode cells, as the reference does.  An
arch with a frontend gets the reference launcher's stub embeddings,
``0.02 * ones((B, frontend_len, frontend_dim))`` in float32 (the
encoder's frames, or a vision prefix),
and a cache of ``prompt_len + steps + frontend_len`` positions, as the
reference launcher sizes it (for an encoder-decoder too, whose decoder
never writes the last ``frontend_len`` of them); the page proposals
still count ``prompt_len + steps`` tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --requests 12 --steps 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, build_model
from repro_torch.pmwcas import reserve_slots, resolve_device


class PageAllocator:
    """KV-page table driven by batched MwCAS reservations: an ``int32``
    free mask (1 = free) on the device, updated in place."""

    def __init__(self, n_pages: int, device="cuda"):
        self.device = resolve_device(device)
        self.free = torch.ones(n_pages, dtype=torch.int32,
                               device=self.device)
        self.n_pages = n_pages

    def admit(self, page_requests: np.ndarray) -> np.ndarray:
        """page_requests: int32[B, K] candidate page ids (<0 pad).
        Returns granted: bool[B] -- atomically all-or-nothing per request."""
        reqs = torch.as_tensor(np.asarray(page_requests, np.int32),
                               device=self.device)
        _, granted = reserve_slots(self.free, reqs)
        return granted.cpu().numpy()

    def release(self, pages) -> None:
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)
        self.free[idx] = 1


def propose_pages(requests: int, pages_per_req: int, n_pages: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Every request proposes a run of pages; successive runs start
    1..pages_per_req pages apart, so neighbours contend (the reference's
    draws, in its order)."""
    reqs = np.full((requests, pages_per_req), -1, np.int32)
    cursor = 0
    for i in range(requests):
        reqs[i] = np.arange(cursor, cursor + pages_per_req) % n_pages
        cursor += rng.integers(1, pages_per_req + 1)
    return reqs


@dataclasses.dataclass
class ServeResult:
    proposals: np.ndarray            # int32[requests, pages_per_req]
    granted: np.ndarray              # bool[requests]
    admitted: np.ndarray             # indices of the granted requests
    prompts: Optional[np.ndarray]    # int32[B, prompt_len] (None if B = 0)
    generated: Optional[np.ndarray]  # int32[B, steps]
    logits: List[torch.Tensor]       # per step [B, V] f32 on the CPU, if kept
    logits_finite: bool              # every step's logits were finite
    timings: Dict[str, float]        # host seconds, device synchronised


def serve(cfg: ModelConfig, *, requests: int, steps: int, prompt_len: int,
          page_size: int, n_pages: int, device: Union[str, torch.device] =
          "cuda", seed: int = 0, model: Optional[Model] = None,
          keep_logits: bool = False) -> ServeResult:
    """Admit, prefill and greedily decode ``steps`` tokens.

    The numpy draws (page proposals, then prompt tokens) come from
    ``default_rng(seed)`` in the reference launcher's order; the weights
    are drawn from a ``torch.Generator`` seeded with ``seed`` unless
    ``model`` is given.  ``keep_logits`` returns every step's logits (the
    prefill's and each decode step's) on the CPU.
    """
    dev = resolve_device(device)
    if model is None:
        model = build_model(cfg, device=dev, seed=seed)
    if model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, serving on {dev}")
    alloc = PageAllocator(n_pages, dev)
    rng = np.random.default_rng(seed)
    pages_per_req = -(-(prompt_len + steps) // page_size)
    proposals = propose_pages(requests, pages_per_req, n_pages, rng)
    granted = alloc.admit(proposals)
    admitted = np.nonzero(granted)[0]
    timings: Dict[str, float] = {}
    if len(admitted) == 0:
        return ServeResult(proposals, granted, admitted, None, None, [],
                           True, timings)

    B = len(admitted)
    total = prompt_len + steps
    prompts = rng.integers(0, cfg.vocab, (B, prompt_len)).astype(np.int32)
    kept: List[torch.Tensor] = []
    fe = (torch.full((B, cfg.frontend_len, cfg.frontend_dim), 0.02,
                     dtype=torch.float32, device=dev)
          if cfg.frontend != "none" else None)
    with torch.inference_mode():
        cache = model.init_cache(B, total + cfg.frontend_len)
        tokens = torch.as_tensor(prompts, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens, cache, fe)
        _sync(dev)
        t1 = time.perf_counter()
        finite = torch.isfinite(logits).all()
        out = []
        for _ in range(steps):
            if keep_logits:
                kept.append(logits.to("cpu", non_blocking=False))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(nxt)
            logits, cache = model.decode_step(nxt, cache)
            finite = finite & torch.isfinite(logits).all()
        generated = torch.cat(out, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        if keep_logits:
            kept.append(logits.cpu())
        logits_finite = bool(finite)
    decode_s = t2 - t1
    timings = {"prefill_s": t1 - t0, "decode_s": decode_s,
               "decode_ms_per_step": decode_s / steps * 1e3 if steps else 0.0,
               "decode_tokens_per_s": B * steps / decode_s if steps else 0.0,
               "tokens_per_s": B * steps / (t2 - t0)}
    return ServeResult(proposals, granted, admitted, prompts, generated,
                       kept, logits_finite, timings)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the Hopper kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, requests=args.requests, steps=args.steps,
                prompt_len=args.prompt_len, page_size=args.page_size,
                n_pages=args.n_pages, device=args.device)
    print(f"admitted {len(res.admitted)}/{args.requests} requests "
          f"(atomic page-group grants, zero partial allocations)")
    if len(res.admitted) == 0:
        return
    print(f"generated {res.generated.shape} tokens for {len(res.admitted)} "
          f"admitted requests; sample row: {res.generated[0][:8].tolist()}")


if __name__ == "__main__":
    main()
