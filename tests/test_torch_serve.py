"""The port's serving launcher on the CPU against the JAX reference.

``repro_torch.launch.serve.serve(..., device="cpu")`` runs the plain
PyTorch versions of both kernels (``reserve_slots`` for the KV-page
grants, flash attention for ``attn_impl="pallas"``).  It is held against
the reference launcher's own steps (``repro/launch/serve.py:59-87``:
the same numpy draws, ``prefill`` and greedy ``decode_step``) with the
defaults of ``examples/serve_batched.py``, weights carried across with
``params_from_numpy``.  In float32 compute the admitted set and every
generated token must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import PageAllocator as JaxPageAllocator
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch.serve import PageAllocator, main, propose_pages, serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.pmwcas import pmwcas_apply_cuda

# examples/serve_batched.py: --arch llama3-8b --smoke --requests 16
# --steps 8, and the launcher's defaults for the rest
DEFAULTS = dict(requests=16, steps=8, prompt_len=16, page_size=16,
                n_pages=64)


def _jax_launcher(cfg, requests, steps, prompt_len, page_size, n_pages):
    """The reference launcher's main(), returning what it computes."""
    model = jax_build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    alloc = JaxPageAllocator(n_pages)
    rng = np.random.default_rng(0)
    pages_per_req = -(-(prompt_len + steps) // page_size)
    reqs = np.full((requests, pages_per_req), -1, np.int32)
    cursor = 0
    for i in range(requests):
        reqs[i] = np.arange(cursor, cursor + pages_per_req) % n_pages
        cursor += rng.integers(1, pages_per_req + 1)
    admitted = np.nonzero(alloc.admit(reqs))[0]
    B = len(admitted)
    total = prompt_len + steps
    tokens = rng.integers(0, cfg.vocab, (B, prompt_len)).astype(np.int32)
    cache = model.init_cache(B, total)
    logits, cache = jax.jit(model.prefill)(params, jnp.asarray(tokens), cache)
    decode = jax.jit(model.decode_step)
    out, all_logits = [], [np.asarray(logits)]
    for _ in range(steps):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(nxt))
        logits, cache = decode(params, nxt, cache)
        all_logits.append(np.asarray(logits))
    return (params, reqs, admitted, tokens, np.concatenate(out, axis=1),
            all_logits)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_serve_matches_jax_launcher(impl):
    jcfg = dataclasses.replace(jax_config("llama3-8b", smoke=True),
                               dtype="float32")
    pcfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                               dtype="float32", attn_impl=impl)
    params, reqs, admitted, prompts, gen, logits = _jax_launcher(
        jcfg, **DEFAULTS)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              pcfg, device="cpu")
    before = (flash_attention_cuda.launches, pmwcas_apply_cuda.launches)
    res = serve(pcfg, **DEFAULTS, device="cpu", model=model,
                keep_logits=True)
    assert (flash_attention_cuda.launches,
            pmwcas_apply_cuda.launches) == before   # the CPU never launches
    assert len(admitted) == 10
    np.testing.assert_array_equal(res.proposals, reqs)
    np.testing.assert_array_equal(res.admitted, admitted)
    np.testing.assert_array_equal(res.prompts, prompts)
    np.testing.assert_array_equal(res.generated, gen)
    assert res.logits_finite and len(res.logits) == DEFAULTS["steps"] + 1
    for got, want in zip(res.logits, logits):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    assert set(res.timings) == {"prefill_s", "decode_s",
                                "decode_ms_per_step", "decode_tokens_per_s",
                                "tokens_per_s"}


def test_serve_draws_are_seeded():
    cfg = get_config("llama3-8b", smoke=True)
    kw = dict(requests=6, steps=3, prompt_len=8, page_size=4, n_pages=32,
              device="cpu")
    a, b = serve(cfg, **kw), serve(cfg, **kw)
    np.testing.assert_array_equal(a.generated, b.generated)
    c = serve(cfg, **kw, seed=1)
    assert not np.array_equal(a.prompts, c.prompts)
    assert a.generated.shape == (len(a.admitted), 3) and a.logits == []


def test_serve_with_nothing_admitted():
    cfg = get_config("llama3-8b", smoke=True)
    res = serve(cfg, requests=0, steps=2, prompt_len=4, page_size=2,
                n_pages=16, device="cpu")
    assert len(res.admitted) == 0 and res.generated is None


def test_page_allocator_matches_reference_and_releases_in_place():
    rng = np.random.default_rng(3)
    reqs = propose_pages(20, 3, 24, rng)
    mine, theirs = PageAllocator(24, device="cpu"), JaxPageAllocator(24)
    free = mine.free
    np.testing.assert_array_equal(mine.admit(reqs), theirs.admit(reqs))
    assert mine.free is free
    np.testing.assert_array_equal(mine.free.numpy(),
                                  np.asarray(theirs.free).astype(np.int32))
    mine.release(reqs[:2].ravel())
    theirs.release(reqs[:2].ravel())
    assert mine.free is free
    np.testing.assert_array_equal(mine.free.numpy(),
                                  np.asarray(theirs.free).astype(np.int32))
    assert mine.free.dtype == torch.int32


def test_cli_runs_on_cpu(capsys):
    main(["--smoke", "--device", "cpu", "--requests", "4", "--steps", "2",
          "--prompt-len", "4", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "admitted" in out and "generated (" in out


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve(get_config("llama3-8b", smoke=True), requests=1, steps=1,
              prompt_len=2, page_size=2, n_pages=4)
