"""int8 KV pages written by the port's decode step, against the JAX package.

Both packages get the same weights (``llama_params_from_jax``) and serve
the same prompts with ``page_dtype="int8"`` and the paged kernel (the
Pallas kernel in interpret mode on the JAX side, the twin here). Each write
dequantizes, modifies and requantizes the pages it touches (absmax per page
and kv head).

Tolerances: logits atol 2e-3 — the two sides quantize K/V values a few fp32
places apart, so an element may round to the neighbouring int8 step (one
step of a page's scale; the readings stay near 1e-4); pools within one
int8 step, scales rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LOGITS_ATOL = 2e-3
SCALE_RTOL = 1e-5


def test_int8_decode_matches_jax_across_a_page_boundary():
    """Insert two prompts (lengths 7 and 12, page size 4) and decode six
    steps, crossing page boundaries at 8 and 16: logits close to JAX's
    every step, pools within one int8 step, scales close, and the port's
    pools half the bytes of bf16 plus the scales."""
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    kw = dict(buckets=(8, 16), max_batch=3, page_size=4, page_dtype="int8",
              paged_attn_kernel=True)
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, **kw).compile()
    tlm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw)
    jses, tses = jlm.start_session(), tlm.start_session()
    prompts = np.random.default_rng(0).integers(1, 127, (2, 12)).astype(np.int32)
    lengths = np.array([12, 7])
    slots = np.array([0, 2])
    a = np.asarray(jlm.insert(jses, slots, prompts, lengths=lengths))
    b = tlm.insert(tses, slots, prompts, lengths=lengths).numpy()
    worst = float(np.abs(b - a).max())
    tok = np.zeros(3, np.int32)
    tok[slots] = a.argmax(-1)
    for _ in range(6):
        a = np.asarray(jlm.step(jses, tok))
        b = tlm.step(tses, tok).numpy()
        worst = max(worst, float(np.abs(b - a).max()))
        tok = a.argmax(-1).astype(np.int32)
    assert worst <= LOGITS_ATOL, worst
    att = jses.cache["model"]["layers"]["block"]["attention"]
    n = tlm.config.page_pool_pages          # the port's sink page is its own
    live = sorted({int(p) for p in tses.paged.tables[slots].flatten()})
    for name, pools in (("cached_key", tses.cache.keys), ("cached_value", tses.cache.values),
                        ("cached_key_scale", tses.cache.k_scales),
                        ("cached_value_scale", tses.cache.v_scales)):
        got = np.stack([t[:n].numpy() for t in pools])[:, live]
        want = np.asarray(att[name])[:, live]
        if got.dtype == np.int8:
            assert int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, err_msg=name)
    bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    half = CausalLM(bf16, sd, tl.LlamaForCausalLM, device="cpu", **{**kw, "page_dtype": None})
    pages = tlm.config.page_pool_pages + 1
    scales = 2 * tcfg.num_layers * pages * tcfg.num_kv_heads * 4
    assert tlm.kv_cache_bytes() == half.kv_cache_bytes() // 2 + scales


def test_window_write_leaves_a_neighbour_rows_pages_alone():
    """Regression pin for the int8 window write, whose blind write-back of
    the whole window once corrupted a neighbour in the JAX package: row 1's
    table names row 0's live page past its own first page, as a
    zero-filled table does. A one-token write of row 1 dequantizes and
    requantizes a two-page window that includes that entry; only the
    touched page is written back, so row 0's pages and scales keep every
    bit."""
    cfg = tl.LlamaConfig(**{**TINY, "max_seq_len": 16}, dtype=torch.float32, decode=True,
                         page_size=4, page_pool_pages=8, page_dtype="int8")
    with torch.device("meta"):
        model = tl.LlamaForCausalLM(cfg)
    model.load_state_dict(tl.init_params(cfg, torch.Generator().manual_seed(1)), assign=True)
    cache = model.new_cache(2)
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, 127, (1, 8)).astype(np.int32))
    with torch.no_grad():
        model(ids, cache.rows(torch.zeros(1, dtype=torch.int32),
                              torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)))
    row0 = [t[:4].clone() for t in cache.keys + cache.values + cache.k_scales + cache.v_scales]
    assert all(float(t[:2].abs().max()) > 0 for t in row0)
    table1 = torch.tensor([[4, 0, 0, 0]], dtype=torch.int32)   # entries past page 4 name row 0's
    with torch.no_grad():
        model(torch.tensor([[5]], dtype=torch.int32),
              cache.rows(torch.tensor([2], dtype=torch.int32), table1))
    after = [t[:4] for t in cache.keys + cache.values + cache.k_scales + cache.v_scales]
    assert all(torch.equal(a, b) for a, b in zip(after, row0))
    assert all(float(t[4].abs().max()) > 0 for t in cache.keys + cache.values)
