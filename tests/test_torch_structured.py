"""Grammar-constrained decoding in the port: the compiler, the device
tables, the mask, and the engine's constrained draws.

- The port's regex compiler against Python ``re`` on the JAX test's
  patterns, and against JAX ``compile_token_dfa`` table for table
  (``next``, ``dist_next``, ``terminal``, ``accept``) and byte for byte in
  the pool's padded slot layout (the crc and the device digest agree);
- :func:`grammar_allowed` against JAX ``CausalLM.grammar_allowed`` on the
  same tables and random states, budgets and counters (the budget-empty
  fallback included);
- the first token of a constrained request is masked on every path that
  draws one (insert, chunked prefill, the pipelined loop, a replay), on a
  vocabulary where the unmasked greedy token is outside the grammar;
- the pools write in place and their acquire-time checks catch a garbled
  slot (adapter crc32, grammar device digest), repairing it before the pin;
- submit validation, the grammar pool's ``grammar_pool_exhausted`` shed,
  and a decode block with grammars active stays one replay and one fetch.

Tiny model: 2 layers, hidden 32, vocab 128 (``default_token_table``), fp32.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import grammar as jg
from neuronx_distributed_tpu_torch.inference import grammar as tg
from neuronx_distributed_tpu_torch.inference.adapters import AdapterPool
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
K = 4
TABLE = tg.default_token_table(128)
JSON_SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"},
                                                "ok": {"type": "boolean"}}}
WIDE_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "n": {"type": "number"},
    "tags": {"type": "array", "items": {"type": "integer"}, "maxItems": 3},
    "kind": {"enum": ["a", "bc"]}, "none": {"type": "null"}}}
RE_CASES = [
    ("(ab|cd)+", ["ab", "abcd", "cdab"], ["a", "abc", ""]),
    ("x{2,4}", ["xx", "xxxx"], ["x", "xxxxx"]),
    ("x{2,}", ["xx", "xxxxx"], ["x"]),
    ("[^0-9]{2}", ["ab", "!?"], ["a1", "a"]),
    ("a?b+c", ["bc", "abbc"], ["ac", "ab"]),
    ("\\d+(\\.\\d+)?", ["12", "3.14"], [".5", "1."]),
    ("[a-c]*z", ["z", "abcz"], ["abz2", "d"]),
    ("(get|set)\\(\"[a-z]{1,3}\"\\)", ['get("ab")'], ["get(ab)"]),
]
PATTERNS = [c[0] for c in RE_CASES] + ["-?[0-9]{1,3}", "a[ab]*b", "[a-z]{1,8}@[a-z]{1,8}\\.com",
                                       "json", "wide_json"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lms():
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    sd = tl.init_params(cfg, torch.Generator().manual_seed(0))

    def port(**kw):
        return CausalLM(cfg, sd, tl.LlamaForCausalLM, buckets=(8, 16), max_batch=3,
                        device="cpu", **kw)

    return {"grammar": port(grammar_slots=3, grammar_states=48),
            "paged": port(grammar_slots=3, grammar_states=48, page_size=4),
            "plain": port(), "lora": port(lora_rank=4, lora_slots=3), "sd": sd}


def _compile(mod, pattern, table=TABLE):
    schema = {"json": JSON_SCHEMA, "wide_json": WIDE_SCHEMA}.get(pattern)
    return mod.compile_token_dfa("" if schema else pattern, table, json_schema=schema)


@pytest.mark.parametrize("pat,goods,bads", RE_CASES)
def test_regex_compiler_matches_python_re(pat, goods, bads):
    g = _compile(tg, pat)

    def walk(text):
        s = 0
        for ch in text:
            s = g.walk(s, TABLE.index(ch))
            if s < 0:
                return False
        return bool(g.accept[s])

    for t in goods:
        assert walk(t) and re.fullmatch(pat, t), (pat, t)
    for t in bads:
        assert not walk(t) and not re.fullmatch(pat, t), (pat, t)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_equal_jax_table_for_table(pattern):
    mine, ref = _compile(tg, pattern), _compile(jg, pattern)
    for key in ("next", "dist_next", "terminal", "accept", "mask", "dist"):
        assert np.array_equal(getattr(mine, key), getattr(ref, key)), key
    assert (mine.min_tokens, mine.n_states) == (ref.min_tokens, ref.n_states)
    pool, jpool = tg.GrammarPool(2, 80, TABLE), jg.GrammarPool(2, 80, TABLE)
    spec = ({"json_schema": {"json": JSON_SCHEMA, "wide_json": WIDE_SCHEMA}[pattern]}
            if "json" in pattern else {"regex": pattern})
    pool.register("g", **spec)
    jpool.register("g", **spec)
    mine_e, ref_e = pool._registry["g"], jpool._registry["g"]
    assert mine_e["crc"] == ref_e["crc"] and mine_e["digest"] == ref_e["digest"]
    pool.acquire("g")
    assert pool._device_digest(1) == ref_e["digest"]


def test_compile_errors_and_schema_lowering():
    for pat in ("[z", "(a", "a{3,1}", "*a", "a|)", "a{0}", "é+"):
        with pytest.raises(tg.GrammarCompileError):
            tg.compile_token_dfa(pat, TABLE)
    with pytest.raises(tg.GrammarCompileError):
        tg.json_schema_to_regex({"type": "object", "properties": {"x": {"type": "tuple"}}})
    assert tg.json_schema_to_regex(WIDE_SCHEMA) == jg.json_schema_to_regex(WIDE_SCHEMA)
    g = _compile(tg, "wide_json")
    s, out = 0, []
    for k in range(64):
        row = g.allowed_row(s, 64 - k - 1)
        v = int(np.argmax(row))
        out.append(v)
        s = g.walk(s, v)
        if g.terminal[s]:
            break
    assert set(json.loads(tg.detokenize(out, TABLE))) == {"name", "n", "tags", "kind", "none"}


def test_grammar_allowed_equals_jax():
    pool = tg.GrammarPool(4, 48, TABLE)
    for name, pat in (("g1", "-?[0-9]{1,3}"), ("g2", "a[ab]*b"), ("g3", "json")):
        pool.register(name, **({"json_schema": JSON_SCHEMA} if pat == "json" else {"regex": pat}))
        pool.acquire(name)
    rng = np.random.default_rng(0)
    b = 64
    gidx = rng.integers(0, 4, b).astype(np.int32)
    gstate = rng.integers(0, 27, b).astype(np.int32)
    budget = rng.integers(0, 30, b).astype(np.int32)
    counts = rng.integers(0, 30, b).astype(np.int32)
    got = tg.grammar_allowed(pool.tables, *(torch.as_tensor(a) for a in (gidx, gstate, budget,
                                                                        counts)))
    tree = {k: jnp.asarray(v.numpy()) for k, v in pool.tables.items()}
    want = JaxLM.grammar_allowed(tree, *(jnp.asarray(a) for a in (gidx, gstate, budget, counts)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[gidx == 0].all()
    assert not got.all(-1).all()


def _unmasked_first(lms, prompt, generated=()):
    """The greedy token after ``prompt + generated`` with no grammar."""
    eng = ServeEngine(lms["plain"], block_steps=K, seed=1)
    eng.submit(np.concatenate([prompt, np.asarray(generated, np.int32)]), 1)
    return int(eng.run()[0].tokens[0])


@pytest.mark.parametrize("path", ["insert", "chunked", "async", "replay"])
def test_first_draw_is_masked(lms, path):
    """The grammar allows one token where the unmasked greedy draw is
    another: the stream takes the allowed token (and ends on it,
    accept-terminal) on every path that draws a first token. The replay
    resumes a restored stream at its second token."""
    prompt = np.random.default_rng(4).integers(1, 127, (12,)).astype(np.int32)
    u = _unmasked_first(lms, prompt)
    c = next(ch for ch in "qzxjkv" if TABLE.index(ch) != u)
    regex, generated = c, ()
    if path == "replay":
        u2 = _unmasked_first(lms, prompt, [TABLE.index(c)])
        d = next(ch for ch in "0123" if TABLE.index(ch) != u2)
        regex, generated = c + d, (TABLE.index(c),)
    kw = dict(prefill_chunk_tokens=4) if path == "chunked" else {}
    eng = ServeEngine(lms["paged"], block_steps=K, seed=1, async_loop=path == "async", **kw)
    eng.register_grammar("one", regex=regex)
    rid = eng.submit(prompt, 4, grammar="one")
    if path == "replay":
        snap = eng.snapshot()
        snap["requests"][0].update(state="decoding", generated=list(generated))
        eng = ServeEngine.from_snapshot(lms["paged"], snap, grammars={"one": {"regex": regex}})
    comp = {c_.request_id: c_ for c_ in eng.run()}[rid]
    assert tg.detokenize(comp.tokens, TABLE) == regex
    assert comp.finish_reason == "grammar_accept" and comp.grammar == "one"
    if path == "chunked":
        assert eng.chunk_program_calls == 3


def test_pools_write_in_place_and_catch_a_garbled_slot(lms):
    lm = lms["lora"]
    session = lm.start_session()
    pool, ptr = session.adapters, lm.model.model.lora_pool.data_ptr()
    cfg = LoraConfig(r=2, lora_alpha=4.0)
    ad = init_lora(lms["sd"], cfg, torch.Generator().manual_seed(3))
    for v in ad.values():
        v["lora_b"].normal_(generator=torch.Generator().manual_seed(4))
    pool.register("a", ad, cfg)
    slot = pool.acquire("a")
    assert pool._intact(slot, pool._registry["a"])
    pool._garble_slot(slot)
    assert not pool._intact(slot, pool._registry["a"])
    pool.release("a")
    pool.fault_hook = lambda: "corrupt"
    assert pool.acquire("a") == slot and pool.repairs == 1 and pool.garbled == 1
    assert pool._intact(slot, pool._registry["a"])
    assert lm.model.model.lora_pool.data_ptr() == ptr
    assert pool.adapter_bytes() == (lm.model.model.lora_pool.numel() // 3) * 4
    gpool = tg.GrammarPool(3, 48, TABLE)
    tables = {k: t.data_ptr() for k, t in gpool.tables.items()}
    gpool.register("g", regex="a[ab]*b")
    gpool.fault_hook = lambda: "corrupt"
    gslot = gpool.acquire("g")
    assert gpool.repairs == 1 and gpool._intact(gslot, gpool._registry["g"])
    gpool._garble_slot(gslot)
    assert not gpool._intact(gslot, gpool._registry["g"])
    assert {k: t.data_ptr() for k, t in gpool.tables.items()} == tables
    assert gpool.grammar_bytes() == 48 * 128 * 8 + 48


def test_submit_validation(lms):
    eng = ServeEngine(lms["grammar"], block_steps=K)
    eng.register_grammar("gjson", json_schema=JSON_SCHEMA)
    p = np.arange(1, 9, dtype=np.int32)
    with pytest.raises(ValueError, match="unknown grammar"):
        eng.submit(p, 8, grammar="nope")
    with pytest.raises(ValueError, match="could never parse"):
        eng.submit(p, 3, grammar="gjson")
    with pytest.raises(tg.GrammarCompileError):
        eng.register_grammar("bad", regex="[z")
    with pytest.raises(ValueError, match="exactly one"):
        eng.register_grammar("both", regex="a", json_schema={})
    with pytest.raises(ValueError, match="lora_rank"):
        eng.submit(p, 8, adapter="a0")
    lora = ServeEngine(lms["lora"], block_steps=K)
    with pytest.raises(ValueError, match="unknown adapter"):
        lora.submit(p, 8, adapter="a0")
    with pytest.raises(ValueError, match="grammar_slots"):
        lora.submit(p, 8, grammar="gjson")
    with pytest.raises(ValueError, match="lora_slots"):
        CausalLM(lms["grammar"].config, lms["sd"], tl.LlamaForCausalLM, max_batch=2,
                 lora_rank=4, lora_slots=1, device="cpu")
    with pytest.raises(ValueError, match="grammar_tokens"):
        CausalLM(lms["grammar"].config, lms["sd"], tl.LlamaForCausalLM, max_batch=2,
                 grammar_slots=2, grammar_tokens=TABLE[:5], device="cpu")


def test_grammar_pool_exhausted_and_host_ops(lms):
    """Two usable slots pinned by live constrained streams: the third
    grammar's admission is shed with ``grammar_pool_exhausted`` and a
    retry-after; every decode block with grammars active is one replay and
    one fetch, plus one copy when a slot changed."""
    eng = ServeEngine(lms["grammar"], block_steps=K, seed=1)
    for name, spec in (("gnum", {"regex": "-?[0-9]{1,3}"}), ("gab", {"regex": "a[ab]*b"}),
                       ("gjson", {"json_schema": JSON_SCHEMA})):
        eng.register_grammar(name, **spec)
    p = np.random.default_rng(5).integers(1, 127, (3, 8)).astype(np.int32)
    for i, g in enumerate(("gab", "gjson", "gnum")):
        eng.submit(p[i], 24, grammar=g)
    ops = []
    while True:
        before = (eng.replays, eng.host_fetches, eng.h2d_copies, eng.decode_blocks)
        more = eng.step_block()
        if eng.decode_blocks > before[3]:
            ops.append(tuple(a - b for a, b in zip((eng.replays, eng.host_fetches,
                                                    eng.h2d_copies), before)))
        if not more:
            break
    assert len(eng.completed) == 2 and eng.grammar_rejects == 1
    rej = eng.rejected[0]
    assert rej.reason == "grammar_pool_exhausted" and rej.retry_after_blocks >= 1
    assert all(o[:2] == (1, 1) and o[2] <= 1 for o in ops) and (1, 1, 0) in ops
    assert all(c.finish_reason in ("grammar_accept", "budget") for c in eng.completed)
