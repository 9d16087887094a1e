"""The durable park tier in the port: ``checkpoint/storage.py``,
``inference/conversation_tier.py`` and the engine's park, resume and
degradation ladder, held against the JAX package.

- The store (``tests/test_conversation_tier.py:159-255`` on the port): the
  round trip, a state-only park, a torn park quarantined with its state
  recoverable, corrupt bytes quarantined, a read fault that leaves the
  record, the sweep, a re-park; the park seam of the port's fault injector
  draws JAX's verdicts for the same plan.
- The engine (``:259-455``): parking needs a paged pool; a park leaves 0
  device and 0 host-tier pages; park then resume gives the never-parked
  streams over greedy, sampled, grammar and adapter requests, fused and
  stepwise; a fresh engine over the same store resumes them; each fault
  rung (state-only, read fault, corrupt) replays to the cold streams; a
  second resume is refused; the idle sweep parks by itself. Each
  scenario also runs on the JAX engine (greedy requests): the same
  streams, the same park counters and the same event names.
- The pipelined loop's idle sweep drains the block in flight and retires
  what the drain finished (streams that end on EOS: the synchronous
  loop's streams, none past its EOS).
- A child process that imports only the port is SIGKILLed between its
  manifest and its done marker: the sweep quarantines the torn park, the
  clean one resumes exactly and the torn one replays from its verified
  state.
- Across the frameworks: a conversation the JAX engine parked resumes
  exactly in the port from the same directory, and one the port parked in
  JAX, for fp32 pages and for int8 pages with scales; a bf16 page frames
  as ``bfloat16`` and keeps its bits both ways; the port writes JAX's leaf
  paths; a snapshot's ``parked`` section restores in either engine;
  ``run_trace`` reports JAX's park keys with JAX's values.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, K = 4, fp32, one
intra-op thread.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference import conversation_tier as jct
from neuronx_distributed_tpu.inference.engine import run_trace as jax_run_trace
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.inference.faults import FaultInjector as JaxInjector
from neuronx_distributed_tpu.inference.faults import FaultPlan as JaxPlan
from neuronx_distributed_tpu.lora import core as jlora
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.checkpoint import storage as tstorage
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    lora_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference import conversation_tier as tct
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import Rejected, ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.faults import FaultInjector, FaultPlan
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.lora import LoraConfig
from neuronx_distributed_tpu_torch.models import llama as tl

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3, page_size=4)
TENANCY = dict(lora_rank=4, lora_slots=3, grammar_slots=3, grammar_states=48)
K = 4
PAGE = 4
JCFG = jlora.LoraConfig(r=4, lora_alpha=8.0)
TCFG = LoraConfig(r=4, lora_alpha=8.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    """One paged port lm with adapter and grammar pools (identity slots keep
    plain requests base-exact) and its JAX twin, plus plain fp32 and int8
    pools on both sides for the cross-framework parks."""
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    sd = llama_params_from_jax(params)
    ad = jlora.init_lora(params, JCFG, jax.random.key(10))
    jad = {k: {"lora_a": np.asarray(v["lora_a"]),
               "lora_b": np.asarray(0.05 * jax.random.normal(
                   jax.random.fold_in(jax.random.key(20), j), v["lora_b"].shape))}
           for j, (k, v) in enumerate(sorted(ad.items()))}

    def port(**kw):
        return CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    def jax_lm(**kw):
        return JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM, **kw).compile()

    return {"lm": port(**TENANCY), "jax": jax_lm(**TENANCY), "fp32": port(),
            "jax_fp32": jax_lm(), "int8": port(page_dtype="int8"),
            "jax_int8": jax_lm(page_dtype="int8"), "jad": jad,
            "tad": lora_params_from_jax(jad, TCFG), "tcfg": tcfg}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


P = _prompts(4)
# greedy, sampled, grammar-constrained and adapter requests in one pool
# (the third queues behind a slot until it arrives)
MATRIX = [dict(prompt=P[0], max_new_tokens=12, adapter="a0"),
          dict(prompt=P[1], max_new_tokens=10, grammar="gab", sampler=Sampler(temperature=1.3)),
          dict(prompt=P[2], max_new_tokens=8, arrival_block=1, sampler=Sampler(temperature=0.8))]
# the matrix's greedy counterpart, whose streams the two frameworks share
GREEDY = [dict(prompt=P[0], max_new_tokens=12, adapter="a0"),
          dict(prompt=P[1], max_new_tokens=10, grammar="gab"),
          dict(prompt=P[2], max_new_tokens=8, arrival_block=1)]


def _engine(stack, key="lm", jax_side=False, **kw):
    if jax_side:
        if "faults" in kw and kw["faults"] is not None:
            kw["faults"] = JaxPlan(**kw["faults"].to_dict())
        eng = JaxEngine(stack["jax" if key == "lm" else f"jax_{key}"], block_steps=K,
                        rng=jax.random.key(42), **kw)
    else:
        eng = ServeEngine(stack[key], block_steps=K, seed=42, **kw)
    if key == "lm":
        eng.register_adapter("a0", stack["jad" if jax_side else "tad"],
                             JCFG if jax_side else TCFG)
        eng.register_grammar("gab", regex="a[ab]*b")
    return eng


def _submit(eng, submits, jax_side=False):
    for s in submits:
        s = dict(s)
        if jax_side and "sampler" in s:
            from neuronx_distributed_tpu.inference import Sampler as JaxSampler

            s["sampler"] = JaxSampler(temperature=s["sampler"].temperature)
        eng.submit(**s)


def _streams(eng):
    return {c.request_id: c.tokens.tolist() for c in eng.completed}


def _oracle(stack, submits, key="lm", **kw):
    eng = _engine(stack, key, **kw)
    _submit(eng, submits)
    eng.run()
    return _streams(eng)


def _active(eng):
    return sorted(r.request_id for s, r in enumerate(eng.slots)
                  if r is not None and not eng._done[s])


def _names(eng):
    """Event names by lane: every request lane together under ``"req"``,
    the others by (group, track)."""
    out = {}
    for ev in eng.tracer.events():
        lane = ev["lane"]
        out.setdefault("req" if lane[0] == "req" else tuple(lane), set()).add(ev["name"])
    return out


def _park_counts(eng, jax_side):
    keys = ("parked", "resumed", "park_replays", "park_rejects")
    return {k: (eng.stats[k] if jax_side else getattr(eng, k)) for k in keys}


# --- the store --------------------------------------------------------------------


def _payload(i):
    rng = np.random.default_rng(100 + i)
    return {f"layer{layer}/{kv}": rng.standard_normal((2, PAGE, 2, 4)).astype(np.float32)
            for layer in range(2) for kv in ("k", "v")}


_STATE0 = {"prompt": [5, 6, 7], "generated": [9, 11], "length": 4, "parked_block": 3,
           "rng_key": [1, 2]}


def test_store_roundtrip_and_remove(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    pays = [_payload(0), _payload(1)]
    mid, verdict = store.park(7, _STATE0, pays, tp_degree=2, page_dtype="int8")
    assert verdict is None and store.contains(7) and store.list_parked() == [7]
    assert store.parked_bytes(7) > 0
    back = store.load(7)
    assert (back.request_id, back.manifest_id, back.state) == (7, mid, _STATE0)
    assert (back.tp_degree, back.page_dtype, len(back.payloads)) == (2, "int8", 2)
    for got, want in zip(back.payloads, pays):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert all(v >= 0 for v in store.host_ms.values()) and store.host_ms["park_io"] > 0
    store.remove(7)
    assert not store.contains(7) and store.list_parked() == []


def test_store_state_only_park(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    store.park(3, _STATE0, None)
    back = store.load(3)
    assert back.payloads is None and back.state == _STATE0
    assert store.manifest(3)["state_only"] is True


def test_store_torn_park_quarantined_state_recoverable(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    store.write_fault_hook = lambda: "torn"
    assert store.park(4, _STATE0, [_payload(0)])[1] == "torn"
    assert not store.contains(4) and store.list_parked() == []
    with pytest.raises(tct.ParkIntegrityError):
        store.load(4)
    assert store.stats["quarantined"] == 1
    with pytest.raises(tct.ParkIntegrityError):   # quarantine is sticky
        store.load(4)
    assert store.recover_state(4) == _STATE0


def test_store_corrupt_bytes_quarantined(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    store.park(5, _STATE0, [_payload(0)])
    store.read_fault_hook = lambda: "corrupt"
    with pytest.raises(tct.ParkIntegrityError):
        store.load(5)
    assert store.stats["quarantined"] == 1
    store.read_fault_hook = None
    with pytest.raises(tct.ParkIntegrityError):
        store.load(5)


def test_store_read_fault_leaves_record_intact(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    store.park(6, _STATE0, [_payload(0)])
    store.read_fault_hook = lambda: "fail"
    with pytest.raises(tct.ParkReadFailed):
        store.load(6)
    assert store.stats["quarantined"] == 0 and store.contains(6)
    store.read_fault_hook = None
    assert store.load(6).state == _STATE0


def test_store_sweep_quarantines_torn(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    store.park(1, _STATE0, [_payload(0)])
    store.write_fault_hook = lambda: "torn"
    store.park(2, _STATE0, [_payload(1)])
    store.write_fault_hook = None
    assert store.sweep() == ([1], [2])
    assert store.sweep() == ([1], [])
    assert store.load(1).state == _STATE0


def test_store_repark_replaces_previous_generation(tmp_path):
    store = tct.ConversationParkStore(str(tmp_path / "park"))
    store.park(9, _STATE0, [_payload(0), _payload(1)])
    st2 = dict(_STATE0, generated=[9, 11, 13], length=5)
    store.park(9, st2, [_payload(2)])
    back = store.load(9)
    assert back.state == st2 and len(back.payloads) == 1


def test_stores_read_each_others_directories(tmp_path):
    """A park written by either package's store loads in the other with the
    same state, pages, stamps and byte count (the same framing)."""
    pays = [_payload(0), _payload(1)]
    for writer, reader in ((tct, jct), (jct, tct)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        writer.ConversationParkStore(d).park(4, _STATE0, pays, tp_degree=1, page_dtype="float32")
        a, b = writer.ConversationParkStore(d), reader.ConversationParkStore(d)
        assert a.parked_bytes(4) == b.parked_bytes(4) and b.list_parked() == [4]
        back = b.load(4)
        assert back.state == _STATE0 and back.page_dtype == "float32"
        for got, want in zip(back.payloads, pays):
            assert all(np.array_equal(got[k], want[k]) for k in want)


def test_park_fault_plan_draws_jax_verdicts():
    """``:237``: the park seam draws from its own named stream, so a plan
    replayed gives the same write and read verdicts, and the port's
    injector draws the JAX injector's."""
    knobs = dict(seed=5, park_write_fail_prob=0.5, park_read_fail_prob=0.25,
                 park_corrupt_prob=0.25)
    runs = []
    for inj in (FaultInjector(FaultPlan(**knobs)), FaultInjector(FaultPlan(**knobs)),
                JaxInjector(JaxPlan(**knobs))):
        runs.append(([inj.on_park_write() for _ in range(24)],
                     [inj.on_park_read() for _ in range(24)]))
    assert runs[0] == runs[1] == runs[2]
    writes, reads = runs[0]
    assert {"fail", "torn"} <= set(writes) and None in writes
    assert {"fail", "corrupt"} <= set(reads) and None in reads


def test_storage_filesystem_atomic_and_object_store_refused(tmp_path, monkeypatch):
    """The filesystem storage writes through a temporary file and a rename
    (nothing ``.tmp`` is left); an object-store URL raises and names the
    roadmap item, never falling back to a local path; ``_retry`` reads its
    attempts from ``NXD_STORAGE_RETRIES``."""
    st = tstorage.create_checkpoint_storage(str(tmp_path / "ck"))
    assert isinstance(st, tstorage.FilesysCheckpointStorage)
    st.save_bytes(b"abc", "d/x.bin")
    st.save_text("done", "d/done")
    assert st.read_bytes("d/x.bin") == b"abc" and st.load_text("d/done") == "done"
    assert st.list_files() == ["d/done", "d/x.bin"] and st.list_dirs() == ["d"]
    st.remove_dir("d")
    assert not st.dir_exists("d")
    with pytest.raises(ValueError, match="A9"):
        tstorage.create_checkpoint_storage("gs://bucket/park")
    assert not os.path.exists("gs:")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("throttled")
        return "ok"

    monkeypatch.setenv("NXD_STORAGE_RETRIES", "3")
    monkeypatch.setenv("NXD_STORAGE_RETRY_BASE_S", "0")
    assert tstorage._retry(flaky) == "ok" and len(calls) == 3
    calls.clear()
    monkeypatch.setenv("NXD_STORAGE_RETRIES", "2")
    with pytest.raises(OSError):
        tstorage._retry(flaky)
    with pytest.raises(ValueError, match="attempts"):
        tstorage._retry(flaky, attempts=0)


# --- the engine ---------------------------------------------------------------------


def test_park_requires_paged_lm(stack, tmp_path):
    tcfg = stack["tcfg"]
    slab = CausalLM(tcfg, {k: v for k, v in stack["fp32"].model.state_dict().items()},
                    tl.LlamaForCausalLM, device="cpu", buckets=(8, 16), max_batch=3)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(slab, block_steps=K, park_dir=str(tmp_path / "never"))
    with pytest.raises(ValueError, match="OR"):
        ServeEngine(stack["fp32"], park_dir=str(tmp_path / "a"),
                    park_store=tct.ConversationParkStore(str(tmp_path / "b")))
    with pytest.raises(ValueError, match="durable"):
        ServeEngine(stack["fp32"], park_idle_blocks=2)
    with pytest.raises(ValueError, match=">= 0"):
        ServeEngine(stack["fp32"], park_idle_blocks=-1)
    sim = SimCausalLM(max_batch=2, buckets=(8,), page_size=4, page_pool_pages=16)
    with pytest.raises(ValueError, match="sim engines"):
        ServeEngine(sim, block_steps=K, park_dir=str(tmp_path / "s"))
    eng = ServeEngine(stack["fp32"], block_steps=K)
    with pytest.raises(ValueError, match="park_dir"):
        eng.park(0)
    with pytest.raises(ValueError, match="no prompt"):
        eng.submit(P[0], 4, resume=0)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("jax_side", [False, True], ids=["port", "jax"])
def test_park_evicts_device_and_host_pages(stack, tmp_path, jax_side):
    """``:270``: after a park the conversation holds no device page and no
    host-tier page; its one copy is durable, and the load card counts it."""
    eng = _engine(stack, jax_side=jax_side, park_dir=str(tmp_path / "park"), host_tier_pages=16)
    rid = eng.submit(P[0], 16)
    eng.step_block()
    eng.step_block()
    pkv = eng.session.paged
    assert pkv.allocator.in_use() > 0
    assert eng.park(rid) == "parked"
    assert pkv.allocator.in_use() == 0 and pkv.tier_pages() == 0
    assert all(r is None for r in eng.slots)
    assert _park_counts(eng, jax_side)["parked"] == 1
    assert eng.park_store.contains(rid) and eng.park_store.parked_bytes(rid) > 0
    assert eng.load_summary().parked == 1 and eng.parked_ids() == [rid]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_park_resume_exact_matrix(stack, tmp_path, fused):
    """``:293``: greedy, sampled, grammar and adapter streams park mid-decode,
    leave the device entirely, resume, and finish with the never-parked
    streams; the records are consumed."""
    oracle = _oracle(stack, MATRIX, fused=fused)
    eng = _engine(stack, fused=fused, park_dir=str(tmp_path / "park"))
    _submit(eng, MATRIX)
    eng.step_block()
    eng.step_block()
    rids = _active(eng)
    assert rids
    for rid in rids:
        assert eng.park(rid) == "parked"
    assert eng.session.paged.allocator.in_use() == 0
    for rid in rids:
        assert eng.submit(resume=rid) == rid
    eng.run()
    assert _streams(eng) == oracle
    assert eng.resumed == eng.parked == len(rids) and eng.park_replays == 0
    assert eng.park_store.list_parked() == []


def _park_scenario(stack, tmp_path, jax_side, submits, plan=None, name="park"):
    """Two rounds, park every live stream, resume each, drain: the streams,
    the park counters, the store's stats and the event names."""
    eng = _engine(stack, jax_side=jax_side, park_dir=str(tmp_path / f"{name}-{jax_side}"),
                  trace=True, faults=plan)
    _submit(eng, submits, jax_side)
    eng.step_block()
    eng.step_block()
    rids = _active(eng)
    for rid in rids:
        assert eng.park(rid) == "parked"
    for rid in rids:
        out = eng.submit(resume=rid)
        assert isinstance(out, int), out
    eng.run()
    names = _names(eng)
    return dict(streams=_streams(eng), counts=_park_counts(eng, jax_side), rids=rids,
                store=dict(eng.park_store.stats), names=names["req"],
                tier=names.get(("engine", "tier"), set()))


def test_park_resume_matches_jax(stack, tmp_path):
    """The JAX engine on the same greedy matrix: the same streams (equal to
    the never-parked run's), park counters, store stats and event names
    on the request lanes and the tier lane."""
    port = _park_scenario(stack, tmp_path, False, GREEDY)
    ref = _park_scenario(stack, tmp_path, True, GREEDY)
    assert port["streams"] == ref["streams"] == _oracle(stack, GREEDY)
    assert port["counts"] == ref["counts"] and port["store"] == ref["store"]
    assert port["names"] == ref["names"] and {"park", "resume"} <= port["names"]
    assert port["tier"] == ref["tier"] == {"tier:park", "tier:resume"}


def test_resume_after_restart_fresh_engine_same_store(stack, tmp_path):
    """``:324``: a fresh engine over only the park directory lists and
    resumes the old one's conversations exactly (page re-adoption)."""
    submits = [dict(prompt=P[0], max_new_tokens=12),
               dict(prompt=P[1], max_new_tokens=10, sampler=Sampler(temperature=0.9))]
    oracle = _oracle(stack, submits)
    old = _engine(stack, park_dir=str(tmp_path / "park"))
    _submit(old, submits)
    old.step_block()
    old.step_block()
    rids = _active(old)
    for rid in rids:
        old.park(rid)
    del old
    fresh = _engine(stack, park_dir=str(tmp_path / "park"))
    assert fresh.parked_ids() == rids
    for rid in rids:
        assert fresh.submit(resume=rid) == rid
    fresh.run()
    assert _streams(fresh) == {r: oracle[r] for r in rids}
    assert fresh.park_replays == 0 and fresh.resumed == len(rids)


PLANS = {"write_fail": dict(seed=3, park_write_fail_prob=1.0),
         "read_fail": dict(seed=3, park_read_fail_prob=1.0),
         "corrupt": dict(seed=3, park_corrupt_prob=1.0)}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_park_fault_degradations_cold_identical(stack, tmp_path, plan):
    """``:357``: every rung of the ladder replays to the cold streams
    (sampled, grammar and adapter included); with JAX on the greedy
    matrix the same degradations, store stats, injector stats and
    streams."""
    knobs = PLANS[plan]
    oracle = _oracle(stack, MATRIX)
    eng = _engine(stack, park_dir=str(tmp_path / "park"), faults=FaultPlan(**knobs))
    _submit(eng, MATRIX)
    eng.step_block()
    eng.step_block()
    rids = _active(eng)
    for rid in rids:
        assert eng.park(rid) == "parked"
    assert eng.session.paged.allocator.in_use() == 0
    for rid in rids:
        assert not isinstance(eng.submit(resume=rid), Rejected)
    eng.run()
    assert _streams(eng) == oracle and eng.park_replays == len(rids)
    if "park_write_fail_prob" in knobs:
        assert eng.park_store.stats["state_only_parks"] > 0
    if "park_corrupt_prob" in knobs:
        assert eng.park_store.stats["quarantined"] == len(rids)
    port = _park_scenario(stack, tmp_path, False, GREEDY, FaultPlan(**knobs), name=plan)
    ref = _park_scenario(stack, tmp_path, True, GREEDY, FaultPlan(**knobs), name=plan)
    assert port["streams"] == ref["streams"] == _oracle(stack, GREEDY)
    assert port["counts"] == ref["counts"] and port["store"] == ref["store"]
    assert port["names"] == ref["names"] and port["tier"] == ref["tier"]
    assert "tier:park_degraded" in port["tier"]


def test_double_resume_rejected(stack, tmp_path):
    """``:392``: a resume consumes the record; a second is refused."""
    for jax_side in (False, True):
        eng = _engine(stack, jax_side=jax_side, park_dir=str(tmp_path / f"p{jax_side}"))
        rid = eng.submit(P[0], 12)
        eng.step_block()
        eng.park(rid)
        assert eng.submit(resume=rid) == rid
        again = eng.submit(resume=rid)
        assert again.reason == "park_unresumable" and again.request_id == rid
        eng.run()
        assert _park_counts(eng, jax_side)["park_rejects"] == 1


def test_idle_autopark_then_resume_exact(stack, tmp_path):
    """``:407``: ``park_idle_blocks`` parks a long stream by itself on the
    virtual clock, and explicit resumes finish it exactly; JAX parks it at
    the same blocks."""
    submits = [dict(prompt=P[0], max_new_tokens=16)]
    oracle = _oracle(stack, submits)
    out = {}
    for jax_side in (False, True):
        eng = _engine(stack, jax_side=jax_side, park_dir=str(tmp_path / f"p{jax_side}"),
                      park_idle_blocks=2, trace=True)
        rid = eng.submit(**submits[0])
        eng.run()
        assert eng.parked_ids() == [rid]
        while eng.parked_ids():
            assert eng.submit(resume=rid) == rid
            eng.run()
        assert _streams(eng) == oracle
        out[jax_side] = ([ev["block"] for ev in eng.tracer.events("park")],
                         _park_counts(eng, jax_side))
    assert out[False] == out[True] and out[False][1]["parked"] >= 1


def _eos_submits(stack):
    """Greedy requests whose EOS id each one's stream emits early, mixed
    with one that ends on its budget."""
    base = [dict(prompt=P[i], max_new_tokens=n) for i, n in enumerate((14, 12, 16))]
    plain = _oracle(stack, base, key="fp32")
    out = []
    for i, s in enumerate(base):
        toks = plain[i]
        eos = next((t for j, t in enumerate(toks[2:], 2) if t not in toks[:j]), None)
        out.append(dict(s, eos_token_id=eos) if i < 2 and eos is not None else s)
    assert any("eos_token_id" in s for s in out)
    return out


@pytest.mark.parametrize("idle", [1, 2])
def test_async_idle_sweep_drains_then_retires(stack, tmp_path, idle):
    """The pipelined loop's idle sweep is a sync point: it drains the block
    in flight and retires what the drain finished before it parks, so a
    stream that ended on its EOS in flight is never parked or resumed past
    it; resumed to the end, every stream is the synchronous loop's."""
    submits = _eos_submits(stack)
    oracle = _oracle(stack, submits, key="fp32")
    eng = _engine(stack, "fp32", park_dir=str(tmp_path / "park"), park_idle_blocks=idle,
                  async_loop=True, trace=True)
    report = run_trace(eng, [dict(s, arrival_block=s.get("arrival_block", 0)) for s in submits])
    assert _streams(eng) == oracle
    assert report["parked"] == eng.parked >= 1 and report["parked_remaining"] == 0
    assert report["resumed"] == eng.resumed and report["park_replays"] == 0
    for rid, toks in oracle.items():
        parks = [ev["args"]["generated"] for ev in eng.tracer.events("park")
                 if ev["lane"] == ("req", rid)]
        assert all(g < len(toks) for g in parks)


_CHILD = textwrap.dedent("""\
    import os, signal, sys
    import numpy as np, torch
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.models import llama as tl

    torch.set_num_threads(1)
    cfg = tl.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=64,
                         use_flash_attention=False, dtype=torch.float32)
    sd = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lm = CausalLM(cfg, sd, tl.LlamaForCausalLM, device="cpu", buckets=(8, 16), max_batch=3,
                  page_size=4)
    eng = ServeEngine(lm, block_steps=4, seed=42, park_dir=sys.argv[1])
    p = np.random.default_rng(2).integers(1, 127, (4, 8)).astype(np.int32)
    r0 = eng.submit(p[0], 12)
    r1 = eng.submit(p[1], 10)
    eng.step_block()
    eng.step_block()
    eng.park(r0)                 # clean: shards, manifest, done marker
    store = eng.park_store
    save_text = store.storage.save_text

    def killer(text, path):
        if path.endswith("/done"):
            # the crash-mid-park shape: killed just before the done marker
            os.kill(os.getpid(), signal.SIGKILL)
        return save_text(text, path)

    store.storage.save_text = killer
    eng.park(r1)
    raise SystemExit("unreachable: SIGKILL must have fired")
""")


def test_sigkill_midpark_quarantines_torn_and_resumes_clean(tmp_path):
    """``:467``: a child importing only the port dies by SIGKILL between its
    manifest and its done marker. The sweep quarantines the torn park, the
    clean one resumes by page re-adoption and the torn one replays from
    its verified state: both streams are the never-parked ones."""
    park_dir = str(tmp_path / "park")
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, str(script), park_dir], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    sd = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lm = CausalLM(cfg, sd, tl.LlamaForCausalLM, device="cpu", **LM)
    submits = [dict(prompt=P[0], max_new_tokens=12), dict(prompt=P[1], max_new_tokens=10)]
    ref = ServeEngine(lm, block_steps=K, seed=42)
    for s in submits:
        ref.submit(**s)
    ref.run()
    oracle = _streams(ref)
    store = tct.ConversationParkStore(park_dir)
    assert store.sweep() == ([0], [1])
    eng = ServeEngine(lm, block_steps=K, seed=42, park_store=store)
    assert eng.submit(resume=0) == 0
    assert not isinstance(eng.submit(resume=1), Rejected)
    eng.run()
    assert _streams(eng) == oracle
    assert (eng.park_replays, eng.resumed) == (1, 1)


# --- across the frameworks ----------------------------------------------------------


def test_port_writes_jax_leaf_paths(stack):
    """The leaf names the port frames are the paths the JAX engine's page
    I/O names for this model, fp32 and int8 (scales included)."""
    for key, pools in (("fp32", ("keys", "values")),
                       ("int8", ("keys", "values", "k_scales", "v_scales"))):
        jeng = JaxEngine(stack[f"jax_{key}"], block_steps=K)
        teng = ServeEngine(stack[key], block_steps=K)
        want = jeng._read_page_bytes(5)
        got = tct.to_store_page(teng._read_pages_bytes([5])[0])
        assert sorted(got) == sorted(want) == sorted(tct.LEAF_PATHS[p] for p in pools)
        assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
                   for k in want)


@pytest.mark.parametrize("key", ["fp32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_park_resumes_across_frameworks(stack, tmp_path, key, writer):
    """A conversation parked by one engine resumes exactly in the other from
    the same directory: the adopted pages hold the parked bytes bit for
    bit (int8 pages and their scales too), no resume degrades, and the
    streams are the never-parked run's."""
    submits = [dict(prompt=P[0], max_new_tokens=12), dict(prompt=P[1], max_new_tokens=10)]
    oracle = _oracle(stack, submits, key=key)
    park_dir = str(tmp_path / "park")
    src = _engine(stack, key, jax_side=writer == "jax", park_dir=park_dir)
    _submit(src, submits)
    src.step_block()
    src.step_block()
    rids = _active(src)
    parked_pages = {}
    for rid in rids:
        slot = next(i for i, r in enumerate(src.slots) if r is not None and r.request_id == rid)
        n = -(-int(src.session.lengths[slot] if writer == "port" else src._lengths[slot]) // PAGE)
        pages = [int(p) for p in src.session.paged.tables[slot][:n]]
        parked_pages[rid] = (src._read_pages_bytes(pages) if writer == "jax"
                             else [tct.to_store_page(d) for d in src._read_pages_bytes(pages)])
        assert src.park(rid) == "parked"
    pre = _streams(src)
    dst = _engine(stack, key, jax_side=writer == "port", park_dir=park_dir)
    assert dst.parked_ids() == rids
    for rid in rids:
        assert dst.submit(resume=rid) == rid
        slot = next(i for i, r in enumerate(dst.slots) if r is not None and r.request_id == rid)
        pages = [int(p) for p in dst.session.paged.tables[slot][:len(parked_pages[rid])]]
        got = (dst._read_pages_bytes(pages) if writer == "port"
               else [tct.to_store_page(d) for d in dst._read_pages_bytes(pages)])
        for g, w in zip(got, parked_pages[rid]):
            assert sorted(g) == sorted(w)
            assert all(np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes() for k in w)
    dst.run()
    assert {**pre, **_streams(dst)} == oracle
    counts = _park_counts(dst, jax_side=writer == "port")
    assert counts["resumed"] == len(rids) and counts["park_replays"] == 0


def test_bf16_pages_round_trip_between_frameworks(tmp_path):
    """A bf16 page moves as its bits: the port frames it under the dtype
    name ``bfloat16``, the JAX store decodes it to a bf16 array with the
    same bits (and crc), and a JAX bf16 page decodes in the port to the
    same bits as int16."""
    bits = np.random.default_rng(3).integers(-2 ** 15, 2 ** 15, (2, PAGE, 2, 8)).astype(np.int16)
    leaf = tct.LEAF_PATHS["keys"]
    port_page = {leaf: bits, tct.LEAF_PATHS["values"]: bits[::-1].copy()}
    data = tct._encode_page(port_page, bf16=True)
    assert b"bfloat16" in data and b"int16" not in data
    jax_page = jct._decode_page(data)
    assert str(jax_page[leaf].dtype) == "bfloat16"
    assert jax_page[leaf].view(np.int16).tobytes() == bits.tobytes()
    assert jct._page_crc(jax_page) == tct._page_crc(port_page)
    back = tct._decode_page(jct._encode_page(jax_page))
    assert back[leaf].dtype == np.int16 and back[leaf].tobytes() == bits.tobytes()
    # through both stores, with the manifest's stamp
    d = str(tmp_path / "bf16")
    tct.ConversationParkStore(d).park(3, _STATE0, [port_page], page_dtype="bfloat16")
    got = jct.ConversationParkStore(d).load(3)
    assert got.page_dtype == "bfloat16"
    assert got.payloads[0][leaf].view(np.int16).tobytes() == bits.tobytes()
    jct.ConversationParkStore(d).park(4, _STATE0, [jax_page], page_dtype="bfloat16")
    got = tct.ConversationParkStore(d).load(4)
    assert got.payloads[0][leaf].dtype == np.int16
    assert got.payloads[0][leaf].tobytes() == bits.tobytes()


def test_foreign_stamps_degrade_to_replay(stack, tmp_path):
    """A park stamped with another ``tp_degree`` or ``page_dtype`` is never
    adopted: the resume replays (the cold stream) and the record is
    consumed."""
    submits = [dict(prompt=P[0], max_new_tokens=12)]
    oracle = _oracle(stack, submits, key="fp32")
    for stamp in (dict(tp_degree=2), dict(page_dtype="int8")):
        eng = _engine(stack, "fp32", park_dir=str(tmp_path / str(stamp)), trace=True)
        rid = eng.submit(**submits[0])
        eng.step_block()
        store = eng.park_store
        real = store.park
        store.park = lambda *a, **kw: real(*a, **{**kw, **stamp})
        eng.park(rid)
        assert eng.submit(resume=rid) == rid
        eng.run()
        assert _streams(eng) == oracle and eng.park_replays == 1
        cause = [ev["args"]["cause"] for ev in eng.tracer.events("tier:park_degraded")]
        assert cause and "mismatch" in cause[0] and store.list_parked() == []


def test_snapshot_parked_section_restores_in_either_engine(stack, tmp_path):
    """A snapshot taken while a conversation is parked carries it by
    manifest id; restored over the same store by the other framework's
    engine, it resumes by page re-adoption and finishes the never-parked
    stream. The port's snapshot has JAX's keys."""
    submits = [dict(prompt=P[0], max_new_tokens=12), dict(prompt=P[1], max_new_tokens=10)]
    oracle = _oracle(stack, submits, key="fp32")
    jax_keys = None
    for writer in ("jax", "port"):
        park_dir = str(tmp_path / writer)
        src = _engine(stack, "fp32", jax_side=writer == "jax", park_dir=park_dir)
        _submit(src, submits)
        src.step_block()
        src.step_block()
        parked = _active(src)[0]
        src.park(parked)
        snap = json.loads(json.dumps(src.snapshot()))
        assert [p["request_id"] for p in snap["parked"]] == [parked]
        assert snap["config"]["park_dir"] == park_dir
        if writer == "port":
            jsnap = JaxEngine(stack["jax_fp32"], block_steps=K, park_dir=park_dir).snapshot()
            assert set(snap) == set(jsnap) and set(snap["config"]) == set(jsnap["config"])
            assert set(snap["parked"][0]) == jax_keys
            restored = JaxEngine.from_snapshot(stack["jax_fp32"], snap)
        else:
            jax_keys = set(snap["parked"][0])
            restored = ServeEngine.from_snapshot(stack["fp32"], snap)
        pre = _streams(src)
        assert restored.parked_ids() == [parked]
        assert restored.submit(resume=parked) == parked
        restored.run()
        assert {**pre, **_streams(restored)} == oracle
        counts = _park_counts(restored, jax_side=writer == "port")
        assert counts["resumed"] == 1 and counts["park_replays"] == 0
        # without a store the parked record replays from the snapshot
        nostore = ServeEngine.from_snapshot(
            stack["fp32"], {**snap, "config": {**snap["config"], "park_dir": None}})
        assert nostore.park_store is None and nostore.parked_ids() == []
        nostore.run()
        got = _streams(nostore)
        assert got[parked] == oracle[parked]


def test_run_trace_park_report_matches_jax(stack, tmp_path):
    """``run_trace`` with auto-parking: the drain resumes every parked
    conversation until none is left, and the report's park keys (and the
    streams) are the JAX engine's; the streaming report carries them too."""
    make = dict(prompt_lens=(6, 9), max_new_tokens=16, mean_interarrival_blocks=0.7, seed=4)

    def trace_of(fn):
        # the clock starts at the first arrival: a streaming run whose queue
        # is empty at block 0 has no round to advance it (in either package)
        items = fn(5, 128, **make)
        return [dict(t, arrival_block=t["arrival_block"] - items[0]["arrival_block"])
                for t in items]

    reports = {}
    for side in ("port", "jax"):
        trace = trace_of(synthetic_trace if side == "port" else jax_trace)
        eng = _engine(stack, "fp32", jax_side=side == "jax", park_dir=str(tmp_path / side),
                      park_idle_blocks=2)
        rep = (run_trace if side == "port" else jax_run_trace)(eng, trace)
        reports[side] = (rep, _streams(eng))
    keys = ("park_idle_blocks", "parked", "resumed", "park_replays", "park_rejects",
            "parked_remaining", "parked_bytes")
    assert {k: reports["port"][0][k] for k in keys} == {k: reports["jax"][0][k] for k in keys}
    assert reports["port"][1] == reports["jax"][1]
    assert reports["port"][0]["parked"] > 0 and reports["port"][0]["parked_remaining"] == 0
    eng = ServeEngine(stack["fp32"], block_steps=K, seed=42, park_dir=str(tmp_path / "s"),
                      park_idle_blocks=2, keep_completions=False)
    rep = run_trace(eng, trace_of(synthetic_trace))
    assert {k: rep[k] for k in keys} == {k: reports["port"][0][k] for k in keys}
    assert rep["requests_completed"] == 5
