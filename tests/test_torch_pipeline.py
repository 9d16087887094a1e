"""Pipeline parallelism on the port against the JAX package.

* The schedules (``pipeline/schedules.py``, the port's own copy): every
  generator's output equals JAX's, case for case with JAX
  ``tests/test_pipeline.py:16-130``, and the same invariants hold; each
  rank's unit order (``engine.rank_units``) runs to its end when every
  receive blocks and every send does not (no rank waits on a peer that
  waits on it).
* ``PipelinedLlama`` at pp 2 and 4 under ``"gpipe"``, ``"1f1b"`` and
  interleaved 1F1B (``num_chunks=2``), on 2 or 4 thread ranks over gloo,
  from one seeded JAX ``PipelinedLlama`` tree (converted by
  ``pipelined_llama_params_from_jax``; stored in JAX's VPP order for the
  interleaved cases): the loss within 1e-5 of JAX's dense autodiff of the
  same tree and the worst relative gradient error below 1e-4 (JAX
  ``:341-384``'s bars for its own engines); the logits of ``apply`` and
  the forward-only loss too.
* The 1F1B stash: rank ``r`` holds at most ``pp - r`` microbatches
  (``engine.stash_peak``), GPipe all of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.models.llama import LlamaConfig as JConfig
from neuronx_distributed_tpu.models.llama import rotary_embedding as j_rotary
from neuronx_distributed_tpu.models.llama_pipeline import PipelinedLlama as JPipelinedLlama
from neuronx_distributed_tpu.parallel.loss import parallel_cross_entropy_mean as j_ce_mean
from neuronx_distributed_tpu.pipeline import schedules as JS
from neuronx_distributed_tpu_torch.converters.jax_params import pipelined_llama_params_from_jax
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.pipeline import engine as E
from neuronx_distributed_tpu_torch.pipeline import schedules as S

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=8, num_heads=4,
            num_kv_heads=2, max_seq_len=32, use_flash_attention=False, remat_policy=None)
BATCH, SEQ, MB = 8, 16, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the schedules ----------------------------------------------------------------------

def _plain(steps):
    """A schedule's steps as (task kind, microbatch, chunk) tuples: the two
    packages' task classes are distinct types."""
    return [[(type(t).__name__, t.microbatch, t.chunk) for t in step] for step in steps]


@pytest.mark.parametrize("pp,mb,chunks", [(2, 4, 2), (2, 8, 4), (4, 8, 2), (4, 16, 4),
                                          (8, 16, 2)])
def test_interleaved_1f1b_global_invariants(pp, mb, chunks):
    """JAX's table, and its invariants: each unit once, ring hops of at
    least a tick, one forward and one backward a (tick, rank), a stash flat
    in microbatches, no more chunk-ticks than plain 1F1B."""
    from collections import Counter

    g = S.interleaved_1f1b_global(pp, mb, chunks)
    assert dataclasses.asdict(g) == dataclasses.asdict(JS.interleaved_1f1b_global(pp, mb, chunks))
    v_all = pp * chunks
    assert len(g.exec_f) == len(g.exec_b) == pp * chunks * mb
    for (m, v), t in g.exec_f.items():
        if v > 0:
            assert g.exec_f[(m, v - 1)] < t
    for (m, v), t in g.exec_b.items():
        if v < v_all - 1:
            assert g.exec_b[(m, v + 1)] < t
        else:
            assert g.exec_f[(m, v)] <= t
    cf = Counter((t, v % pp) for (m, v), t in g.exec_f.items())
    cb = Counter((t, v % pp) for (m, v), t in g.exec_b.items())
    assert max(cf.values()) == 1 and max(cb.values()) == 1
    g2 = S.interleaved_1f1b_global(pp, 4 * mb, chunks)
    assert g2.x_slots == g.x_slots and g2.dy_slots == g.dy_slots
    assert g.ticks <= (mb + 2 * (pp - 1)) * chunks
    if pp >= 4:
        assert g.ticks < (mb + 2 * (pp - 1)) * chunks


@pytest.mark.parametrize("pp", [2, 4, 8])
@pytest.mark.parametrize("mb", [1, 4, 8, 32])
def test_1f1b_counts_and_order(pp, mb):
    for rank in range(pp):
        steps = list(S.train_1f1b_schedule(rank, pp, mb))
        assert _plain(steps) == _plain(JS.train_1f1b_schedule(rank, pp, mb))
        tasks = [t for step in steps for t in step]
        fwd = [t.microbatch for t in tasks if isinstance(t, S.ForwardStep)]
        bwd = [t.microbatch for t in tasks if isinstance(t, S.BackwardStep)]
        assert fwd == list(range(mb)) and bwd == list(range(mb))
        in_flight = peak = 0
        seen_f = set()
        for t in tasks:
            if isinstance(t, S.ForwardStep):
                seen_f.add(t.microbatch)
                in_flight += 1
                peak = max(peak, in_flight)
            if isinstance(t, S.BackwardStep):
                assert t.microbatch in seen_f   # a backward never precedes its forward
                in_flight -= 1
        assert peak <= min(pp - rank, mb)
        assert isinstance(tasks[-1], S.ReduceGrads)


@pytest.mark.parametrize("pp,mb", [(2, 4), (4, 8)])
def test_1f1b_send_recv_pairing(pp, mb):
    """Rank r's sends forward are rank r+1's receives, and back."""
    for r in range(pp - 1):
        a = [t for st in S.train_1f1b_schedule(r, pp, mb) for t in st]
        b = [t for st in S.train_1f1b_schedule(r + 1, pp, mb) for t in st]
        assert ([t.microbatch for t in a if isinstance(t, S.SendForward)]
                == [t.microbatch for t in b if isinstance(t, S.RecvForward)])
        assert ([t.microbatch for t in b if isinstance(t, S.SendBackward)]
                == [t.microbatch for t in a if isinstance(t, S.RecvBackward)])


def test_inference_schedule():
    steps = list(S.inference_schedule(1, 4, 3))
    assert _plain(steps) == _plain(JS.inference_schedule(1, 4, 3))
    tasks = [t for st in steps for t in st]
    assert [t.microbatch for t in tasks if isinstance(t, S.ForwardStep)] == [0, 1, 2]
    assert all(not isinstance(t, S.BackwardStep) for t in tasks)


@pytest.mark.parametrize("pp,mb,chunks", [(2, 4, 2), (4, 8, 2)])
def test_interleaved_counts(pp, mb, chunks):
    for rank in range(pp):
        steps = list(S.interleaved_schedule(rank, pp, mb, chunks))
        assert _plain(steps) == _plain(JS.interleaved_schedule(rank, pp, mb, chunks))
        tasks = [t for st in steps for t in st]
        fwd = [t for t in tasks if isinstance(t, S.ForwardStep)]
        assert len(fwd) == mb * chunks
        assert len([t for t in tasks if isinstance(t, S.BackwardStep)]) == mb * chunks
        assert {(t.chunk, t.microbatch) for t in fwd} == {
            (c, m) for c in range(chunks) for m in range(mb)}


@pytest.mark.parametrize("pp,mb,chunks,schedule", [
    (2, 4, 1, "1f1b"), (4, 8, 1, "1f1b"), (4, 8, 1, "gpipe"), (2, 4, 2, "1f1b"),
    (4, 8, 2, "1f1b"), (4, 8, 2, "gpipe"), (8, 16, 2, "1f1b")])
def test_rank_units_run_to_the_end(pp, mb, chunks, schedule):
    """Every rank's units, executed with blocking receives and sends that
    never block, all complete: each unit once, a backward after its
    forward, a receive only after its send."""
    v_all = pp * chunks
    units = [E.rank_units(r, pp, mb, chunks, schedule) for r in range(pp)]
    for r, us in enumerate(units):
        assert sorted(us) == sorted((k, m, v) for k in "FB" for m in range(mb)
                                    for v in range(r, v_all, pp))
    sent, pos, done = set(), [0] * pp, 0
    while done < 2 * mb * v_all:
        moved = False
        for r in range(pp):
            while pos[r] < len(units[r]):
                kind, m, v = units[r][pos[r]]
                need = (("F", m, v - 1) if kind == "F" and v > 0 else
                        ("B", m, v + 1) if kind == "B" and v < v_all - 1 else None)
                if kind == "B":
                    assert ("F", m, v) in sent
                if need is not None and need not in sent:
                    break
                sent.add((kind, m, v))
                pos[r] += 1
                done += 1
                moved = True
        assert moved, f"deadlock at {pos}"


# --- the model ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    """A seeded JAX PipelinedLlama tree (canonical order), a batch, and
    JAX's dense loss and gradients of it (the reference its engines are
    held to)."""
    jcfg = JConfig(**TINY, dtype=jnp.float32)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 127, (BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 127, (BATCH, SEQ)).astype(np.int32)
    labels[:, :3] = -100   # ignore_index weighting across microbatches
    pm = JPipelinedLlama(jcfg, num_stages=1, num_microbatches=MB, remat=False)
    tree = jax.tree_util.tree_map(np.asarray, pm.init(jax.random.PRNGKey(2), jnp.asarray(ids)))

    def dense_loss(p):
        x = pm._embed.apply({"params": p["embed"]}, jnp.asarray(ids))
        cos, sin = j_rotary(jnp.arange(SEQ), jcfg.head_dim_, jcfg.rope_theta, dtype=x.dtype)
        x = pm._stage_fn(p["layers"]["block"], x, cos, sin)
        x = pm._norm.apply({"params": p["final_norm"]}, x)
        logits = pm._head.apply({"params": p["lm_head"]}, x)
        return j_ce_mean(logits, jnp.asarray(labels), ignore_index=-100)

    loss, grads = jax.value_and_grad(dense_loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    return dict(tree=tree, ids=ids, labels=labels, loss=float(loss),
                grads=pipelined_llama_params_from_jax(
                    jax.tree_util.tree_map(np.asarray, grads), 1))


def _vpp_tree(tree, pp, chunks):
    """The canonical tree laid out as JAX stores it under VPP."""
    order = np.asarray(E.vpp_layer_order(TINY["num_layers"], pp, chunks))
    return {**tree, "layers": {"block": jax.tree_util.tree_map(
        lambda a: a[order], tree["layers"]["block"])}}


def _stage_run(cfg, params, ids, labels, pp, chunks, schedule):
    pm = PipelinedLlama(cfg, num_stages=pp, num_microbatches=MB, remat=False,
                        num_chunks=chunks, schedule=schedule)
    model = pm.as_parallel_model(device="cpu", params=params)
    leaves = dict(model.module.named_parameters())
    loss = pm.loss(model.params, torch.as_tensor(ids), torch.as_tensor(labels))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    peak = pm.engine.stash_peak
    with torch.no_grad():
        fwd_loss = pm.loss(model.params, torch.as_tensor(ids), torch.as_tensor(labels))
    logits = pm.apply(model.params, torch.as_tensor(ids))
    return dict(loss=float(loss.detach()), fwd_loss=float(fwd_loss), peak=peak,
                grads={n: g for n, g in zip(leaves, grads)}, logits=logits)


@pytest.mark.parametrize("pp,chunks,schedule", [
    (2, 1, "gpipe"), (2, 1, "1f1b"), (2, 2, "1f1b"), (4, 1, "gpipe"), (4, 1, "1f1b"),
    (4, 2, "1f1b")])
def test_pipelined_llama_matches_jax(golden, pp, chunks, schedule):
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    tree = _vpp_tree(golden["tree"], pp, chunks) if chunks > 1 else golden["tree"]
    ranks = mesh.run_in_threads(pp, lambda r: _stage_run(
        cfg, pipelined_llama_params_from_jax(tree, pp, chunks, stage=r), golden["ids"],
        golden["labels"], pp, chunks, schedule),
        tensor_model_parallel_size=1, pipeline_model_parallel_size=pp)
    want = golden["grads"]
    seen = set()
    for rk in ranks:
        assert abs(rk["loss"] - golden["loss"]) < 1e-5
        assert abs(rk["fwd_loss"] - golden["loss"]) < 1e-5
        worst = max(float((g - want[n]).abs().max() / (want[n].abs().max() + 1e-8))
                    for n, g in rk["grads"].items())
        assert worst < 1e-4, worst
        seen |= set(rk["grads"])
        assert torch.equal(rk["logits"], ranks[0]["logits"])
    assert seen == set(want)   # every leaf on exactly one stage
    ref = tl.LlamaForCausalLM(cfg)
    ref.load_state_dict(pipelined_llama_params_from_jax(golden["tree"], 1))
    with torch.no_grad():
        np.testing.assert_allclose(ranks[0]["logits"].numpy(),
                                   ref(torch.as_tensor(golden["ids"])).numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_1f1b_stash_bound(golden):
    """Rank r of a 1F1B pipeline holds at most pp - r microbatches' graphs
    (exactly that many at 4 stages and 8 microbatches); GPipe holds all.
    The sends a rank holds at once (each keeps its activation or gradient
    until waited on) stay within the same bound, interleaved too."""
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 127, (16, 8)).astype(np.int32)
    labels = rs.randint(0, 127, (16, 8)).astype(np.int32)
    params = pipelined_llama_params_from_jax(golden["tree"], 1)

    def run(schedule, pp=4, chunks=1):
        def rank(r):
            pm = PipelinedLlama(cfg, num_stages=pp, num_microbatches=8, remat=False,
                                schedule=schedule, num_chunks=chunks)
            model = pm.as_parallel_model(device="cpu", params=params if chunks == 1 else
                                         pipelined_llama_params_from_jax(
                                             _vpp_tree(golden["tree"], pp, chunks), pp, chunks,
                                             stage=r))
            loss = pm.loss(model.params, torch.as_tensor(ids), torch.as_tensor(labels))
            torch.autograd.grad(loss, list(model.module.parameters()))
            return pm.engine.stash_peak, pm.engine.stashed, pm.engine.sends_peak
        return mesh.run_in_threads(pp, rank, tensor_model_parallel_size=1,
                                   pipeline_model_parallel_size=pp)

    assert run("1f1b") == [(4, 0, 4), (3, 0, 3), (2, 0, 2), (1, 0, 1)]
    assert run("gpipe") == [(8, 0, 8)] * 4
    assert run("1f1b", pp=2, chunks=2) == [(5, 0, 3), (3, 0, 3)]


def test_pipelined_llama_checks_and_init():
    """JAX's refusals by name; the mesh's stage accessors; a stage's seeded
    weights are the whole model's values for the seed."""
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible by stages"):
        PipelinedLlama(tl.LlamaConfig(**{**TINY, "num_layers": 6}), 4, 4)
    with pytest.raises(ValueError, match="divisible by num_stages"):
        PipelinedLlama(cfg, 2, 3, num_chunks=2, stage=0)
    with pytest.raises(NotImplementedError, match="tied embeddings with PP"):
        PipelinedLlama(tl.LlamaConfig(**{**TINY, "tie_word_embeddings": True}), 1, 2)
    with pytest.raises(ValueError, match="unknown schedule"):
        PipelinedLlama(cfg, 1, 2, schedule="zb")
    whole = tl.init_params(cfg, torch.Generator().manual_seed(3))

    def rank(r):
        pm = PipelinedLlama(cfg, num_stages=2, num_microbatches=2, num_chunks=2)
        return pm.init_params(torch.Generator().manual_seed(3))

    def stages(r):
        return (mesh.pipeline_model_parallel_rank(), mesh.pipeline_prev_stage(),
                mesh.pipeline_next_stage(), mesh.get_pipeline_model_parallel_group().size())

    assert mesh.run_in_threads(4, stages, tensor_model_parallel_size=2,
                               pipeline_model_parallel_size=2) == [
        (0, None, 1, 2), (0, None, 1, 2), (1, 0, None, 2), (1, 0, None, 2)]
    got = {}
    for part in mesh.run_in_threads(2, rank, tensor_model_parallel_size=1,
                                    pipeline_model_parallel_size=2):
        assert not set(part) & set(got)
        got.update(part)
    assert set(got) == set(whole)
    assert all(torch.equal(got[n], whole[n]) for n in whole)
