"""BERT on the port against the JAX package (``models/bert.py``).

The same seeded flax tree (``bert_params_from_jax``) at fp32 under ragged
padding masks: MLM and NSP logits through the dense route and through the
flash route (the port's B1 twin, JAX's Pallas kernel in interpret mode), and
the flash route against the dense one on each side (``atol=2e-5``; the MLM
logits are tied to unit-scale embeddings, so 5e-5 there). Masked keys change
no valid position's output (bits). The tied decoder's gradient reaches the
word embedding from the lookup and from the MLM logits, equal to JAX's
gradient (``atol=1e-5``), and the loss with ``ignore_index`` equals JAX's.
The trajectory: 3 steps of losses and grad norms at TP 2 x DP 2 (ZeRO-1;
the MLM mean over the global batch's labelled tokens) against JAX's trainer
on the same mesh (``rtol=5e-4``), the replicated heads (pooler, NSP, MLM
transform and norm) and every DP replica bit-identical across ranks, and
``mlm_bias`` sharded by the specs. Dropout: p = 0 equals the deterministic
forward, and a seeded p = 0.1 step is reproducible and gives the same bits
with and without activation checkpointing (the recompute draws the
forward's masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from neuronx_distributed_tpu.models import bert as jb
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu.trainer.model import ParallelModel as JParallelModel
from neuronx_distributed_tpu_torch.converters.jax_params import bert_params_from_jax
from neuronx_distributed_tpu_torch.inference.partition import param_partition_specs
from neuronx_distributed_tpu_torch.models import bert as tb
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD, STEPS, RTOL = 4, 3, 5e-4
ATOL = 2e-5
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0, use_flash_attention=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill(abstract, seed=0):
    rs = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith("bias']"):
            return (0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)
        if "embeddings" in name:
            return rs.standard_normal(leaf.shape).astype(np.float32)
        fan_in = leaf.shape[-3] if "qkv" in name else leaf.shape[-2]
        return (rs.standard_normal(leaf.shape) * fan_in ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, meta.unbox(abstract)["params"])


def _batch(b=4, s=32, seed=0):
    """Ragged padding (one row unpadded), two segments, MLM labels on a
    fifth of the valid positions."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 128, (b, s)).astype(np.int32)
    tt = (np.arange(s)[None] >= rs.randint(1, s, (b, 1))).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for i, p in enumerate([s, 20, 9, 27][:b]):
        mask[i, p:] = 0
    labels = np.where((rs.rand(b, s) < 0.2) & (mask == 1), ids, -100).astype(np.int32)
    nsp = rs.randint(0, 2, (b,)).astype(np.int32)
    return dict(input_ids=ids, token_type_ids=tt, attention_mask=mask, masked_lm_labels=labels,
                next_sentence_labels=nsp)


@pytest.fixture(scope="module")
def tree():
    b = _batch()
    module = jb.BertForPreTraining(jb.BertConfig(**TINY, dtype=jnp.float32))
    return _fill(jax.eval_shape(lambda: module.init(jax.random.key(0), b["input_ids"])))


def _port(tree, **over):
    model = tb.BertForPreTraining(tb.BertConfig(**{**TINY, **over}, dtype=torch.float32))
    model.load_state_dict(bert_params_from_jax(tree), strict=True)
    return model


def _t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _fwd(model, b):
    mlm, nsp = model(b["input_ids"], b["token_type_ids"], b["attention_mask"])
    return mlm.detach().numpy(), nsp.detach().numpy()


def test_logits_match_jax_dense_and_flash(tree):
    b = _batch()
    out = {}
    for flash in (False, True):
        jm = jb.BertForPreTraining(jb.BertConfig(**{**TINY, "use_flash_attention": flash},
                                                 dtype=jnp.float32))
        want = [np.asarray(x) for x in jm.apply({"params": tree}, b["input_ids"],
                                                b["token_type_ids"], b["attention_mask"])]
        got = _fwd(_port(tree, use_flash_attention=flash), _t(b))
        np.testing.assert_allclose(got[0], want[0], atol=5e-5)
        np.testing.assert_allclose(got[1], want[1], atol=ATOL)
        out[flash] = got, want
    for side in (0, 1):   # flash against dense, within each package
        for i in (0, 1):
            np.testing.assert_allclose(out[True][side][i], out[False][side][i], atol=5e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_masked_keys_change_no_output(tree, flash):
    model = _port(tree, use_flash_attention=flash)
    b = _t(_batch())
    x, _ = model.bert(b["input_ids"], b["token_type_ids"], b["attention_mask"])
    ids = b["input_ids"].clone()
    ids[b["attention_mask"] == 0] = 7     # other tokens at every masked position
    y, _ = model.bert(ids, b["token_type_ids"], b["attention_mask"])
    valid = b["attention_mask"].bool()
    assert torch.equal(x[valid], y[valid])
    assert not torch.equal(x[~valid], y[~valid])


def test_tied_decoder_gradient_and_ignore_index_loss(tree):
    b = _batch()
    jm = jb.BertForPreTraining(jb.BertConfig(**TINY, dtype=jnp.float32))

    def jloss(p):
        return jm.apply({"params": p}, b["input_ids"], b["masked_lm_labels"],
                        b["next_sentence_labels"], b["token_type_ids"], b["attention_mask"],
                        method=jb.BertForPreTraining.loss)

    want_loss, want_grads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, tree))
    model = _port(tree)
    tbatch = _t(b)
    loss = model.loss(tbatch["input_ids"], tbatch["masked_lm_labels"],
                      tbatch["next_sentence_labels"], tbatch["token_type_ids"],
                      tbatch["attention_mask"])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    emb = model.bert.word_embeddings.embedding
    emb.requires_grad_(True)
    loss = model.loss(tbatch["input_ids"], tbatch["masked_lm_labels"],
                      tbatch["next_sentence_labels"], tbatch["token_type_ids"],
                      tbatch["attention_mask"])
    (g,) = torch.autograd.grad(loss, [emb])
    np.testing.assert_allclose(g.numpy(), np.asarray(
        want_grads["bert"]["word_embeddings"]["embedding"]), atol=1e-5)
    # a token that never appears in the input gets its gradient from the
    # decoder alone; one that appears gets both
    absent = sorted(set(range(128)) - set(b["input_ids"].ravel().tolist()))[0]
    assert float(g[absent].abs().max()) > 0
    (g_dec,) = torch.autograd.grad(model.bert.attend(torch.ones(1, 32)).sum(), [emb])
    assert float(g_dec.abs().max()) > 0
    # ignore_index: only the labelled positions count
    labels = tbatch["masked_lm_labels"]
    mlm, nsp = model(tbatch["input_ids"], tbatch["token_type_ids"], tbatch["attention_mask"])
    keep = labels != -100
    manual = torch.nn.functional.cross_entropy(mlm[keep], labels[keep].long()) + \
        torch.nn.functional.cross_entropy(nsp, tbatch["next_sentence_labels"].long())
    np.testing.assert_allclose(float(loss.detach()), float(manual.detach()), rtol=1e-6)


def test_dropout_pins(tree):
    """p = 0 with a seed is the deterministic forward; a seeded p = 0.1 step
    repeats bit for bit, and remat recomputes the same masks."""
    b = _t(_batch())
    args = (b["input_ids"], b["masked_lm_labels"], b["next_sentence_labels"],
            b["token_type_ids"], b["attention_mask"])
    model = _port(tree)
    det = model.loss(*args)
    assert torch.equal(model.loss(*args, deterministic=False, dropout_seed=5), det)
    with pytest.raises(ValueError, match="dropout_seed"):
        _port(tree, hidden_dropout=0.1).loss(*args, deterministic=False)

    def grads(remat, seed):
        m = _port(tree, hidden_dropout=0.1, remat_policy=remat)
        m.requires_grad_(True)
        loss = m.loss(*args, deterministic=False, dropout_seed=seed)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    loss, g = grads(None, 11)
    assert not torch.equal(loss, det)
    again, g2 = grads(None, 11)
    assert torch.equal(loss, again) and all(torch.equal(a, c) for a, c in zip(g, g2))
    remat, g3 = grads("full", 11)
    assert torch.equal(loss, remat) and all(torch.equal(a, c) for a, c in zip(g, g3))
    other, _ = grads(None, 12)
    assert not torch.equal(loss, other)


def _jax_run(tree):
    jps.initialize_model_parallel(tensor_model_parallel_size=2, devices=jax.devices()[:WORLD])
    try:
        cfg = j_config(optimizer_config={"zero_one_enabled": True})
        b = _batch()
        module = jb.BertForPreTraining(jb.BertConfig(**TINY, dtype=jnp.float32))
        specs = nn.get_partition_spec(jax.eval_shape(
            lambda: module.init(jax.random.key(0), jnp.asarray(b["input_ids"]))))["params"]
        model = JParallelModel(module=module, params=None, param_specs=specs,
                               mesh=jps.get_mesh())
        model.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree),
                                      model.param_shardings())
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, x, r: model.module.apply(
            {"params": p}, x["input_ids"], x["masked_lm_labels"], x["next_sentence_labels"],
            x["token_type_ids"], x["attention_mask"], method=jb.BertForPreTraining.loss))
        out = []
        for i in range(STEPS):
            state, m = step(state, b, jax.random.key(i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out
    finally:
        jps.destroy_model_parallel()


def _port_rank(tree):
    cfg = neuronx_distributed_config(tensor_parallel_size=2,
                                     optimizer_config={"zero_one_enabled": True})
    model = initialize_parallel_model(
        cfg, lambda: tb.BertForPreTraining(tb.BertConfig(**TINY, dtype=torch.float32)),
        device="cpu", params=bert_params_from_jax(tree))
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
    state = create_train_state(model, opt)
    dp_group = mesh.get_data_parallel_group()

    def loss_fn(p, x, rng):
        model.bind(p)
        return model.module.loss(x["input_ids"], x["masked_lm_labels"],
                                 x["next_sentence_labels"], x["token_type_ids"],
                                 x["attention_mask"], dp_group=dp_group)

    step = make_train_step(model, opt, loss_fn)
    rows = mesh.data_batch_slice(4)
    batch = {k: torch.as_tensor(v[rows]) for k, v in _batch().items()}
    out = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(traj=out, params={n: t.clone() for n, t in state.params.items()},
                coords=mesh.local_mesh_coords(), specs=param_partition_specs(model.module),
                sharded=set(opt.zero1_plan.param_specs))


def test_tp2_dp2_trajectory_matches_jax(tree):
    want = _jax_run(tree)
    ranks = mesh.run_in_threads(WORLD, lambda r: _port_rank(tree), tensor_model_parallel_size=2)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
    np.testing.assert_allclose(np.array(ranks[0]["traj"]), np.array(want), rtol=RTOL)
    assert ranks[0]["specs"]["mlm_bias"] == ("tp",)
    assert ranks[0]["params"]["mlm_bias"].shape == (64,)
    for rk in ranks[1:]:
        for n in ("bert.pooler.kernel", "nsp_head.kernel", "mlm_transform.kernel",
                  "mlm_norm.ln.scale", "bert.position_embeddings.embedding"):
            assert torch.equal(rk["params"][n], ranks[0]["params"][n]), n
    by_tp = {}
    for rk in ranks:
        by_tp.setdefault(rk["coords"]["tp"], []).append(rk)
    for group in by_tp.values():
        for n, t in group[1]["params"].items():
            assert torch.equal(t, group[0]["params"][n]), n
