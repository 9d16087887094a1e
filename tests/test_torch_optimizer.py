"""The port's optimizer, gradient and loss pieces against the JAX package.

Seeded numpy inputs go through both sides:

- ``fused_adamw_leaf_plain`` (what a CPU tensor routes to) against JAX
  ``fused_adamw_leaf`` (the Pallas kernel in interpret mode), and the port's
  in-place update of mu, nu and the master;
- ``adamw_fp32_master`` over three steps with a learning-rate schedule and
  a clip scale: ``update``, ``update_and_params`` and
  ``update_and_params_local`` (its kernel route on the leaves of 8192
  elements or more);
- ``get_grad_norm`` / ``clip_grad_norm`` and
  ``parallel_cross_entropy(_mean)`` with ``ignore_index`` and label
  smoothing.

Tolerances: fp32 elementwise chains in one order on both sides differ only
where XLA fuses or a pow rounds differently: rtol 1e-6 (the JAX package's
own kernel test uses the same); bf16 params to one bf16 last place; the
norm and the losses, sums over a few thousand fp32 terms, to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.optimizer import fused_kernel as jfk
from neuronx_distributed_tpu.optimizer.adamw import adamw_fp32_master as j_adamw
from neuronx_distributed_tpu.parallel import grads as jgrads
from neuronx_distributed_tpu.parallel import loss as jloss
from neuronx_distributed_tpu_torch.optimizer import fused_kernel as tfk
from neuronx_distributed_tpu_torch.optimizer.adamw import adamw_fp32_master
from neuronx_distributed_tpu_torch.parallel import grads as tgrads
from neuronx_distributed_tpu_torch.parallel import loss as tloss


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-6


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_fused_adamw_leaf_plain_matches_jax_kernel(p_dtype):
    n = 16384
    assert tfk.leaf_supported(n) and not tfk.leaf_supported(n - 128)
    assert all(tfk.leaf_supported(m) == jfk.leaf_supported(m) for m in (8191, 8192, 12288, 24576))
    rs = np.random.RandomState(5)
    g = _bf16(rs.randn(n) * 2).reshape(16, 1024)
    mu = (rs.randn(n) * 0.1).astype(np.float32).reshape(16, 1024)
    nu = (np.abs(rs.randn(n)) * 0.01).astype(np.float32).reshape(16, 1024)
    ms = rs.randn(n).astype(np.float32).reshape(16, 1024)
    scalars = np.array([[0.7, 1e-2, 0.5, 0.3]], np.float32)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    want = jfk.fused_adamw_leaf(jnp.asarray(g, jnp.bfloat16), jnp.asarray(mu), jnp.asarray(nu),
                                jnp.asarray(ms), jnp.asarray(scalars), **kw,
                                p_dtype=getattr(jnp, p_dtype))
    t = [torch.from_numpy(a.copy()) for a in (mu, nu, ms)]
    got = tfk.fused_adamw_leaf(torch.from_numpy(g).to(torch.bfloat16), *t,
                               torch.from_numpy(scalars), **kw,
                               p_dtype=getattr(torch, p_dtype))
    assert all(a is b for a, b in zip(got[:3], t))           # updated in place
    for name, a, b in zip(("mu", "nu", "master"), got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-7, err_msg=name)
    p = got[3].float().numpy()
    np.testing.assert_allclose(p, np.asarray(want[3], np.float32), rtol=2 ** -7)
    np.testing.assert_array_equal(p, got[2].to(getattr(torch, p_dtype)).float().numpy())
    with pytest.raises(ValueError, match="multiple of 8192"):
        tfk.fused_adamw_leaf(torch.zeros(4096), *(torch.zeros(4096) for _ in range(3)),
                             torch.from_numpy(scalars), **kw, p_dtype=torch.float32)


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float32])
def test_fused_adamw_leaf_writes_out_in_place(p_dtype):
    """With ``out`` the new param lands in that tensor (the donated param)
    and equals the fresh-tensor result; an ``out`` of the wrong dtype or
    shape raises."""
    rs = np.random.RandomState(6)
    n = 8192
    g = torch.from_numpy(_bf16(rs.randn(n))).to(torch.bfloat16).reshape(8, 1024)
    state = [torch.from_numpy(a) for a in (rs.randn(n).astype(np.float32) * 0.1,
                                           np.abs(rs.randn(n)).astype(np.float32) * 0.01,
                                           rs.randn(n).astype(np.float32))]
    scalars = torch.tensor([[0.5, 1e-2, 0.5, 0.3]])
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, p_dtype=p_dtype)
    fresh = tfk.fused_adamw_leaf(g, *(t.clone() for t in state), scalars, **kw)[3]
    out = torch.zeros(g.shape, dtype=p_dtype)
    got = tfk.fused_adamw_leaf(g, *(t.clone() for t in state), scalars, **kw, out=out)[3]
    assert got is out
    assert torch.equal(out, fresh)
    for bad in (torch.zeros(g.shape, dtype=torch.float16), torch.zeros(n, dtype=p_dtype)):
        with pytest.raises(ValueError, match="out must be"):
            tfk.fused_adamw_leaf(g, *state, scalars, **kw, out=bad)


@pytest.mark.parametrize("form", ["update_and_params", "update_and_params_local"])
def test_update_and_params_out_writes_the_given_tensors(form):
    """``out`` (the step passes the donated params) receives the new params
    in its own tensors, with the values the fresh-tensor form gives."""
    rs = np.random.RandomState(3)
    params, grads = _tree(rs), _tree(rs)
    tx = adamw_fp32_master(1e-2, weight_decay=0.01)
    runs = []
    for in_place in (False, True):
        p = _to_torch(params)
        ptrs = {n: t.data_ptr() for n, t in p.items()}
        new, _ = getattr(tx, form)(_to_torch(grads), tx.init(p), p, scale=torch.tensor(0.5),
                                   out=p if in_place else None)
        assert all((new[n].data_ptr() == ptrs[n]) == in_place for n in p), form
        runs.append(new)
    for n in params:
        assert torch.equal(runs[0][n], runs[1][n]), n


def _tree(rs):
    """A bf16 leaf the kernel takes (8192 elements), a bf16 leaf it does not,
    and an fp32 one."""
    return {"w": _bf16(rs.randn(64, 128) * 3), "u": _bf16(rs.randn(96, 40)),
            "b": rs.randn(40).astype(np.float32)}


def _to_jax(tree):
    return {n: jnp.asarray(a, jnp.bfloat16 if n != "b" else jnp.float32) for n, a in tree.items()}


def _to_torch(tree):
    return {n: torch.from_numpy(a.copy()).to(torch.bfloat16 if n != "b" else torch.float32)
            for n, a in tree.items()}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


@pytest.mark.parametrize("form", ["update", "update_and_params", "update_and_params_local"])
def test_adamw_fp32_master_three_steps_match_jax(form):
    rs = np.random.RandomState(0)
    params = _tree(rs)
    grads = [_tree(rs) for _ in range(3)]
    scales = [None, 0.5, 0.25] if form != "update" else [None] * 3
    sched = lambda c: 1e-2 / (1.0 + c)  # noqa: E731
    jtx, ttx = j_adamw(sched, weight_decay=0.01), adamw_fp32_master(sched, weight_decay=0.01)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g, sc in zip(grads, scales):
        jg, tg = _to_jax(g), _to_torch(g)
        if form == "update":
            ju, js = jtx.update(jg, js, jp)
            jp = {n: (jp[n] + ju[n]).astype(jp[n].dtype) for n in jp}
            tu, ts = ttx.update(tg, ts, tp)
            tp = {n: (tp[n] + tu[n]).to(tp[n].dtype) for n in tp}
        else:
            jp, js = getattr(jtx, form)(jg, js, jp, scale=None if sc is None else jnp.float32(sc))
            tp, ts = getattr(ttx, form)(tg, ts, tp, scale=None if sc is None else torch.tensor(sc))
    assert int(ts.count) == int(js.count) == 3
    for name in params:
        for part in ("mu", "nu", "master"):
            np.testing.assert_allclose(_np(getattr(ts, part)[name]),
                                       _np(getattr(js, part)[name]), rtol=RTOL, atol=1e-7,
                                       err_msg=f"{form} {part} {name}")
        np.testing.assert_allclose(_np(tp[name]), _np(jp[name]), rtol=2 ** -7, atol=1e-6,
                                   err_msg=f"{form} param {name}")


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_grad_norm_and_clip_match_jax(norm_type):
    rs = np.random.RandomState(1)
    g = _tree(rs)
    want = jgrads.get_grad_norm(_to_jax(g), norm_type)
    got = tgrads.get_grad_norm(_to_torch(g), norm_type)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    for max_norm in (1.0, 1e6):                          # clipped, then untouched
        jc, jn = jgrads.clip_grad_norm(_to_jax(g), max_norm, norm_type)
        tc, tn = tgrads.clip_grad_norm(_to_torch(g), max_norm, norm_type)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        for n in g:
            assert tc[n].dtype == _to_torch(g)[n].dtype
            np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), rtol=2 ** -7, atol=1e-7)
    assert float(tgrads.get_grad_norm({})) == 0.0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_parallel_cross_entropy_matches_jax(smoothing, ignore_index):
    rs = np.random.RandomState(2)
    logits = (rs.randn(2, 24, 50) * 3).astype(np.float32)
    labels = rs.randint(0, 50, (2, 24)).astype(np.int32)
    labels[0, :5] = -100
    want = jloss.parallel_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing,
                                        ignore_index)
    got = tloss.parallel_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       smoothing, ignore_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    want_m = jloss.parallel_cross_entropy_mean(jnp.asarray(logits), jnp.asarray(labels),
                                               smoothing, ignore_index)
    tl_ = torch.from_numpy(logits).requires_grad_(True)
    got_m = tloss.parallel_cross_entropy_mean(tl_, torch.from_numpy(labels), smoothing,
                                              ignore_index)
    np.testing.assert_allclose(float(got_m.detach()), float(want_m), rtol=RTOL)
    want_g = jax.grad(lambda x: jloss.parallel_cross_entropy_mean(
        x, jnp.asarray(labels), smoothing, ignore_index))(jnp.asarray(logits))
    got_m.backward()
    np.testing.assert_allclose(tl_.grad.numpy(), np.asarray(want_g), atol=1e-7)
