"""Token samplers of the PyTorch port against the JAX package.

The top-k/top-p masks and greedy picks must be identical on the same
logits (ties included: exactly k survive top-k, the lower index first).
The two frameworks' generators give different bits, so a sampled draw is
checked through its pure core: given the Gumbel noise that
``jax.random.gumbel`` makes for a key, the port picks the token that
``jax.random.categorical`` picks for that key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import sampling as js
from neuronx_distributed_tpu_torch.inference import sampling as ts


def _tied_logits(seed, shape=(6, 16)):
    # small integers: many ties, some at the k-th value
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", [(1, None), (3, None), (7, None), (None, 0.5),
                                         (None, 0.9), (4, 0.8), (16, None)])
def test_top_k_top_p_masks_identical_with_ties(top_k, top_p):
    logits = _tied_logits(seed=top_k or 0)
    want = np.asarray(js.apply_top_k_top_p(jnp.asarray(logits), top_k, top_p))
    got = ts.apply_top_k_top_p(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if top_k is not None and top_p is None:
        assert np.all((got > -1e29).sum(-1) == top_k)   # exactly k, ties or not


def test_top_k_larger_than_vocab_raises_on_both_sides():
    logits = _tied_logits(seed=1, shape=(2, 8))
    with pytest.raises(ValueError, match="exceeds vocab"):
        js.apply_top_k_top_p(jnp.asarray(logits), 9, None)
    with pytest.raises(ValueError, match="exceeds vocab"):
        ts.apply_top_k_top_p(torch.from_numpy(logits), 9, None)


def test_greedy_identical():
    logits = np.random.default_rng(3).standard_normal((5, 64)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    for sampler in (dict(greedy=True), dict(temperature=0.0)):
        want = np.asarray(js.Sampler(**sampler)(jnp.asarray(logits), key))
        got = ts.Sampler(**sampler)(torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
    temp = np.array([0.0, 0.7, 0.0, 1.3, 0.0], np.float32)
    greedy = temp == 0.0
    jslot = js.SlotSampler()(jnp.asarray(logits), jax.random.split(key, 5),
                             jnp.asarray(temp), jnp.asarray(greedy))
    tslot = ts.SlotSampler()(torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(greedy))   # no noise: every row argmax
    np.testing.assert_array_equal(tslot.numpy()[greedy], np.asarray(jslot)[greedy])


@pytest.mark.parametrize("sampler", [dict(temperature=1.0), dict(temperature=0.7, top_k=10),
                                     dict(temperature=1.3, top_p=0.9),
                                     dict(temperature=0.8, top_k=20, top_p=0.95)])
def test_sampled_draw_matches_jax_given_its_gumbel_noise(sampler):
    logits = np.random.default_rng(4).standard_normal((8, 64)).astype(np.float32) * 2
    hits = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(js.Sampler(**sampler)(jnp.asarray(logits), key))
        noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = ts.Sampler(**sampler)(torch.from_numpy(logits),
                                    gumbel=torch.from_numpy(noise)).numpy()
        np.testing.assert_array_equal(got, want)
        hits += int((want != logits.argmax(-1)).sum())
    assert hits > 0   # the noise really moved some draws off the argmax


def test_slot_sampler_per_row_keys_match_jax():
    """The engine's per-request keys: each row draws under its own key."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 32)).astype(np.float32) * 2
    temp = np.array([0.0, 0.9, 1.2, 0.0, 0.5, 2.0], np.float32)
    greedy = np.array([True, False, False, False, False, False])
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    sampler = dict(top_k=12, top_p=0.9)
    want = np.asarray(js.SlotSampler(**sampler)(jnp.asarray(logits), keys, jnp.asarray(temp),
                                                jnp.asarray(greedy)))
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (32,), jnp.float32))(keys))
    got = ts.SlotSampler(**sampler)(torch.from_numpy(logits), torch.from_numpy(temp),
                                    torch.from_numpy(greedy), torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def test_draw_with_explicit_generator_follows_softmax():
    """The port's own draw: noise from an explicit ``torch.Generator``,
    reproducible for a seed, with frequencies close to the softmax."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(20000, 4)
    sampler = ts.Sampler(temperature=1.0)
    a = sampler(logits, torch.Generator().manual_seed(0))
    b = sampler(logits, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    freq = torch.bincount(a.long(), minlength=4).float() / a.numel()
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0], -1).numpy(), atol=0.015)
    with pytest.raises(ValueError, match="Generator"):
        sampler(logits)
