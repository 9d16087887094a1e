"""Speculative (draft-model assisted) decoding, batch 1.

Counterpart of ``neuronx_distributed_tpu/inference/speculative.py``. A draft
``CausalLM`` proposes ``num_draft`` (γ) tokens a round; the target scores
``[last, p1..pγ]`` in one cached forward and a prefix is accepted:

* greedy: the longest prefix where the proposal equals the target's argmax;
* sampled (speculative sampling): proposal i is accepted with probability
  ``min(1, p_target / p_draft)``; at the first rejection the next token is
  drawn from ``normalize(max(p_t - p_d, 0))`` (all accepted: from ``p_t``),
  so the tokens follow the target's own sampling distribution.

Rejected positions are rolled back by writing the accepted length into both
caches' ``cache_index`` in place; the stale entries sit behind the
position mask until later writes overwrite them.

:func:`speculative_generate` is the host loop (per round: the draft's
``spec_propose`` program, the target's ``spec_verify`` program, the
acceptance on the device, one fetch). :func:`speculative_decode_fused` runs
``rounds_per_block`` whole rounds as ONE program (:func:`_compile_block`:
one captured graph on CUDA), branch free: masks where the host loop
branches, the rollback written into ``cache_index`` in place, the draft's
hole fill fed every round (with a rejected tail its write lands past the
rolled-back length). A block costs one program call and one fetch.

Noise (the port's sampled-stream contract): every draw is counter based on
the device (``sampling.counter_gumbel``/``counter_uniform``), keyed by the
run's ``seed`` and a tag, at the round index — proposal i of round r at
count ``r * γ + i``, the acceptance uniforms and the residual's Gumbel
noise at count r — so the host loop and the fused block draw the same
noise and emit the same tokens. :func:`_accept_core` is the acceptance
given its noise; a JAX run's noise fed to it gives the JAX run's decisions.

The target and the draft are two ``CausalLM`` s on the contiguous slab
path with one ``max_batch``; each runs on its own device state, so a
self-draft is a second ``CausalLM`` on the same weight tensors (the tensors
are shared, not copied).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.causal_lm import (
    CausalLM,
    GenerationResult,
    infer_prompt_lengths,
    percentile_ms,
)
from neuronx_distributed_tpu_torch.inference.model_builder import CapturedProgram
from neuronx_distributed_tpu_torch.inference.sampling import (
    categorical_from_gumbel,
    counter_gumbel,
    counter_uniform,
    request_seed,
    split_key,
)

# noise streams of a run: the first token, the proposals, the acceptance
# uniforms, the residual draw
_TAGS = (0, 1, 2, 3)
# the fused block's state vector: last token, accepted length, tokens
# emitted, done, round index, then (lo, hi) of the proposal, acceptance and
# residual keys
_STATE = 11


def _keys(seed: int) -> np.ndarray:
    """The four streams' keys as int32 (lo, hi) pairs, in ``_TAGS`` order."""
    return np.asarray([split_key(request_seed(seed, t)) for t in _TAGS], np.int32)


def _propose(draft: CausalLM, num_draft: int, greedy: bool, temperature: float,
             last_tok: torch.Tensor, key: torch.Tensor, round_idx: torch.Tensor):
    """γ draft steps from ``last_tok`` (b, 1) on the draft's cache (advanced
    in place). The one proposal body of the host loop's program and of the
    fused block. ``key`` (2,) int32, ``round_idx`` (1,) int32. Returns
    ``(toks (γ, b) int32, probs (γ, b, V) fp32, or (γ, b, 1) zeros when
    greedy)``."""
    toks, probs = [], []
    tok = last_tok
    b = tok.shape[0]
    for i in range(num_draft):
        logits = draft._forward(tok, draft._cache)[:, 0].float()
        if greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            p = logits.new_zeros((b, 1))
        else:
            counts = (round_idx.long() * num_draft + i).expand(b)
            g = counter_gumbel(key[0:1].expand(b), key[1:2].expand(b), counts,
                               logits.shape[-1])
            nxt = categorical_from_gumbel(logits / temperature, g)
            p = torch.softmax(logits / temperature, dim=-1)
        toks.append(nxt)
        probs.append(p)
        tok = nxt[:, None]
    return torch.stack(toks), torch.stack(probs)


def _accept_core(t_logits: torch.Tensor, proposals: torch.Tensor, draft_probs: torch.Tensor,
                 u: Optional[torch.Tensor], gumbel: Optional[torch.Tensor], greedy: bool,
                 temperature: float):
    """Acceptance for one row given its noise. ``t_logits`` (γ+1, V) the
    target's logits at the chunk positions, ``proposals`` (γ,),
    ``draft_probs`` (γ, V); sampled: ``u`` (γ,) uniforms and ``gumbel`` (V,)
    the residual draw's noise. Returns ``(accepted (), next_token ())`` as
    device tensors (JAX ``_accept``, its ``jax.random`` draws replaced by
    the given noise)."""
    gamma = proposals.shape[0]
    t_logits = t_logits.float()
    if greedy:
        t_choice = torch.argmax(t_logits, dim=-1).to(torch.int32)
        acc = torch.cumprod((proposals == t_choice[:gamma]).long(), 0).sum()
        return acc, t_choice.index_select(0, acc.view(1))[0]
    p_t = torch.softmax(t_logits / temperature, dim=-1)
    idx = torch.arange(gamma, device=p_t.device)
    prop = proposals.long()
    p_i, q_i = p_t[idx, prop], draft_probs[idx, prop]
    accept_i = u < torch.clamp_max(p_i / torch.clamp_min(q_i, 1e-20), 1.0)
    acc = torch.cumprod(accept_i.long(), 0).sum()
    q_ext = torch.cat([draft_probs, torch.zeros_like(p_t[-1:])], dim=0)
    p_a = p_t.index_select(0, acc.view(1))[0]
    resid = torch.clamp_min(p_a - q_ext.index_select(0, acc.view(1))[0], 0.0)
    norm = resid.sum()
    resid = torch.where(norm > 0, resid / torch.clamp_min(norm, 1e-20), p_a)
    nxt = torch.argmax(torch.log(torch.clamp_min(resid, 1e-30)) + gumbel).to(torch.int32)
    return acc, nxt


def _accept(t_logits, proposals, draft_probs, keys: torch.Tensor, round_idx: torch.Tensor,
            greedy: bool, temperature: float):
    """:func:`_accept_core` under the run's counter noise at ``round_idx``:
    ``keys`` (4, 2) int32 (``_TAGS`` order)."""
    if greedy:
        return _accept_core(t_logits, proposals, draft_probs, None, None, True, temperature)
    r = round_idx.long()
    u = counter_uniform(keys[2, 0:1], keys[2, 1:2], r, proposals.shape[0])[0]
    g = counter_gumbel(keys[3, 0:1], keys[3, 1:2], r, t_logits.shape[-1])[0]
    return _accept_core(t_logits, proposals, draft_probs, u, g, False, temperature)


def _first_token(logits: torch.Tensor, keys: np.ndarray, greedy: bool,
                 temperature: float) -> int:
    """The first generated token from the prefill's last logits (V,)."""
    logits = logits.float()
    if greedy:
        return int(torch.argmax(logits))
    k = torch.as_tensor(keys[0], device=logits.device)
    g = counter_gumbel(k[0:1], k[1:2], torch.zeros((1,), dtype=torch.int64,
                                                   device=logits.device), logits.shape[-1])
    return int(categorical_from_gumbel(logits[None] / temperature, g)[0])


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mode(greedy: bool, temperature: float) -> str:
    return "greedy" if greedy else f"t{float(temperature)!r}"


def _make_proposer(draft: CausalLM, num_draft: int, greedy: bool, temperature: float):
    """The draft's ``spec_propose_g{γ}_{mode}`` program: inputs ``last_tok``
    (b, 1) and ``noise`` (3,) int32 (the proposal key and the round index)."""
    def body(last_tok, noise):
        return _propose(draft, num_draft, greedy, temperature, last_tok, noise[0:2],
                        noise[2:3])

    sig = f"spec_propose_g{num_draft}_{_mode(greedy, temperature)}"
    return lambda last_tok, noise: draft._run(draft._default_state(), sig, body, [last_tok, noise])


def _set_lengths(lm: CausalLM, session, length: int) -> None:
    """Roll the slot state to ``length`` in row 0 and 0 elsewhere (host
    mirror and device)."""
    lens = np.zeros((lm.max_batch,), np.int32)
    lens[0] = length
    session.lengths[:] = lens
    lm._cache.cache_index.copy_(lm._ids(lens))


def _check_pair(target: CausalLM, draft: CausalLM) -> None:
    if draft is target:
        raise ValueError("the draft must be its own CausalLM (each runs on its own device "
                         "state); for a self-draft build a second one on the same weights")
    if getattr(target, "tp", 1) > 1 or getattr(draft, "tp", 1) > 1:
        raise NotImplementedError("speculation under tensor parallelism is not ported "
                                  "(ROADMAP queue A)")
    if target.paged or draft.paged:
        raise ValueError("speculation runs on the contiguous slab path (no page_size)")
    if draft.max_batch != target.max_batch or draft.device != target.device:
        raise ValueError("target and draft need one max_batch and one device")


def _prefill(target: CausalLM, draft: CausalLM, prompt_ids: np.ndarray, max_new_tokens: int,
             num_draft: int, pad_token_id: int, prompt_length: Optional[int]):
    """Both models' ``prefill_b{bucket}`` on the padded prompt (row 0; the
    other rows empty), their lengths rolled to the prompt's. Returns
    ``(length, target sessions, target last logits (V,))``."""
    if prompt_ids.shape[0] != 1:
        raise ValueError("speculation handles batch size 1")
    _check_pair(target, draft)
    b, s = target.max_batch, prompt_ids.shape[1]
    length = (int(prompt_length) if prompt_length is not None
              else int(infer_prompt_lengths(prompt_ids, pad_token_id)[0]))
    if length + max_new_tokens + num_draft + 1 > target.config.max_seq_len:
        raise ValueError(f"prompt ({length}) + max_new_tokens ({max_new_tokens}) + draft window "
                         f"({num_draft + 1}) exceeds max_seq_len {target.config.max_seq_len}")
    bucket = target._bucket_for(s)
    ids = np.zeros((b, bucket), np.int32)
    ids[0, :s] = prompt_ids[0]
    lens = np.ones((b,), np.int32)
    lens[0] = length
    sessions, logits = [], []
    for lm in (target, draft):
        sess = lm.start_session()
        if not lm.compiled:
            lm.compile()
        logits.append(lm.insert(sess, np.arange(b), ids, lengths=lens)[0])
        _set_lengths(lm, sess, length)
        sessions.append(sess)
    return length, bucket, sessions, logits[0]


def speculative_generate(target: CausalLM, draft: CausalLM, prompt_ids: np.ndarray,
                         max_new_tokens: int, num_draft: int = 4,
                         eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                         prompt_length: Optional[int] = None, greedy: bool = True,
                         temperature: float = 1.0, seed: int = 0,
                         collect_stats: bool = False) -> GenerationResult:
    """Assisted decoding of one prompt, the host loop (JAX
    ``speculative_generate``; ``seed`` keys the counter noise where JAX
    takes an ``rng``). ``greedy=False`` switches to sampling acceptance at
    ``temperature``. Stops at ``eos_token_id``. ``collect_stats`` also
    times the draft and verify programs (two more host waits a round).
    ``result.stats``: ``rounds``, ``num_draft``, ``proposed``,
    ``accepted``, ``acceptance_rate``, ``tokens_per_round`` and the
    ``round/draft/verify_ms_p50/p90`` percentiles."""
    length, _, (t_sess, d_sess), first = _prefill(
        target, draft, prompt_ids, max_new_tokens, num_draft, pad_token_id, prompt_length)
    b, dev = target.max_batch, target.device
    keys_np = _keys(seed)
    keys = target._ids(keys_np)
    proposer = _make_proposer(draft, num_draft, greedy, temperature)

    def verify_body(ids):
        return target._forward(ids, target._cache).float()

    out = [_first_token(first, keys_np, greedy, temperature)]
    cur_len = length
    rounds = accepted_total = 0
    round_times, draft_times, verify_times = [], [], []
    while len(out) < max_new_tokens and (eos_token_id is None or out[-1] != eos_token_id):
        t_round = time.perf_counter()
        # 1. the draft proposes γ tokens in one program
        last = np.full((b, 1), out[-1], np.int32)
        noise = np.asarray([*keys_np[1], rounds], np.int32)
        toks, probs = proposer(last, noise)
        if collect_stats:   # extra host wait, benchmarking only
            _wait(dev)
            draft_times.append(time.perf_counter() - t_round)
        # 2. the target scores [last, p1..pγ] in one chunked forward
        t_verify = time.perf_counter()
        chunk = torch.cat([torch.full((b, 1), out[-1], dtype=torch.int32, device=dev),
                           toks[:, 0][None, :].expand(b, num_draft)], dim=1)
        t_logits = target._run(target._default_state(), f"spec_verify_s{num_draft + 1}",
                               verify_body, [chunk])
        if collect_stats:
            _wait(dev)
            verify_times.append(time.perf_counter() - t_verify)
        # 3. acceptance on the device, one fetch with the proposals
        acc, nxt = _accept(t_logits[0], toks[:, 0], probs[:, 0], keys,
                           torch.full((1,), rounds, dtype=torch.int32, device=dev),
                           greedy, temperature)
        got = torch.cat([acc.view(1).to(torch.int32), nxt.view(1), toks[:, 0]]).cpu().numpy()
        accepted, proposals = int(got[0]), [int(t) for t in got[2:]]
        new_tokens = proposals[:accepted] + [int(got[1])]
        if eos_token_id is not None and eos_token_id in new_tokens:
            new_tokens = new_tokens[: new_tokens.index(eos_token_id) + 1]
        out.extend(new_tokens)
        cur_len += len(new_tokens)
        # the draft consumed [last, p1..p(γ-1)]: with every proposal accepted
        # slot old+γ must hold pγ, fed once (its logits unused)
        if accepted == num_draft:
            draft._decode_step(d_sess, draft._ids(np.full((b, 1), proposals[-1], np.int32)))
        _set_lengths(target, t_sess, cur_len)
        _set_lengths(draft, d_sess, cur_len)
        rounds += 1
        accepted_total += accepted
        round_times.append(time.perf_counter() - t_round)

    out = out[:max_new_tokens]
    tokens = np.zeros((1, max_new_tokens), np.int64)
    tokens[0, :len(out)] = out
    pct = percentile_ms
    stats = {
        "rounds": rounds, "num_draft": num_draft, "proposed": rounds * num_draft,
        "accepted": accepted_total,
        "acceptance_rate": round(accepted_total / max(rounds * num_draft, 1), 4),
        "tokens_per_round": round(len(out) / max(rounds, 1), 2),
        "round_ms_p50": pct(round_times, 50), "round_ms_p90": pct(round_times, 90),
        "draft_ms_p50": pct(draft_times, 50), "draft_ms_p90": pct(draft_times, 90),
        "verify_ms_p50": pct(verify_times, 50), "verify_ms_p90": pct(verify_times, 90),
    }
    return GenerationResult(tokens=tokens, lengths=np.asarray([len(out)], np.int32),
                            stats=stats)


def _build_round_block(target: CausalLM, draft: CausalLM, num_draft: int, rounds: int,
                       greedy: bool, temperature: float, eos_token_id: Optional[int],
                       pad_token_id: int, max_new_tokens: int):
    """The fused body: ``rounds`` complete rounds (propose, verify, accept,
    rollback, hole fill) over the state vector (``_STATE`` int32, see
    there), branch free. Rounds after EOS or the budget are frozen by a
    length mask: they keep nothing, emit ``pad_token_id``, and leave the
    last token and lengths as they were. Returns one int32 vector: the
    rounds' emissions (rounds, γ+1), kept counts (rounds,), accepted counts
    (rounds,), then the next state."""
    b, g1 = target.max_batch, num_draft + 1

    def body(state):
        dev = state.device
        idx_vec = torch.arange(g1, device=dev)
        last_tok, cur_len, emitted = state[0], state[1], state[2]
        done, r = state[3] != 0, state[4:5]
        keys = state[5:11].view(3, 2)
        acc_keys = torch.cat([keys.new_zeros((1, 2)), keys])   # (4, 2) in _TAGS order
        emits, keeps, accs = [], [], []
        row0 = torch.arange(b, device=dev) == 0
        for _ in range(rounds):
            last = last_tok.view(1, 1).expand(b, 1)
            toks, probs = _propose(draft, num_draft, greedy, temperature, last, keys[0], r)
            proposals = toks[:, 0]
            chunk = torch.cat([last, proposals[None, :].expand(b, num_draft)], dim=1)
            t_logits = target._forward(chunk, target._cache).float()
            acc, nxt = _accept(t_logits[0], proposals, probs[:, 0], acc_keys, r, greedy,
                               temperature)
            props_ext = torch.cat([proposals, proposals[-1:]])
            round_toks = torch.where(idx_vec < acc, props_ext, nxt)
            n_keep = acc + 1
            if eos_token_id is not None:
                kept_eos = (round_toks == eos_token_id) & (idx_vec < n_keep)
                n_keep = torch.where(kept_eos.any(), torch.argmax(kept_eos.long()) + 1, n_keep)
            n_keep = torch.where(done, 0, n_keep)
            round_toks = torch.where(idx_vec < n_keep, round_toks, pad_token_id)
            at = torch.clamp_min(n_keep - 1, 0).view(1)
            last_tok = torch.where(done, last_tok, round_toks.index_select(0, at)[0])
            # hole fill, unconditional: with a rejected tail the write lands
            # past the rolled-back length and stays invisible
            draft._forward(proposals[-1:].view(1, 1).expand(b, 1), draft._cache)
            cur_len = cur_len + n_keep
            emitted = emitted + n_keep
            done = done | (emitted >= max_new_tokens)
            if eos_token_id is not None:
                done = done | ((round_toks == eos_token_id) & (idx_vec < n_keep)).any()
            lens = torch.where(row0, cur_len, 0).to(torch.int32)
            target._cache.cache_index.copy_(lens)
            draft._cache.cache_index.copy_(lens)
            emits.append(round_toks.to(torch.int32))
            keeps.append(n_keep)
            accs.append(acc)
            r = r + 1
        head = torch.stack([t.to(torch.int32) for t in (last_tok, cur_len, emitted, done)])
        nxt_state = torch.cat([head, r, state[5:11]])
        return torch.cat([torch.stack(emits).flatten(), torch.stack(keeps).to(torch.int32),
                          torch.stack(accs).to(torch.int32), nxt_state])

    return body


def _compile_block(target: CausalLM, draft: CausalLM, num_draft: int, rounds: int,
                   greedy: bool, temperature: float, eos_token_id: Optional[int],
                   pad_token_id: int, max_new_tokens: int):
    """The R-round block as one program over the state vector: on CUDA a
    graph captured at its first call (in the target's graph pool), on the
    CPU the eager body. A module-level function, so a test can wrap what it
    returns and count the calls (at most two host operations a block)."""
    body = _build_round_block(target, draft, num_draft, rounds, greedy, temperature,
                              eos_token_id, pad_token_id, max_new_tokens)
    pool = target._graph_pool() if target.device.type == "cuda" else None
    return CapturedProgram(body, target.device, pool,
                           name=f"spec_block_g{num_draft}_r{rounds}")


def speculative_decode_fused(target: CausalLM, draft: CausalLM, prompt_ids: np.ndarray,
                             max_new_tokens: int, num_draft: int = 4, rounds_per_block: int = 8,
                             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                             prompt_length: Optional[int] = None, greedy: bool = True,
                             temperature: float = 1.0, seed: int = 0) -> GenerationResult:
    """Speculation with ``rounds_per_block`` whole rounds per program call:
    per block one call and one fetch (``host_dispatches_per_block == 2``).
    Tokens equal :func:`speculative_generate`'s, greedy and sampled (the
    same counter noise). The block is kept on the target per (draft, γ, R,
    sampling, limits, bucket). ``result.stats``: the host loop's counts,
    ``rounds_per_block``, ``fused_block_calls``,
    ``host_dispatches_per_block`` and ``block_ms_p50/p90``."""
    if rounds_per_block < 1:
        raise ValueError(f"rounds_per_block must be >= 1, got {rounds_per_block}")
    length, bucket, _, first = _prefill(
        target, draft, prompt_ids, max_new_tokens, num_draft, pad_token_id, prompt_length)
    keys_np = _keys(seed)
    first_tok = _first_token(first, keys_np, greedy, temperature)
    out = [first_tok]
    rounds = accepted_total = block_calls = 0
    block_times = []
    done_h = len(out) >= max_new_tokens or (eos_token_id is not None
                                             and first_tok == eos_token_id)
    if not done_h:
        key = (id(draft), num_draft, rounds_per_block, greedy, float(temperature),
               eos_token_id, pad_token_id, max_new_tokens, bucket)
        # the block is bound to both sessions' buffers: kept on the target's
        # state, keyed by the draft's
        store = target._default_state().extras.setdefault("spec_fused", {})
        key = key + (draft._default_state().index,)
        block = store.get(key)
        if block is None:
            block = store[key] = _compile_block(
                target, draft, num_draft, rounds_per_block, greedy, temperature, eos_token_id,
                pad_token_id, max_new_tokens)
        state = target._ids(np.asarray([first_tok, length, 1, 0, 0, *keys_np[1:].reshape(-1)],
                                       np.int32))
        R, g1 = rounds_per_block, num_draft + 1
        while not done_h:
            t0 = time.perf_counter()
            res = block(state)               # host op 1 of 2: the program call
            block_calls += 1
            got = res.cpu().numpy()          # host op 2 of 2: one fetch
            state = res[-_STATE:]
            toks = got[:R * g1].reshape(R, g1)
            keeps, accs = got[R * g1:R * g1 + R], got[R * g1 + R:R * g1 + 2 * R]
            for i in range(R):
                k = int(keeps[i])
                if k == 0:
                    continue   # a frozen round
                out.extend(int(t) for t in toks[i, :k])
                rounds += 1
                accepted_total += int(accs[i])
            done_h = bool(got[-_STATE + 3])
            block_times.append(time.perf_counter() - t0)
    out = out[:max_new_tokens]
    tokens = np.zeros((1, max_new_tokens), np.int64)
    tokens[0, :len(out)] = out
    pct = percentile_ms
    stats = {
        "rounds": rounds, "num_draft": num_draft, "proposed": rounds * num_draft,
        "accepted": accepted_total,
        "acceptance_rate": round(accepted_total / max(rounds * num_draft, 1), 4),
        "tokens_per_round": round(len(out) / max(rounds, 1), 2),
        "rounds_per_block": rounds_per_block, "fused_block_calls": block_calls,
        "host_dispatches_per_block": 2,
        "block_ms_p50": pct(block_times, 50), "block_ms_p90": pct(block_times, 90),
    }
    return GenerationResult(tokens=tokens, lengths=np.asarray([len(out)], np.int32),
                            stats=stats)
