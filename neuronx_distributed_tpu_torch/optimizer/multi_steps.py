"""Gradient accumulation across optimizer calls: the port's counterpart of
``optax.MultiSteps``.

The JAX package's managed fit loop wraps its optimizer in
``optax.MultiSteps(tx, every_k_schedule=k)`` (``lightning/module.py``):
each call of the train step is one microstep on a whole batch; the
gradients of ``k`` microsteps are averaged (optax's running mean,
``acc + (g - acc) / (n + 1)``, in the gradient's dtype) and the wrapped
optimizer runs once on the mean, at every ``k``-th call. The params stay as
they are on the other calls, and the wrapped optimizer's count, and so its
bias correction and learning-rate schedule, counts the applied updates
only. This is not ``make_train_step(grad_accum_steps=k)``, which splits
one batch into ``k`` microbatches inside one optimizer call.

:func:`multi_steps` wraps any :class:`FusedGradientTransformation`; every
form of the wrapper accumulates and, on the ``k``-th microstep, calls the
same form of the wrapped one. The clip ``scale`` a fused form is given
scales the microstep's gradient before it enters the mean (JAX clips each
microstep's gradients the same way, ``clip_grad_norm`` before
``tx.update``). The accumulator and the microstep counter live in the
state (:class:`MultiStepsState`), so a checkpoint taken inside a window
resumes it exactly; the counters are host integers (the step decides on
the host whether this call applies the update, without a read from the
device). Built from the state's ZeRO-1 shards, the accumulator is sharded
as the moments are.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from neuronx_distributed_tpu_torch.optimizer.adamw import FusedGradientTransformation

Tree = Dict[str, torch.Tensor]


class MultiStepsState(NamedTuple):
    mini_step: int            # microsteps taken in the current window
    gradient_step: int        # updates the wrapped optimizer has applied
    inner_opt_state: Any
    acc_grads: Tree           # the window's running mean, in the grads' dtype

    def clone(self) -> "MultiStepsState":
        return MultiStepsState(self.mini_step, self.gradient_step, self.inner_opt_state.clone(),
                               {n: t.clone() for n, t in self.acc_grads.items()})


def multi_steps(inner: FusedGradientTransformation, every_k: int) -> FusedGradientTransformation:
    """``inner`` applied once every ``every_k`` calls, to the mean of those
    calls' gradients (``optax.MultiSteps`` with ``use_grad_mean=True``)."""
    k = int(every_k)
    if k < 1:
        raise ValueError(f"every_k must be >= 1, got {every_k}")

    def init_fn(params: Tree) -> MultiStepsState:
        return MultiStepsState(0, 0, inner.init(params),
                               {n: torch.zeros_like(p) for n, p in params.items()})

    def _accumulate(grads: Tree, state: MultiStepsState, scale) -> bool:
        """Fold this microstep's gradients into the running mean (in place);
        whether the window ends here."""
        n = state.mini_step
        for name, g in grads.items():
            if scale is not None:
                g = (g.float() * scale).to(g.dtype)
            acc = state.acc_grads[name]
            acc.copy_(acc + (g - acc) / (n + 1))
        return n == k - 1

    def _advance(state: MultiStepsState, emit: bool, inner_state) -> MultiStepsState:
        if emit:
            for acc in state.acc_grads.values():
                acc.zero_()
        return state._replace(mini_step=(state.mini_step + 1) % k,
                              gradient_step=state.gradient_step + int(emit),
                              inner_opt_state=inner_state)

    def _held(params: Tree, out: Optional[Tree]) -> Tree:
        """The params unchanged, written into ``out`` where it is another
        tensor."""
        if out is None:
            return dict(params)
        return {n: out[n] if out[n].data_ptr() == p.data_ptr() else out[n].copy_(p)
                for n, p in params.items()}

    def update_fn(grads: Tree, state: MultiStepsState, params: Optional[Tree] = None):
        emit = _accumulate(grads, state, None)
        if emit:
            updates, inner_state = inner.update(state.acc_grads, state.inner_opt_state, params)
        else:
            updates = {n: torch.zeros_like(g) for n, g in grads.items()}
            inner_state = state.inner_opt_state
        return updates, _advance(state, emit, inner_state)

    def _fused(form):
        def fn(grads: Tree, state: MultiStepsState, params: Tree, scale=None,
               out: Optional[Tree] = None):
            emit = _accumulate(grads, state, scale)
            if emit:
                new, inner_state = form(state.acc_grads, state.inner_opt_state, params, out=out)
            else:
                new, inner_state = _held(params, out), state.inner_opt_state
            return new, _advance(state, emit, inner_state)

        return fn

    return FusedGradientTransformation(init_fn, update_fn, _fused(inner.update_and_params),
                                       _fused(inner.update_and_params_local))
