"""AdamW with fp32 master params for bf16 training, and plain AdamW.

Counterpart of ``neuronx_distributed_tpu/optimizer/adamw.py``: the state
keeps ``mu``, ``nu`` and an fp32 ``master`` copy of each param; new params
are the cast of the new master. Trees are dicts of tensors keyed by the
port's parameter names. The math and its order of operations are the JAX
package's, so the numbers match it.

:func:`adamw` is the optimizer the JAX trainer takes under
``use_master_weights=False`` (``optax.adamw``): plain tensor code on the
params' own dtype, in optax's order (the moments, the bias corrections cast
to the moment's dtype, eps outside the square root, the decay on the old
param, then ``-lr``), with no kernel of its own: JAX computes it in XLA,
outside any Pallas call.

Unlike the functional JAX version, every update here writes the state's
tensors in place (the JAX train step donates the old state, so its buffers
are reused the same way); a caller that must keep the old state clones it
first (:meth:`FP32MasterState.clone`). The learning rate is a float or a
callable of the pre-increment count; the count lives on the device, so no
update reads it back to the host.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

from neuronx_distributed_tpu_torch.optimizer.fused_kernel import (
    fused_adamw_leaf,
    leaf_supported,
)

Tree = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[torch.Tensor], Union[float, torch.Tensor]]]


def _f32(x, device) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``: a host float becomes a fill (no copy
    from host memory, which would wait for the device)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), x, dtype=torch.float32, device=device)


class FP32MasterState(NamedTuple):
    count: torch.Tensor   # () int32: updates taken
    mu: Tree
    nu: Tree
    master: Tree          # fp32 copies of the (possibly bf16) params

    def clone(self) -> "FP32MasterState":
        copy = lambda t: {n: x.clone() for n, x in t.items()}  # noqa: E731
        return FP32MasterState(self.count.clone(), copy(self.mu), copy(self.nu),
                               copy(self.master))


class FusedGradientTransformation(NamedTuple):
    """``init`` and ``update`` as optax has them, plus the fused forms:
    ``update_and_params(grads, state, params, scale=None, out=None) ->
    (params, state)`` emits the new params (the cast of the new master)
    without reading the old ones and folds the clip scale into the grad
    cast; with ``out`` (a tree like ``params``, for example the donated
    params themselves) the new params are written into its tensors.
    ``update_and_params_local`` is the same with supported leaves on the
    single-pass kernel (:func:`fused_adamw_leaf`) and the rest on the plain
    formula."""

    init: Callable
    update: Callable
    update_and_params: Callable
    update_and_params_local: Callable


def adamw_fp32_master(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.01
                      ) -> FusedGradientTransformation:
    """AdamW updating an fp32 master copy; ``update`` emits updates exact in
    the param dtype (``cast(master_new) - param``)."""

    def init_fn(params: Tree) -> FP32MasterState:
        dev = next(iter(params.values())).device if params else None
        return FP32MasterState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            master={n: p.detach().to(torch.float32, copy=True) for n, p in params.items()})

    def _scalars(state: FP32MasterState, scale):
        # schedules see the pre-increment count (optax convention); the bias
        # corrections use the post-increment count, in fp32
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        count = state.count + 1
        c = count.float()
        s = _f32(1.0 if scale is None else scale, c.device)
        return lr, count, s, 1 - b1 ** c, 1 - b2 ** c

    def _leaf(g, m, v, mst, lr, bc1, bc2, scale):
        """The plain update of one leaf, in place."""
        g32 = g.float() if scale is None else g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32 * g32)
        mst.copy_(mst - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * mst))

    def _advance(grads: Tree, state: FP32MasterState, scale=None) -> FP32MasterState:
        lr, count, _, bc1, bc2 = _scalars(state, scale)
        for n, g in grads.items():
            _leaf(g, state.mu[n], state.nu[n], state.master[n], lr, bc1, bc2, scale)
        return state._replace(count=count)

    def update_fn(grads: Tree, state: FP32MasterState, params: Optional[Tree] = None):
        if params is None:
            raise ValueError("adamw_fp32_master requires params")
        new_state = _advance(grads, state)
        return {n: new_state.master[n].to(p.dtype) - p for n, p in params.items()}, new_state

    def _cast(master: torch.Tensor, p: torch.Tensor, out: Optional[Tree], n: str):
        return master.to(p.dtype) if out is None else out[n].copy_(master)

    def update_and_params_fn(grads: Tree, state: FP32MasterState, params: Tree, scale=None,
                             out: Optional[Tree] = None):
        new_state = _advance(grads, state, scale)
        return {n: _cast(new_state.master[n], p, out, n) for n, p in params.items()}, new_state

    def update_and_params_local_fn(grads: Tree, state: FP32MasterState, params: Tree,
                                   scale=None, out: Optional[Tree] = None):
        lr, count, s, bc1, bc2 = _scalars(state, scale)
        scalars = torch.stack([s, _f32(lr, s.device), bc1, bc2]).reshape(1, 4)
        new_params = {}
        for n, g in grads.items():
            m, v, mst, p = state.mu[n], state.nu[n], state.master[n], params[n]
            if leaf_supported(g.numel()):
                new_params[n] = fused_adamw_leaf(g, m, v, mst, scalars, b1=b1, b2=b2, eps=eps,
                                                 wd=weight_decay, p_dtype=p.dtype,
                                                 out=None if out is None else out[n])[3]
            else:
                _leaf(g, m, v, mst, lr, scalars[0, 2], scalars[0, 3], s)
                new_params[n] = _cast(mst, p, out, n)
        return new_params, state._replace(count=count)

    return FusedGradientTransformation(init_fn, update_fn, update_and_params_fn,
                                       update_and_params_local_fn)


class AdamState(NamedTuple):
    count: torch.Tensor   # () int32: updates taken
    mu: Tree              # in each param's dtype
    nu: Tree

    def clone(self) -> "AdamState":
        copy = lambda t: {n: x.clone() for n, x in t.items()}  # noqa: E731
        return AdamState(self.count.clone(), copy(self.mu), copy(self.nu))


def adamw(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> FusedGradientTransformation:
    """``optax.adamw`` on the params themselves. ``update`` returns optax's
    updates; the fused forms apply them (``p + u`` in the param's dtype),
    first scaling each grad by the clip ``scale`` in fp32 back to its dtype
    (JAX's ``clip_grads_with_norm``); ``update_and_params_local`` is the
    same plain code (this optimizer has no kernel)."""

    def init_fn(params: Tree) -> AdamState:
        dev = next(iter(params.values())).device if params else None
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu={n: torch.zeros_like(p) for n, p in params.items()},
                         nu={n: torch.zeros_like(p) for n, p in params.items()})

    def _updates(grads: Tree, state: AdamState, params: Tree):
        """optax's updates, the moments written in place."""
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        count = state.count + 1
        c = count.float()
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        out = {}
        for n, g in grads.items():
            m, v, p = state.mu[n], state.nu[n], params[n]
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
            u = u + weight_decay * p
            out[n] = (_f32(-lr, u.device).to(u.dtype) if torch.is_tensor(lr) else -lr) * u
        return out, state._replace(count=count)

    def update_fn(grads: Tree, state: AdamState, params: Optional[Tree] = None):
        if params is None:
            raise ValueError("adamw requires params (the weight decay reads them)")
        return _updates(grads, state, params)

    def update_and_params_fn(grads: Tree, state: AdamState, params: Tree, scale=None,
                             out: Optional[Tree] = None):
        if scale is not None:
            grads = {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}
        updates, new_state = _updates(grads, state, params)
        new = {}
        for n, u in updates.items():
            p = (params[n] + u).to(params[n].dtype)
            new[n] = p if out is None else out[n].copy_(p)
        return new, new_state

    return FusedGradientTransformation(init_fn, update_fn, update_and_params_fn,
                                       update_and_params_fn)
