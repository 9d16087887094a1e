"""Mixtral-8x7B pretraining with expert parallelism, on the port.

Counterpart of ``examples/training/mixtral_moe.py`` of the JAX package (the
reference's ``examples/training/mixtral``): TP from ``--tp`` (4 by default,
2 with ``--tiny``), EP from ``--ep`` (2), DP from the rest of the world
(``edp = dp / ep``); top-2 routing, capacity-factor dispatch, the
load-balancing loss added to the cross entropy (``mixtral_loss``), ZeRO-1
AdamW over fp32 masters with the expert leaves' state over edp, clipping
at 1.0, bf16 storage and selective activation checkpointing
(``"attention"``, the JAX example's). ``--batch_size`` is the global
batch: each data-parallel rank trains on its rows of a seeded synthetic
stream. ``--layers`` cuts the depth.

One process a rank (``torchrun``'s environment or the ``NXD_*`` trio):

    torchrun --nproc_per_node 8 -m neuronx_distributed_tpu_torch.examples.mixtral_moe \\
        --tp 4 --ep 2

Four ranks on one card at TP 2 x EP 2 over gloo, each with its own ``RANK``:

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=4 RANK=$r \\
        python3 -m neuronx_distributed_tpu_torch.examples.mixtral_moe \\
        --tp 2 --ep 2 --backend gloo --device cuda:0 --layers 2 --batch_size 2 --steps 3

The CPU smoke on eight thread ranks is in the tests (``--tiny --device cpu``).
"""

from __future__ import annotations

import argparse
from typing import Callable, Mapping, Optional

import torch

from neuronx_distributed_tpu_torch.examples.common import (
    add_common_args,
    distribute_batches,
    make_lr,
    maybe_resume,
    setup_example,
    synthetic_lm_batches,
    train_loop,
)
from neuronx_distributed_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    mixtral_8x7b,
    mixtral_loss,
)
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)


def build_config(args, seq: int) -> MixtralConfig:
    if args.tiny:
        return MixtralConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, kv_size_multiplier=2, max_seq_len=seq,
                             dtype=torch.float32, use_flash_attention=False, remat_policy=None,
                             num_experts=4, top_k=2, capacity_factor=2.0)
    return mixtral_8x7b(max_seq_len=seq, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                        remat_policy="attention", num_layers=args.layers or 32)


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--expert_parallel_size", "--ep", type=int, default=None)
    parser.add_argument("--layers", type=int, default=None,
                        help="decoder layers (default: Mixtral-8x7B's 32)")
    return parser.parse_args(argv)


def main(argv=None, params: Optional[Mapping[str, torch.Tensor]] = None,
         on_step: Optional[Callable] = None, on_model: Optional[Callable] = None) -> float:
    """Train and return the last step's loss. ``params``: a global state
    dict to start from instead of the seeded init; ``on_step(i, state,
    metrics)`` runs after each step (see ``train_loop``); ``on_model(model,
    state)`` once the state is built, before the first step."""
    args = parse_args(argv)
    tp = args.tensor_parallel_size or (2 if args.tiny else 4)
    ep = args.expert_parallel_size or 2
    world = setup_example(args, tp, expert_parallel_size=ep)
    if world > 1:
        got = (mesh.get_tensor_model_parallel_size(), mesh.get_expert_model_parallel_size())
        if got != (tp, ep):
            raise SystemExit(f"--tp {tp} --ep {ep} on a mesh of tp {got[0]}, ep {got[1]}")
    else:
        tp = ep = 1
    batch = args.batch_size or (4 if args.tiny else 8)   # the global batch
    seq = args.seq_len or (32 if args.tiny else 4096)
    steps = args.steps or (3 if args.tiny else 100)

    mcfg = build_config(args, seq)
    nxd_config = neuronx_distributed_config(
        tensor_parallel_size=tp, expert_parallel_size=ep,
        optimizer_config={"zero_one_enabled": True},
        mixed_precision_config={"use_master_weights": True})
    batches = distribute_batches(
        synthetic_lm_batches(mcfg.vocab_size, batch, seq, seed=args.seed), batch)
    next(batches)   # the JAX script's init sample
    model = initialize_parallel_model(nxd_config, lambda: MixtralForCausalLM(mcfg),
                                      device=args.device, params=params)
    opt = initialize_parallel_optimizer(nxd_config, model, learning_rate=make_lr(args, steps),
                                        weight_decay=args.weight_decay)
    state = maybe_resume(args.checkpoint_dir, create_train_state(model, opt))
    if on_model is not None:
        on_model(model, state)

    def loss_fn(p, b, rng):
        model.bind(p)
        return mixtral_loss(model.module, b["ids"], b["labels"])

    step = make_train_step(model, opt, loss_fn, grad_accum_steps=args.grad_accum_usteps)
    state, metrics = train_loop(
        step, state, batches, steps, batch_size=batch, device=model.device,
        log_every=args.log_every, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, metrics_file=args.metrics_file,
        profile_dir=args.profile_dir, trace_out=args.trace_out, metrics_out=args.metrics_out,
        on_step=on_step)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
