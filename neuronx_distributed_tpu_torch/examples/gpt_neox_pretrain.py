"""GPT-NeoX 6.9B/20B pretraining with tensor parallelism, ZeRO-1 and
sequence parallelism, on the port.

Counterpart of ``examples/training/gpt_neox_pretrain.py`` of the JAX package
(the reference's ``tp_dp_gpt_neox_hf_pretrain`` 6.9B and 20B configs): the
parallel-residual decoder with partial rotary and biased projections
(``models/gpt_neox.py``). TP from ``--tp`` (8 by default, 2 with
``--tiny``), DP from the rest of the world, sequence parallelism on,
ZeRO-1 AdamW over fp32 masters of bf16 weights, clipping at 1.0, selective
activation checkpointing (``"attention"``). ``--batch_size`` is the global
batch (8 by default, of 2048 tokens): each data-parallel rank trains on its
rows of a seeded synthetic stream, and a resumed run skips the batches it
trained on. ``--layers`` cuts the depth.

One process a rank (``torchrun``'s environment or the ``NXD_*`` trio):

    torchrun --nproc_per_node 8 -m neuronx_distributed_tpu_torch.examples.gpt_neox_pretrain \\
        --tp 8 --size 20b

Four ranks on one card at TP 2 over gloo, each with its own ``RANK``:

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=4 RANK=$r \\
        python3 -m neuronx_distributed_tpu_torch.examples.gpt_neox_pretrain \\
        --tp 2 --backend gloo --device cuda:0 --size 20b --layers 2 --steps 3

The CPU smoke, one process: ``--tiny --device cpu --steps 3``.
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
from neuronx_distributed_tpu_torch.models.gpt_neox import (
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
    gpt_neox_6_9b,
    gpt_neox_20b,
)
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)


def build_config(args, seq: int) -> GPTNeoXConfig:
    if args.tiny:
        return GPTNeoXConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=4, max_seq_len=seq, dtype=torch.float32,
                             use_flash_attention=False, remat_policy=None)
    preset = {"6.9b": gpt_neox_6_9b, "20b": gpt_neox_20b}[args.size]
    over = {"num_layers": args.layers} if args.layers else {}
    return preset(max_seq_len=seq, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  sequence_parallel=True, remat_policy="attention", **over)


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--size", choices=["6.9b", "20b"], default="6.9b")
    parser.add_argument("--layers", type=int, default=None,
                        help="decoder layers (default: the preset's)")
    return parser.parse_args(argv)


def main(argv=None, params: Optional[Mapping[str, torch.Tensor]] = None,
         on_step: Optional[Callable] = None) -> float:
    """Train and return the last step's loss. ``params``: a global state
    dict to start from instead of the seeded init; ``on_step(i, state,
    metrics)`` runs after each step (see ``train_loop``)."""
    args = parse_args(argv)
    world = setup_example(args, args.tensor_parallel_size or (2 if args.tiny else 8))
    tp = mesh.get_tensor_model_parallel_size() if world > 1 else 1
    if args.tensor_parallel_size and args.tensor_parallel_size != tp:
        raise SystemExit(f"--tp {args.tensor_parallel_size} on a mesh of tp {tp}")
    dp = world // tp
    batch = args.batch_size or (4 if args.tiny else 8)   # the global batch
    if batch % dp:
        raise SystemExit(f"--batch_size {batch} not divisible by {dp} data-parallel ranks")
    seq = args.seq_len or (32 if args.tiny else 2048)
    steps = args.steps or (3 if args.tiny else 100)

    ncfg = build_config(args, seq)
    nxd_config = neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=ncfg.sequence_parallel,
        optimizer_config={"zero_one_enabled": True},
        mixed_precision_config={"use_master_weights": True})
    batches = distribute_batches(
        synthetic_lm_batches(ncfg.vocab_size, batch, seq, seed=args.seed), batch)
    next(batches)   # the JAX script's init sample
    model = initialize_parallel_model(nxd_config, lambda: GPTNeoXForCausalLM(ncfg),
                                      device=args.device, params=params)
    opt = initialize_parallel_optimizer(nxd_config, model, learning_rate=make_lr(args, steps),
                                        weight_decay=args.weight_decay)
    state = maybe_resume(args.checkpoint_dir, create_train_state(model, opt))
    for _ in range(int(state.step)):   # a resumed run skips the batches it trained on
        next(batches)

    def loss_fn(p, b, rng):
        return model.apply(p, b["ids"], b["labels"], method="loss")

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
