"""Llama-2-7B pretraining with tensor parallelism, ZeRO-1 and sequence
parallelism, on the port.

Counterpart of ``examples/training/llama2_tp_zero1.py`` of the JAX package
(the reference's ``tp_zero1_llama_hf_pretrain``): TP from ``--tp`` (8 by
default, 2 with ``--tiny``, never more than the world), DP from the rest of
the world, sequence parallelism on, ZeRO-1 AdamW with fp32 masters,
clipping at 1.0, selective activation checkpointing (``"attention"``) and
the flash kernels on the rank's heads. ``--batch_size`` is the global
batch: each data-parallel rank trains on its rows of a seeded synthetic
stream, or reads its own share of token shards (``--shard_glob``).

One process a rank (``torchrun``'s environment or the ``NXD_*`` trio):

    torchrun --nproc_per_node 8 -m neuronx_distributed_tpu_torch.examples.llama2_tp_zero1 --tp 8

Several ranks on one card (NCCL refuses two ranks on one device), four
ranks at TP 2 over gloo, each started with its own ``RANK``:

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=4 RANK=$r \\
        python3 -m neuronx_distributed_tpu_torch.examples.llama2_tp_zero1 \\
        --tp 2 --backend gloo --device cuda:0 --steps 3

The CPU smoke, one process: ``--tiny --device cpu --steps 4``.
"""

from __future__ import annotations

import argparse
import glob
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
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, llama2_7b
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)


def build_config(args, seq: int) -> LlamaConfig:
    if args.tiny:
        return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=4, max_seq_len=seq, dtype=torch.float32,
                           use_flash_attention=False, remat_policy=None)
    # bf16 storage with fp32 masters in the ZeRO-1 optimizer; "attention"
    # remat is the reference's selective checkpointing (run_llama_nxd.py:113)
    return llama2_7b(max_seq_len=seq, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     sequence_parallel=True, remat_policy="attention",
                     num_layers=args.layers or 32)


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--shard_glob", type=str, default=None,
                        help="token-shard files (data.TokenShardDataset); default: seeded "
                             "synthetic batches")
    parser.add_argument("--layers", type=int, default=None,
                        help="decoder layers (default: Llama-2-7B's 32)")
    return parser.parse_args(argv)


def main(argv=None, params: Optional[Mapping[str, torch.Tensor]] = None,
         on_step: Optional[Callable] = None) -> float:
    """Train and return the last step's loss. ``params``: a global state
    dict to start from instead of the seeded init; ``on_step(i, state,
    metrics)`` runs after each step (see ``train_loop``)."""
    args = parse_args(argv)
    default_tp = 2 if args.tiny else 8
    world = setup_example(args, args.tensor_parallel_size or default_tp)
    tp = mesh.get_tensor_model_parallel_size() if world > 1 else 1
    if args.tensor_parallel_size and args.tensor_parallel_size != tp:
        raise SystemExit(f"--tp {args.tensor_parallel_size} on a mesh of tp {tp}")
    dp = world // tp
    batch = args.batch_size or (4 if args.tiny else 8)   # the global batch
    if batch % dp:
        raise SystemExit(f"--batch_size {batch} not divisible by {dp} data-parallel ranks")
    seq = args.seq_len or (32 if args.tiny else 4096)
    steps = args.steps or (4 if args.tiny else 100)
    ds = None
    if args.shard_glob:
        from neuronx_distributed_tpu_torch.data.loader import TokenShardDataset

        dp_rank = mesh.data_parallel_rank() if world > 1 else 0
        ds = TokenShardDataset(sorted(glob.glob(args.shard_glob)), batch_size=batch // dp,
                               shuffle_seed=args.seed, rank=dp_rank, world_size=dp)
        seq = ds.seq_len   # the shards define the sequence length

    lcfg = build_config(args, seq)
    nxd_config = neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=lcfg.sequence_parallel,
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    if ds is not None:
        batches = iter(ds)
    else:
        batches = distribute_batches(
            synthetic_lm_batches(lcfg.vocab_size, batch, seq, seed=args.seed), batch)
    # the first batch is consumed here, as the JAX script's init sample is
    next(batches)
    model = initialize_parallel_model(nxd_config, lambda: LlamaForCausalLM(lcfg),
                                      device=args.device, params=params)
    opt = initialize_parallel_optimizer(nxd_config, model, learning_rate=make_lr(args, steps),
                                        weight_decay=args.weight_decay)
    state = maybe_resume(args.checkpoint_dir, create_train_state(model, opt), dataset=ds)

    def loss_fn(p, b, rng):
        return model.apply(p, b["ids"], b["labels"], method="loss")

    step = make_train_step(model, opt, loss_fn, grad_accum_steps=args.grad_accum_usteps)
    state, metrics = train_loop(
        step, state, batches, steps, batch_size=batch, device=model.device,
        log_every=args.log_every, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, metrics_file=args.metrics_file,
        profile_dir=args.profile_dir, trace_out=args.trace_out, metrics_out=args.metrics_out,
        dataset=ds, on_step=on_step)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
