"""BERT-large MLM + NSP pretraining with tensor and data parallelism, on the
port (BASELINE config #2).

Counterpart of ``examples/training/bert_pretrain.py`` of the JAX package
(the reference's ``tp_dp_bert_large_hf_pretrain_hdf5.py``): ``bert_large``
(``models/bert.py``) on seeded synthetic MLM batches with the five fields of
the reference's HDF5 records (``synthetic_mlm_batches``), ZeRO-1 AdamW over
fp32 masters, clipping at 1.0, dropout 0.1. TP from ``--tp`` (8 by default,
2 with ``--tiny``), DP from the rest of the world; ``--batch_size`` is the
global batch (16 by default, of 512 tokens) and the MLM loss is the mean
over the global batch's labelled tokens. Step ``i``'s dropout draws from
``(seed + i + 1, the data-parallel rank)``, and a resumed run skips the
batches it trained on, so it draws the batches and masks the uninterrupted
one would. ``--layers`` cuts the depth.

One process a rank (``torchrun``'s environment or the ``NXD_*`` trio):

    torchrun --nproc_per_node 8 -m neuronx_distributed_tpu_torch.examples.bert_pretrain --tp 8

One card, one process: ``--tp 1 --steps 4``. The CPU smoke: ``--tiny
--device cpu --steps 4``.
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
    synthetic_mlm_batches,
    train_loop,
)
from neuronx_distributed_tpu_torch.models.bert import BertConfig, BertForPreTraining, bert_large
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)


def build_config(args) -> BertConfig:
    if args.tiny:
        return BertConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                          num_heads=4, max_position_embeddings=128, dtype=torch.float32,
                          use_flash_attention=False)
    over = {"num_layers": args.layers} if args.layers else {}
    return bert_large(**over)


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--layers", type=int, default=None,
                        help="encoder layers (default: BERT-large's 24)")
    return parser.parse_args(argv)


def dropout_seed(rng: int, dp_rank: int) -> int:
    """Step ``rng``'s dropout seed on data-parallel rank ``dp_rank``: the
    ranks of one TP group share it, the DP ranks (other rows) do not."""
    return int(rng) * 65_537 + dp_rank


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
    batch = args.batch_size or (4 if args.tiny else 16)   # the global batch
    if batch % dp:
        raise SystemExit(f"--batch_size {batch} not divisible by {dp} data-parallel ranks")
    seq = args.seq_len or (32 if args.tiny else 512)
    steps = args.steps or (4 if args.tiny else 1000)

    bcfg = build_config(args)
    nxd_config = neuronx_distributed_config(
        tensor_parallel_size=tp, optimizer_config={"zero_one_enabled": True},
        mixed_precision_config={"use_master_weights": True})
    batches = distribute_batches(
        synthetic_mlm_batches(bcfg.vocab_size, batch, seq, seed=args.seed), batch)
    next(batches)   # the JAX script's init sample
    model = initialize_parallel_model(nxd_config, lambda: BertForPreTraining(bcfg),
                                      device=args.device, params=params)
    opt = initialize_parallel_optimizer(nxd_config, model, learning_rate=make_lr(args, steps),
                                        weight_decay=args.weight_decay)
    state = maybe_resume(args.checkpoint_dir, create_train_state(model, opt))
    for _ in range(int(state.step)):   # a resumed run skips the batches it trained on
        next(batches)
    dp_group = mesh.get_data_parallel_group() if dp > 1 else None
    dp_rank = mesh.data_parallel_rank() if dp > 1 else 0

    def loss_fn(p, b, rng):
        model.bind(p)
        return model.module.loss(b["input_ids"], b["masked_lm_labels"],
                                 b["next_sentence_labels"], b["token_type_ids"],
                                 b["attention_mask"], deterministic=False,
                                 dropout_seed=dropout_seed(rng, dp_rank), dp_group=dp_group)

    step = make_train_step(model, opt, loss_fn, grad_accum_steps=args.grad_accum_usteps)
    state, metrics = train_loop(
        step, state, batches, steps, batch_size=batch, device=model.device,
        log_every=args.log_every, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, metrics_file=args.metrics_file,
        profile_dir=args.profile_dir, trace_out=args.trace_out, metrics_out=args.metrics_out,
        on_step=on_step, seed=args.seed)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
