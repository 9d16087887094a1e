"""Llama-2-70B pretraining with tensor and pipeline parallelism, on the port.

Counterpart of ``examples/training/llama2_tp_pp.py`` of the JAX package
(BASELINE config #4, the reference's ``tp_pp_llama_hf_pretrain``: TP 8 x
PP 8, 1F1B microbatching, GQA, ZeRO-1). Each rank builds its stage of a
``PipelinedLlama`` (``--num_chunks > 1``: interleaved 1F1B), trains it
through the trainer with ZeRO-1 AdamW over fp32 masters and clipping at
1.0, and saves and resumes through the multi-rank checkpoint.
``--batch_size`` is the global batch, split over the data-parallel ranks
and then into ``--num_microbatches``.

One process a rank (``torchrun``'s environment or the ``NXD_*`` trio):

    torchrun --nproc_per_node 64 ... -m neuronx_distributed_tpu_torch.examples.llama2_tp_pp \\
        --tp 8 --pp 8

Four ranks on one card at TP 2 x PP 2 over gloo, each with its own ``RANK``:

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=4 RANK=$r \\
        python3 -m neuronx_distributed_tpu_torch.examples.llama2_tp_pp \\
        --tp 2 --pp 2 --backend gloo --device cuda:0 --layers 4 --steps 3

The CPU smoke on four thread ranks is in the tests (``--tiny --device cpu``).
"""

from __future__ import annotations

import argparse
import logging
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
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, llama2_70b
from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

logger = logging.getLogger("nxd")


def build_config(args, seq: int) -> LlamaConfig:
    if args.tiny:
        return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=4,
                           num_heads=4, num_kv_heads=2, kv_size_multiplier=2, max_seq_len=seq,
                           dtype=torch.float32, use_flash_attention=False, remat_policy=None)
    return llama2_70b(max_seq_len=seq, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                      remat_policy="full", num_layers=args.layers or 80)


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--num_microbatches", type=int, default=None)
    parser.add_argument("--num_chunks", type=int, default=1,
                        help="virtual-pipeline (interleaved) chunks per stage")
    parser.add_argument("--layers", type=int, default=None,
                        help="decoder layers (default: Llama-2-70B's 80)")
    return parser.parse_args(argv)


def main(argv=None, params: Optional[Mapping[str, torch.Tensor]] = None,
         on_step: Optional[Callable] = None, on_model: Optional[Callable] = None) -> float:
    """Train and return the last step's loss. ``params``: a whole model's
    state dict (global tensors, ``LlamaForCausalLM`` names) to start from
    instead of the seeded init; ``on_step(i, state, metrics)`` runs after
    each step (see ``train_loop``); ``on_model(pmodel, model, state)``
    once the state is built, before the first step."""
    args = parse_args(argv)
    tp = args.tensor_parallel_size or (2 if args.tiny else 8)
    pp = args.pipeline_parallel_size or (2 if args.tiny else 8)
    world = setup_example(args, tp, pp)
    if world > 1 and (mesh.get_tensor_model_parallel_size(), mesh.get_pipeline_model_parallel_size()) \
            != (tp, pp):
        raise SystemExit(f"--tp {tp} --pp {pp} on a mesh of tp "
                         f"{mesh.get_tensor_model_parallel_size()}, pp "
                         f"{mesh.get_pipeline_model_parallel_size()}")
    if world == 1 and (tp, pp) != (1, 1):
        logger.warning("one process: --tp %d --pp %d run as one stage on one rank", tp, pp)
        tp = pp = 1
    batch = args.batch_size or (4 if args.tiny else 32)   # the global batch
    seq = args.seq_len or (32 if args.tiny else 4096)
    steps = args.steps or (3 if args.tiny else 30)
    num_mb = args.num_microbatches or (2 if args.tiny else 8)

    lcfg = build_config(args, seq)
    nxd_config = neuronx_distributed_config(
        tensor_parallel_size=tp, pipeline_parallel_size=pp,
        pipeline_config={"num_microbatches": num_mb},
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    batches = distribute_batches(
        synthetic_lm_batches(lcfg.vocab_size, batch, seq, seed=args.seed), batch)
    next(batches)   # the JAX script's init sample
    pmodel = PipelinedLlama(lcfg, num_stages=pp, num_microbatches=num_mb,
                            num_chunks=args.num_chunks)
    model = pmodel.as_parallel_model(seed=args.seed, device=args.device, params=params)
    opt = initialize_parallel_optimizer(nxd_config, model, learning_rate=make_lr(args, steps),
                                        weight_decay=args.weight_decay)
    state = maybe_resume(args.checkpoint_dir, create_train_state(model, opt))
    if on_model is not None:
        on_model(pmodel, model, state)

    def loss_fn(p, b, rng):
        return pmodel.loss(p, b["ids"], b["labels"])

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
