"""Shared training-script machinery: arguments, the learning-rate schedule,
synthetic batches, the training loop with metrics and async checkpoints,
and resume.

Counterpart of ``examples/common.py`` of the JAX package. Every training
script follows the same skeleton: :func:`setup_example` ->
``neuronx_distributed_config`` -> ``initialize_parallel_model`` ->
``initialize_parallel_optimizer`` -> ``create_train_state`` ->
:func:`maybe_resume` -> ``make_train_step`` -> :func:`train_loop`. Scripts
run on the card unless ``--device cpu`` is given, and accept ``--tiny`` for
a CPU-sized model.

Many ranks: one process a rank, launched with ``torchrun``'s environment or
the JAX package's ``NXD_*`` trio (or ``--coordinator_address``,
``--num_processes``, ``--process_id``); :func:`setup_example` joins the
default group and builds the mesh. ``--batch_size`` is the global batch:
each data-parallel rank trains on its own rows (:func:`distribute_batches`
slices a global synthetic stream; a ``TokenShardDataset`` shards at the
source). A rank-per-thread world (``parallel.mesh.run_in_threads``, the
CPU tests) arrives with its mesh already built.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.checkpoint import (
    finalize_checkpoint,
    has_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from neuronx_distributed_tpu_torch.utils import MetricsWriter, Throughput, get_logger
from neuronx_distributed_tpu_torch.utils.profiler import profile_steps, step_annotation

logger = get_logger("nxd.examples")


def add_common_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--tensor_parallel_size", "--tp", type=int, default=None)
    parser.add_argument("--pipeline_parallel_size", "--pp", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; cpu runs the kernels' plain twins)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--seq_len", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--grad_accum_usteps", type=int, default=1,
                        help="microbatches accumulated into one optimizer step")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=10)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="async save every N steps (0: only at the end when a dir is set)")
    parser.add_argument("--metrics_file", type=str, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="torch.profiler Chrome trace output dir")
    parser.add_argument("--trace_out", type=str, default=None,
                        help="write a Chrome/Perfetto trace-event JSON of the host-side step "
                             "timeline (step spans, checkpoint saves) to this path")
    parser.add_argument("--metrics_out", type=str, default=None,
                        help="write the run's metrics registry here (Prometheus text; a .json "
                             "suffix writes the JSON snapshot)")
    parser.add_argument("--tiny", action="store_true",
                        help="shrink the model and batch to CPU-test scale")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of rank 0 (or NXD_COORDINATOR_ADDRESS / MASTER_ADDR)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="world size (or NXD_NUM_PROCESSES / WORLD_SIZE)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (or NXD_PROCESS_ID / RANK)")
    parser.add_argument("--backend", type=str, default=None,
                        help="torch.distributed backend (default nccl with a GPU; gloo runs "
                             "several ranks on one card)")
    return parser


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Callable:
    """optax's ``warmup_cosine_decay_schedule`` as a callable of the step
    count (an int or a device tensor; a tensor stays on its device, so the
    step reads nothing back): linear from ``init_value`` to ``peak_value``
    over ``warmup_steps``, then a cosine to ``end_value`` at
    ``decay_steps``."""
    alpha = end_value / peak_value if peak_value else 0.0
    cos_steps = decay_steps - warmup_steps

    def schedule(count):
        c = (count.float() if torch.is_tensor(count)
             else torch.tensor(float(count), dtype=torch.float32))
        w = torch.clamp(c, 0.0, float(warmup_steps))
        warm = (init_value - peak_value) * (1 - w / warmup_steps) + peak_value
        d = torch.clamp(c - warmup_steps, max=float(cos_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * d / cos_steps))
        decayed = peak_value * ((1 - alpha) * cosine + alpha)
        return torch.where(c < warmup_steps, warm, decayed)

    return schedule


def make_lr(args, steps: int):
    """Constant ``--lr`` when ``--warmup_steps`` is 0; else linear warmup,
    then a cosine decay to 10 % of it at ``steps``."""
    if not getattr(args, "warmup_steps", 0):
        return args.lr
    return warmup_cosine_decay(0.0, args.lr, args.warmup_steps,
                               max(steps, args.warmup_steps + 1), end_value=args.lr * 0.1)


def synthetic_lm_batches(vocab_size: int, batch: int, seq: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic next-token batches from a seeded numpy stream (the JAX
    examples' generator, draw for draw)."""
    rs = np.random.RandomState(seed)
    while True:
        ids = rs.randint(0, vocab_size, (batch, seq + 1), dtype=np.int64)
        yield {"ids": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)}


def synthetic_mlm_batches(vocab_size: int, batch: int, seq: int, seed: int = 0,
                          mask_token: int = 103, mask_prob: float = 0.15,
                          ignore_index: int = -100) -> Iterator[Dict[str, np.ndarray]]:
    """BERT-style MLM + NSP batches from a seeded numpy stream, the JAX
    examples' generator draw for draw: the five fields of the reference's
    HDF5 records (``input_ids``, ``token_type_ids``, ``attention_mask``,
    ``masked_lm_labels``, ``next_sentence_labels``)."""
    rs = np.random.RandomState(seed)
    while True:
        ids = rs.randint(5, vocab_size, (batch, seq), dtype=np.int64)
        seg = (np.arange(seq)[None, :] >= rs.randint(1, seq, (batch, 1))).astype(np.int32)
        mask = np.ones((batch, seq), np.int32)
        pad_from = rs.randint(seq // 2, seq + 1, (batch,))
        for i, p in enumerate(pad_from):
            mask[i, p:] = 0
        mlm_labels = np.full((batch, seq), ignore_index, np.int64)
        masked = (rs.rand(batch, seq) < mask_prob) & (mask == 1)
        mlm_labels[masked] = ids[masked]
        input_ids = ids.copy()
        input_ids[masked] = mask_token
        nsp = rs.randint(0, 2, (batch,), dtype=np.int64)
        yield {
            "input_ids": input_ids.astype(np.int32),
            "token_type_ids": seg,
            "attention_mask": mask,
            "masked_lm_labels": mlm_labels.astype(np.int32),
            "next_sentence_labels": nsp.astype(np.int32),
        }


def setup_distributed(args) -> bool:
    """Join the default group when a launch is configured (a no-op
    otherwise, so every script calls it). Returns True on a multi-process
    run."""
    from neuronx_distributed_tpu_torch.parallel.distributed import initialize_distributed

    multi = initialize_distributed(getattr(args, "coordinator_address", None),
                                   getattr(args, "num_processes", None),
                                   getattr(args, "process_id", None),
                                   backend=getattr(args, "backend", None),
                                   device=getattr(args, "device", None))
    if multi:
        import torch.distributed as dist

        logger.info("process %d/%d", dist.get_rank(), dist.get_world_size())
    return multi


def setup_example(args, tensor_parallel_size: int = 1, pipeline_parallel_size: int = 1,
                  expert_parallel_size: int = 1) -> int:
    """The examples' bootstrap: join the default group (a process-per-rank
    launch), then build the mesh at ``tensor_parallel_size``,
    ``pipeline_parallel_size`` and ``expert_parallel_size`` unless this
    rank already holds one (a rank-per-thread world). Returns the world
    size."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    if mesh.model_parallel_is_initialized():
        return mesh.get_world_size()
    if setup_distributed(args):
        mesh.initialize_model_parallel(tensor_parallel_size,
                                       pipeline_model_parallel_size=pipeline_parallel_size,
                                       expert_model_parallel_size=expert_parallel_size)
        return mesh.get_world_size()
    return 1


def distribute_batches(batches: Iterator[Dict[str, np.ndarray]],
                       global_batch: int) -> Iterator[Dict[str, np.ndarray]]:
    """A global-batch stream made the same on every rank (one seed), cut to
    this rank's rows when the world has more than one data-parallel rank;
    a pass-through otherwise."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    if not mesh.model_parallel_is_initialized() or mesh.get_data_parallel_size() == 1:
        return batches
    return host_local_batches(batches, global_batch)


def host_local_batches(batches: Iterator[Dict[str, np.ndarray]],
                       global_batch: int) -> Iterator[Dict[str, np.ndarray]]:
    """Each global batch cut to this rank's rows (``host_batch_slice``)."""
    from neuronx_distributed_tpu_torch.parallel.distributed import host_batch_slice

    sl = host_batch_slice(global_batch)
    for b in batches:
        yield {k: v[sl] for k, v in b.items()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_loop(step_fn: Callable, state, batches: Iterator[Dict[str, np.ndarray]], steps: int,
               *, batch_size: int, device, log_every: int = 10,
               checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
               metrics_file: Optional[str] = None, profile_dir: Optional[str] = None,
               extra_metrics: Optional[Dict[str, Any]] = None, trace_out: Optional[str] = None,
               metrics_out: Optional[str] = None, dataset=None,
               on_step: Optional[Callable] = None, seed: Optional[int] = None):
    """Run steps ``state.step`` .. ``steps`` with throughput logging,
    optional periodic async checkpoints (every ``checkpoint_every`` steps,
    tag ``step_{n}``, the newest 3 kept, and a sync save at the end unless
    the last periodic save was of step ``steps``), and an optional
    ``torch.profiler`` trace. Each batch (numpy) moves to
    ``device`` before its step. ``dataset`` (anything with ``state_dict``,
    for example a ``TokenShardDataset``): its position after the step goes
    into each save's ``user_content["data"]``, where :func:`maybe_resume`
    finds it. ``on_step(i, state, metrics)`` runs after step ``i`` (0-based)
    and before its save. ``seed``: step ``i`` gets ``rng=seed + i + 1``
    (the JAX loop's ``key(seed + i + 1)``), which its ``loss_fn`` may draw
    dropout from; None passes no rng. Returns ``(final_state,
    last_metrics)``.

    ``trace_out``/``metrics_out`` arm the host-side observability layer:
    a span a step (dispatch wall time) and a save in the trainer lane
    (Chrome trace JSON), and the registry's step-time and save-time
    histograms, tokens/s gauge and step counter (Prometheus text, or JSON
    for a ``.json`` path)."""
    from neuronx_distributed_tpu_torch.observability import MetricsRegistry, Tracer

    start_step = int(state.step)
    throughput = Throughput(batch_size)
    writer = MetricsWriter(metrics_file)
    tracer = Tracer(enabled=bool(trace_out))
    registry = MetricsRegistry()
    m_step = registry.histogram("train_step_ms", help="per-step dispatch wall ms")
    m_ckpt = registry.histogram("train_checkpoint_ms", help="checkpoint save-call wall ms")
    m_tok = registry.gauge("train_tokens_per_sec", help="tokens/s over the logging window")
    m_steps = registry.counter("train_steps", help="optimizer steps run")

    def timed_save(tag_step: int, **kw) -> None:
        t0 = time.perf_counter()
        content = {"step": tag_step}
        if dataset is not None:
            content["data"] = dataset.state_dict()
        with tracer.span(f"checkpoint_{tag_step}", ("trainer", "checkpoint")):
            save_checkpoint(checkpoint_dir, f"step_{tag_step}", state, user_content=content,
                            num_kept=3, **kw)
        m_ckpt.observe((time.perf_counter() - t0) * 1e3)

    metrics: Dict[str, Any] = {}
    last_logged = start_step
    try:
        with profile_steps(profile_dir):
            for i in range(start_step, steps):
                batch = to_device(next(batches), device)
                t0 = time.perf_counter()
                with step_annotation(i):
                    if seed is None:
                        state, metrics = step_fn(state, batch)
                    else:
                        state, metrics = step_fn(state, batch, seed + i + 1)
                t1 = time.perf_counter()
                m_step.observe((t1 - t0) * 1e3)
                m_steps.inc()
                if tracer.enabled:
                    tracer.complete(f"step_{i}", ("trainer", "steps"), t0, t1,
                                    args={"step": i + 1})
                if on_step is not None:
                    on_step(i, state, metrics)
                if log_every and ((i + 1) % log_every == 0 or i + 1 == steps):
                    loss = float(metrics["loss"])   # the host read waits for the step
                    seq_s = throughput.get_throughput() * (i + 1 - last_logged)
                    last_logged = i + 1
                    seq_len = next((v.shape[1] for v in batch.values() if v.dim() >= 2), 1)
                    m_tok.set(round(seq_s * seq_len, 1))
                    logger.info("step %d/%d loss %.4f (%.2f seq/s)", i + 1, steps, loss, seq_s)
                    writer.log(i + 1, loss=loss, seqs_per_sec=seq_s,
                               grad_norm=metrics.get("grad_norm", 0.0), **(extra_metrics or {}))
                if checkpoint_dir and checkpoint_every and (i + 1) % checkpoint_every == 0:
                    timed_save(i + 1, async_save=True)
        if checkpoint_dir and not (checkpoint_every and steps % checkpoint_every == 0
                                   and start_step < steps):
            timed_save(steps)
    finally:
        finalize_checkpoint()
        writer.close()
        if trace_out:
            tracer.export_chrome(trace_out)
        if metrics_out:
            registry.dump(metrics_out)
    return state, metrics


def maybe_resume(checkpoint_dir: Optional[str], state, dataset=None, verify: bool = False):
    """The newest completed checkpoint's state in ``state``'s structure and
    on its devices, when ``checkpoint_dir`` holds one (else ``state``); a
    ``dataset`` takes the saved stream position."""
    if not checkpoint_dir or not has_checkpoint(checkpoint_dir):
        return state
    restored, content = load_checkpoint(checkpoint_dir, target=state, verify=verify)
    content = content or {}
    if dataset is not None and "data" in content:
        dataset.load_state_dict(content["data"])
    logger.info("resumed from %s at step %s", checkpoint_dir, content.get("step"))
    return restored
