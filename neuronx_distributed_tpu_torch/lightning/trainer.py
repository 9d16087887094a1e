"""The managed fit loop (JAX ``lightning/trainer.py``).

``fit`` builds the model over the parallel state of the module's nxd config
(``initialize_parallel_model``), its optimizer and train state, resumes
from the newest checkpoint under ``checkpoint_dir``, and runs the steps up
to ``max_steps`` with callbacks, validation and logging.

Batch alignment: step ``i + 1`` trains the stream's ``i``-th batch. The
first batch is drawn before the model is built (its example inputs) and is
batch 0: a fresh run trains it first. A resumed run moves the stream to
where the straight run stood: a restorable stream (``state_dict`` /
``load_state_dict``, the ``TokenShardDataset``) seeks from the position
saved with the checkpoint, a plain iterator skips ``start - 1`` batches
(the first was drawn already). Step ``i`` draws from a generator seeded
``seed + i + 1``, validation after step ``s`` from one seeded ``s``.

Preemption: while ``fit`` runs on the main thread, SIGTERM and SIGINT only
set ``preempted``; at the next step boundary the loop waits for the device,
saves a synchronous checkpoint (``step_{n}``, with the stream position) and
stops. The handlers that were installed before are put back when ``fit``
returns or raises. Thread ranks (``parallel.mesh.run_in_threads``) install
none.

Metrics (the registry's): ``train_step_ms`` (each step's launch wall
time; the step queues its work on the device and reads nothing back),
``train_checkpoint_ms``, ``train_tokens_per_sec`` and ``train_steps``; with
an enabled tracer a ``step_{i}`` span a step on the ``("trainer",
"steps")`` lane and a span a save on ``("trainer", "checkpoint")``.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from neuronx_distributed_tpu_torch._device import DeviceLike, to_device
from neuronx_distributed_tpu_torch.checkpoint import has_checkpoint, load_checkpoint
from neuronx_distributed_tpu_torch.lightning.callbacks import Callback
from neuronx_distributed_tpu_torch.lightning.loggers import BaseLogger
from neuronx_distributed_tpu_torch.lightning.module import NxDLightningModule
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    make_train_step,
)
from neuronx_distributed_tpu_torch.utils import get_logger
from neuronx_distributed_tpu_torch.utils.profiler import step_annotation

logger = get_logger("nxd.lightning")


class NxDTrainer:
    """``fit`` = parallel init -> model, optimizer, state -> resume -> the
    loop with callbacks, validation and logging. ``device``: where the
    model lives (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, max_steps: int, callbacks: Sequence[Callback] = (),
                 logger_: Optional[BaseLogger] = None, val_every_n_steps: int = 0,
                 val_steps: int = 1, checkpoint_dir: Optional[str] = None, seed: int = 0,
                 handle_preemption: bool = True, tracer=None, metrics=None,
                 device: DeviceLike = None):
        from neuronx_distributed_tpu_torch.observability import MetricsRegistry, Tracer

        self.max_steps = int(max_steps)
        self.callbacks = list(callbacks)
        self.logger = logger_
        self.val_every_n_steps = int(val_every_n_steps)
        self.val_steps = int(val_steps)
        self.checkpoint_dir = checkpoint_dir
        self.seed = seed
        self.device = device
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_step = self.metrics.histogram("train_step_ms", help="per-step launch wall ms")
        self._m_ckpt = self.metrics.histogram("train_checkpoint_ms",
                                              help="checkpoint save-call wall ms")
        self._m_tok = self.metrics.gauge("train_tokens_per_sec", help="tokens/s over the last step")
        self._m_steps = self.metrics.counter("train_steps", help="optimizer steps run")
        self.model = None
        self.optimizer = None
        self.state = None
        self.train_stream = None   # the restorable stream, set by fit()
        self.handle_preemption = bool(handle_preemption)
        self.preempted = False

    # --- loop ------------------------------------------------------------

    def fit(self, module: NxDLightningModule, train_batches: Iterator[Dict[str, Any]],
            val_batches: Optional[Iterator[Dict[str, Any]]] = None,
            params: Optional[Mapping[str, Any]] = None):
        """Train to ``max_steps``; returns ``(state, last_metrics)``.
        ``params``: a state dict to start from instead of the seeded init
        (``initialize_parallel_model``'s)."""
        restorable = hasattr(train_batches, "state_dict") and hasattr(train_batches,
                                                                      "load_state_dict")
        self.train_stream = train_batches if restorable else None
        stream_it = iter(train_batches)
        sample = next(stream_it)
        self.model = initialize_parallel_model(module.nxd_config, module.configure_model,
                                               *module.model_inputs(sample),
                                               device=self.device, params=params)
        self.optimizer = module.configure_optimizer(self.model)
        self.state = create_train_state(self.model, self.optimizer)
        content = None
        if self.checkpoint_dir and has_checkpoint(self.checkpoint_dir):
            self.state, content = load_checkpoint(self.checkpoint_dir, target=self.state)
            logger.info("resumed at step %s", (content or {}).get("step"))
        model = self.model

        def loss_fn(p, batch, rng):
            return module.training_loss(model, p, batch, rng)

        step_fn = make_train_step(model, self.optimizer, loss_fn)
        for cb in self.callbacks:
            cb.on_train_start(self, module)
        metrics: Dict[str, Any] = {}
        start = int(self.state.step)
        self.preempted = False
        installed: Dict[int, Any] = {}

        def _on_signal(signum, frame):
            self.preempted = True
            logger.warning("signal %d received: checkpointing and stopping at the next step "
                           "boundary", signum)

        if self.handle_preemption and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                installed[sig] = signal.signal(sig, _on_signal)
        pending: Optional[Dict[str, Any]] = sample if start == 0 else None
        if start > 0 and self.train_stream is not None and content and "data_state" in content:
            self.train_stream.load_state_dict(content["data_state"])
            stream_it = iter(self.train_stream)   # re-enter at the position
        else:
            for _ in range(max(start - 1, 0)):
                next(stream_it)
        try:
            for i in range(start, self.max_steps):
                batch = pending if pending is not None else next(stream_it)
                pending = None
                dev_batch = to_device(batch, model.device)
                rng = torch.Generator().manual_seed(self.seed + i + 1)
                t0 = time.perf_counter()
                with step_annotation(i):
                    self.state, metrics = step_fn(self.state, dev_batch, rng)
                t1 = time.perf_counter()
                self._m_step.observe((t1 - t0) * 1e3)
                self._m_steps.inc()
                tokens = sum(int(np.prod(v.shape)) for v in batch.values()
                             if getattr(v, "ndim", 0) >= 2)
                if t1 > t0 and tokens:
                    self._m_tok.set(round(tokens / (t1 - t0), 1))
                if self.tracer.enabled:
                    self.tracer.complete(f"step_{i}", ("trainer", "steps"), t0, t1,
                                         args={"step": i + 1, "tokens": tokens})
                step = i + 1
                if self.logger is not None:
                    self.logger.log_metrics(metrics, step)
                for cb in self.callbacks:
                    cb.on_step_end(self, module, step, metrics)
                if self.preempted:
                    self._save_preemption_checkpoint(step)
                    break
                if val_batches is not None and self.val_every_n_steps and (
                        step % self.val_every_n_steps == 0 or step == self.max_steps):
                    with torch.no_grad():
                        losses = [float(module.validation_loss(
                            model, self.state.params, to_device(next(val_batches), model.device),
                            torch.Generator().manual_seed(step)))
                            for _ in range(self.val_steps)]
                    val_metrics = {"val_loss": float(np.mean(losses))}
                    if self.logger is not None:
                        self.logger.log_metrics(val_metrics, step)
                    for cb in self.callbacks:
                        cb.on_validation_end(self, module, step, val_metrics)
        finally:
            for sig, handler in installed.items():
                signal.signal(sig, handler)
        for cb in self.callbacks:
            cb.on_train_end(self, module)
        if self.logger is not None:
            self.logger.finalize()
        return self.state, metrics

    def _save_preemption_checkpoint(self, step: int) -> None:
        """The final checkpoint on preemption: after the device has run the
        queued step (the step updates the state's tensors in place),
        synchronous and finalized, with the stream position, so the
        restarted job resumes as the straight run goes on."""
        if not self.checkpoint_dir:
            logger.warning("preempted with no checkpoint_dir: stopping without a final "
                           "checkpoint")
            return
        from neuronx_distributed_tpu_torch.checkpoint import finalize_checkpoint, save_checkpoint

        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        content: Dict[str, Any] = {"step": step, "preempted": True}
        if self.train_stream is not None:
            content["data_state"] = self.train_stream.state_dict()
        t0 = time.perf_counter()
        with self.tracer.span(f"preemption_checkpoint_{step}", ("trainer", "checkpoint")):
            save_checkpoint(self.checkpoint_dir, f"step_{step}", self.state,
                            user_content=content, async_save=False)
            finalize_checkpoint()
        self._m_ckpt.observe((time.perf_counter() - t0) * 1e3)
        logger.warning("preemption checkpoint saved at step %d", step)
