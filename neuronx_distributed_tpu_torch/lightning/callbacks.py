"""Trainer callbacks (JAX ``lightning/callbacks.py``): periodic checkpoints
through ``checkpoint.save_checkpoint`` and rank-0 progress lines."""

from __future__ import annotations

import time
from typing import Any, Dict

from neuronx_distributed_tpu_torch.utils import get_logger

logger = get_logger("nxd.lightning")


class Callback:
    def on_train_start(self, trainer, module) -> None:
        pass

    def on_step_end(self, trainer, module, step: int, metrics: Dict[str, Any]) -> None:
        pass

    def on_validation_end(self, trainer, module, step: int, metrics: Dict[str, Any]) -> None:
        pass

    def on_train_end(self, trainer, module) -> None:
        pass


class ModelCheckpoint(Callback):
    """A save every ``every_n_steps`` steps (tag ``step_{n}``, the newest
    ``num_kept`` kept) and one at the end of training, each with the step
    and, for a restorable stream, its position (``data_state``) in the
    user content."""

    def __init__(self, checkpoint_dir: str, every_n_steps: int = 100, num_kept: int = 3,
                 async_save: bool = True):
        self.checkpoint_dir = checkpoint_dir
        self.every_n_steps = every_n_steps
        self.num_kept = num_kept
        self.async_save = async_save

    def on_step_end(self, trainer, module, step, metrics) -> None:
        if step % self.every_n_steps == 0:
            self._save(trainer, step)

    def on_train_end(self, trainer, module) -> None:
        from neuronx_distributed_tpu_torch.checkpoint import finalize_checkpoint

        self._save(trainer, int(trainer.state.step))
        finalize_checkpoint()

    def _save(self, trainer, step: int) -> None:
        from neuronx_distributed_tpu_torch.checkpoint import save_checkpoint

        content = {"step": step}
        if getattr(trainer, "train_stream", None) is not None:
            content["data_state"] = trainer.train_stream.state_dict()
        t0 = time.perf_counter()
        with trainer.tracer.span(f"checkpoint_{step}", ("trainer", "checkpoint")):
            save_checkpoint(self.checkpoint_dir, f"step_{step}", trainer.state,
                            user_content=content, async_save=self.async_save,
                            num_kept=self.num_kept)
        trainer._m_ckpt.observe((time.perf_counter() - t0) * 1e3)


class ProgressLogger(Callback):
    """A log line every ``every_n_steps`` steps and after each validation."""

    def __init__(self, every_n_steps: int = 10):
        self.every_n_steps = every_n_steps

    def on_step_end(self, trainer, module, step, metrics) -> None:
        if step % self.every_n_steps == 0:
            parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()
                             if hasattr(v, "__float__"))
            logger.info("step %d/%d %s", step, trainer.max_steps, parts)

    def on_validation_end(self, trainer, module, step, metrics) -> None:
        parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        logger.info("validation @%d %s", step, parts)
