"""The managed fit loop: counterpart of ``neuronx_distributed_tpu/lightning``.

Subclass :class:`NxDLightningModule` (the model, the loss, the optimizer
settings) and hand it to :class:`NxDTrainer`, which builds the model over
the parallel state of the nxd config, its optimizer and train state,
resumes from a checkpoint, and runs the steps with validation, callbacks,
logging and a preemption-safe stop:

* :class:`NxDLightningModule` — ``configure_model`` returns an ``nn.Module``;
  ``grad_accum_steps > 1`` wraps the optimizer in the port's counterpart of
  ``optax.MultiSteps`` (``optimizer/multi_steps.py``);
* :class:`NxDTrainer` — ``fit(module, train_batches, val_batches)``;
* :class:`TensorBoardLogger` / :class:`JsonLogger` — metric sinks on the
  logging rank;
* callbacks: :class:`ModelCheckpoint`, :class:`ProgressLogger`.

The trainer runs on the card unless it is built with ``device="cpu"``.
"""

from neuronx_distributed_tpu_torch.lightning.callbacks import (  # noqa: F401
    Callback,
    ModelCheckpoint,
    ProgressLogger,
)
from neuronx_distributed_tpu_torch.lightning.loggers import (  # noqa: F401
    JsonLogger,
    TensorBoardLogger,
)
from neuronx_distributed_tpu_torch.lightning.module import NxDLightningModule  # noqa: F401
from neuronx_distributed_tpu_torch.lightning.trainer import NxDTrainer  # noqa: F401
