"""Checkpoints: the tagged, crash-safe, async save and load of ``core``,
over the filesystem control plane of ``storage`` and the safetensors files
of ``tensor_file``."""

from neuronx_distributed_tpu_torch.checkpoint.core import (  # noqa: F401
    CheckpointIntegrityError,
    finalize_checkpoint,
    has_checkpoint,
    latest_tag,
    load_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
