"""Training entry points a user runs: ``common`` (arguments, the learning
rate schedule, ``train_loop``, ``maybe_resume``, synthetic batches) and
``codegen25`` (FIM pretraining from token shards)."""
