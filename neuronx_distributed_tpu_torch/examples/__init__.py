"""Training entry points a user runs: ``common`` (arguments, the learning
rate schedule, ``train_loop``, ``maybe_resume``, synthetic batches) and
``codegen25`` (FIM pretraining from token shards), ``llama2_tp_zero1``
(TP + ZeRO-1 + SP), ``llama2_tp_pp`` (TP x PP, BASELINE config #4),
``mixtral_moe`` (TP x EP), ``gpt_neox_pretrain`` (NeoX 6.9B/20B, TP + ZeRO-1
+ SP) and ``bert_pretrain`` (BERT-large MLM + NSP, BASELINE config #2)."""
