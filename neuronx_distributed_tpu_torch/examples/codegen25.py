"""CodeGen2.5-7B pretraining with fill-in-the-middle (FIM) data, on the
port.

Counterpart of ``examples/training/codegen25.py`` of the JAX package.
CodeGen2.5 is a Llama at 7B widths (hidden 4096, intermediate 11008, 32
layers, 32 heads) with a code vocabulary of 51200, so the model is
``LlamaForCausalLM`` at those dims. Token shards written with
``write_token_shard`` (synthesized when ``--data_dir`` holds none) are read
by the native ``TokenShardDataset``, FIM-permuted on the host and trained
on with async checkpoints; a resumed run fast-forwards the stream past the
batches already trained on, so it continues mid-epoch. ``--hf_checkpoint``
starts from an HF Llama checkpoint (local safetensors) instead of the
seeded init.

    python3 -m neuronx_distributed_tpu_torch.examples.codegen25 --steps 100
    python3 -m neuronx_distributed_tpu_torch.examples.codegen25 --tiny --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from neuronx_distributed_tpu_torch.data.loader import TokenShardDataset, write_token_shard
from neuronx_distributed_tpu_torch.examples.common import (
    add_common_args,
    make_lr,
    maybe_resume,
    train_loop,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

CODEGEN_VOCAB = 51200


def fim_permute(ids: np.ndarray, rng: np.random.RandomState, vocab: int,
                fim_rate: float = 0.5) -> np.ndarray:
    """Row-wise FIM in PSM form: with probability ``fim_rate`` a row becomes
    ``<fim_prefix> prefix <fim_suffix> suffix <fim_middle> middle``. The
    sentinels are the top three ids of the vocabulary; the row keeps its
    length (the insertions displace its last 3 tokens)."""
    pre_id, mid_id, suf_id = vocab - 3, vocab - 2, vocab - 1
    out = ids.copy()
    s = ids.shape[1]
    if s < 8:
        return out
    for r in range(ids.shape[0]):
        if rng.rand() >= fim_rate:
            continue
        lo = rng.randint(1, s - 5)
        hi = rng.randint(lo + 1, s - 3)
        prefix, middle, suffix = ids[r, :lo], ids[r, lo:hi], ids[r, hi:s - 3]
        out[r] = np.concatenate([[pre_id], prefix, [suf_id], suffix, [mid_id], middle])
    return out


def fim_batches(ds, fim_rate: float, vocab: int, seed: int, ignore_index: int = -100):
    """The shard iterator with FIM; labels re-shift to the permuted stream."""
    rng = np.random.RandomState(seed)
    for batch in ds:
        ids = fim_permute(batch["ids"], rng, vocab, fim_rate)
        labels = np.full_like(ids, ignore_index)
        labels[:, :-1] = ids[:, 1:]
        yield {"ids": ids, "labels": labels}


def synth_code_shards(out_dir: Path, vocab: int, seq: int, rows: int, n_shards: int = 2,
                      seed: int = 0):
    """A synthetic 'code' corpus as token shards, from a seeded numpy stream
    (the sentinel ids stay reserved)."""
    rs = np.random.RandomState(seed)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_shards):
        toks = rs.randint(0, vocab - 3, (rows // n_shards, seq)).astype(np.int32)
        p = out_dir / f"code_{i:04d}.tokens"
        write_token_shard(str(p), toks)
        paths.append(str(p))
    return paths


def build_config(args, seq: int) -> LlamaConfig:
    if args.tiny:
        return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=4, max_seq_len=seq, dtype=torch.float32,
                           use_flash_attention=False, remat_policy=None)
    return LlamaConfig(vocab_size=CODEGEN_VOCAB, hidden_size=4096, intermediate_size=11008,
                       num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=seq,
                       dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       remat_policy="attention")


def main(argv=None) -> float:
    parser = add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--data_dir", type=str, default=None,
                        help="directory of .tokens shards (synthesized when empty)")
    parser.add_argument("--fim_rate", type=float, default=0.5)
    parser.add_argument("--hf_checkpoint", type=str, default=None,
                        help="start from this HF Llama checkpoint (a safetensors file or dir)")
    args = parser.parse_args(argv)
    tp = args.tensor_parallel_size or 1
    batch = args.batch_size or (4 if args.tiny else 8)
    seq = args.seq_len or (32 if args.tiny else 2048)
    steps = args.steps or (4 if args.tiny else 100)
    vocab = 512 if args.tiny else CODEGEN_VOCAB

    data_dir = Path(args.data_dir) if args.data_dir else (
        Path(args.checkpoint_dir or ".") / "codegen_shards")
    paths = sorted(str(p) for p in data_dir.glob("*.tokens"))
    if not paths:
        paths = synth_code_shards(data_dir, vocab, seq, rows=max(batch * 8, 32))
    ds = TokenShardDataset(paths, batch_size=batch, shuffle_seed=args.seed)
    seq = ds.seq_len   # the shards define the sequence length
    batches = fim_batches(ds, args.fim_rate, vocab, args.seed)

    lcfg = build_config(args, seq)
    nxd_config = neuronx_distributed_config(
        tensor_parallel_size=tp,
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True},
        model_init_config={"seed": args.seed})
    params = None
    if args.hf_checkpoint:
        from neuronx_distributed_tpu_torch.converters.hf_llama import (
            hf_to_nxd_llama,
            load_hf_safetensors,
        )

        params = hf_to_nxd_llama(load_hf_safetensors(args.hf_checkpoint), lcfg)
    # the first batch is consumed here, as the JAX script's init sample is
    next(batches)
    model = initialize_parallel_model(nxd_config, lambda: LlamaForCausalLM(lcfg),
                                      device=args.device, params=params)
    opt = initialize_parallel_optimizer(nxd_config, model, learning_rate=make_lr(args, steps),
                                        weight_decay=args.weight_decay)
    state = maybe_resume(args.checkpoint_dir, create_train_state(model, opt))
    # mid-epoch resume: skip the batches already trained on (the shard
    # order and the FIM draws are functions of the seed)
    for _ in range(int(state.step)):
        next(batches)

    def loss_fn(p, b, rng):
        return model.apply(p, b["ids"], b["labels"], method="loss")

    step = make_train_step(model, opt, loss_fn, grad_accum_steps=args.grad_accum_usteps)
    state, metrics = train_loop(
        step, state, batches, steps, batch_size=batch, device=model.device,
        log_every=args.log_every, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, metrics_file=args.metrics_file,
        profile_dir=args.profile_dir, trace_out=args.trace_out, metrics_out=args.metrics_out,
        extra_metrics={"loader_native": int(ds.using_native), "loader_seq_len": int(ds.seq_len),
                       "loader_shards": len(paths)})
    print(f"final loss {float(metrics['loss']):.4f} (native loader: {ds.using_native})")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
