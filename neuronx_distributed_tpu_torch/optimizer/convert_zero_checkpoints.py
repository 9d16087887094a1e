"""Offline ZeRO checkpoint conversion.

Counterpart of ``neuronx_distributed_tpu/optimizer/convert_zero_checkpoints.py``
(the reference's ``merge_optim_dp_checkpoints`` / ``split_and_save_ckpts``).
A tag of the port's format stores every leaf in its global layout, in
pieces written by many ranks (``checkpoint/core.py``; an expert leaf a
piece per (ep, tp) slice, its ZeRO-1 state per edp rank), and loads at
any layout, so re-splitting for another DP, TP or EP degree needs no
tool. What remains
is consolidating a tag into one global tree written by one rank, at
another location: the whole ``TrainState`` (ZeRO-1 shards of mu, nu and
the masters joined into whole leaves), or with ``--params-only`` the
params alone (weights for evaluation or export).

    python3 -m neuronx_distributed_tpu_torch.optimizer.convert_zero_checkpoints \\
        --input CKPT_DIR --output OUT_DIR [--tag step_100] [--out_tag weights] [--params-only]
"""

from __future__ import annotations

import argparse
from typing import Optional

from neuronx_distributed_tpu_torch.checkpoint import latest_tag, load_checkpoint, save_checkpoint


def convert(input_dir: str, output_dir: str, tag: Optional[str] = None,
            out_tag: Optional[str] = None, params_only: bool = False) -> str:
    """Load ``input_dir[/tag]`` (default: the newest tag) as one global tree
    and save it to ``output_dir`` as one rank. Returns the tag written."""
    if tag is None:
        tag = latest_tag(input_dir)
    state, user_content = load_checkpoint(input_dir, tag=tag)
    if params_only:
        if not (isinstance(state, dict) and "params" in state):
            raise ValueError("checkpoint has no 'params' entry — is this a TrainState tag?")
        state = state["params"]
    out_tag = out_tag or tag or "converted"
    save_checkpoint(output_dir, out_tag, state, user_content=user_content)
    return out_tag


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help="source checkpoint directory")
    p.add_argument("--output", required=True, help="destination directory")
    p.add_argument("--tag", default=None, help="source tag (default: newest)")
    p.add_argument("--out_tag", default=None, help="destination tag")
    p.add_argument("--params-only", action="store_true",
                   help="strip the optimizer state: write only the param tree")
    args = p.parse_args(argv)
    tag = convert(args.input, args.output, args.tag, args.out_tag, args.params_only)
    print(f"wrote {args.output}/{tag}")


if __name__ == "__main__":
    main()
