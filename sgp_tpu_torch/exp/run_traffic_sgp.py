"""The SGP experiments' flag surface.

Counterpart of ``configure_parser`` and ``derive_order`` of
``sgp_tpu/exp/run_traffic_sgp.py``, which the large-scale runner
(``exp/run_largescale_sgp.py``) extends. The traffic runner itself
(``run_experiment``, with the SGP loaders) is not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import argparse

from sgp_tpu_torch.exp.common import add_common_args, str2bool


def configure_parser(data_sharding_choices=("none", "batch")
                     ) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--encoder-name", type=str, default="sgp")
    parser.add_argument("--model-name", type=str, default="sgp")
    # preprocessing
    parser.add_argument("--preprocess-exogenous", type=str2bool,
                        default=True)
    parser.add_argument("--keep-raw", type=str2bool, default=True)
    parser.add_argument("--iid-sampling", type=str2bool, default=False)
    parser.add_argument("--sgp-preprocessing", type=str2bool,
                        default=False)
    # reservoir and spatial flags (the encoder's surface)
    parser.add_argument("--reservoir-size", type=int, default=32)
    parser.add_argument("--reservoir-layers", type=int, default=1)
    parser.add_argument("--leaking-rate", type=float, default=0.9)
    parser.add_argument("--spectral-radius", type=float, default=0.9)
    parser.add_argument("--density", type=float, default=0.7)
    parser.add_argument("--input-scaling", type=float, default=1.0)
    parser.add_argument("--alpha-decay", type=str2bool, default=False)
    parser.add_argument("--reservoir-activation", type=str, default="tanh")
    parser.add_argument("--receptive-field", type=int, default=1)
    parser.add_argument("--bidirectional", type=str2bool, default=False)
    parser.add_argument("--undirected", type=str2bool, default=False)
    parser.add_argument("--add-self-loops", type=str2bool, default=False)
    parser.add_argument("--global-attr", type=str2bool, default=False)
    # decoder flags
    parser.add_argument("--hidden-size", type=int, default=32)
    parser.add_argument("--mlp-size", type=int, default=32)
    parser.add_argument("--emb-size", type=int, default=32)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--fully-connected", type=str2bool, default=False)
    parser.add_argument("--positional-encoding", type=str2bool,
                        default=True)
    parser.add_argument("--resnet", type=str2bool, default=False)
    parser.add_argument("--rec-layers", type=int, default=1)  # esn
    parser.add_argument("--fused", type=str2bool, default=True,
                        help="sampling, gather and train steps on the "
                             "device, batches_epoch steps a call")
    parser.add_argument("--encode-dtype", type=str, default=None,
                        help="storage dtype of the encoding, e.g. "
                             "bfloat16 (halves its memory)")
    parser.add_argument("--encode-time-chunk", type=int, default=None)
    if data_sharding_choices:
        parser.add_argument(
            "--data-sharding", type=str, default="none",
            choices=data_sharding_choices,
            help="multi-device training: not ported yet (ROADMAP A10)")
    return parser


def derive_order(args) -> int:
    """The decoder's number of feature blocks: the states, the hops of
    each direction, the global mean, for each reservoir layer."""
    order = 1
    order += (2 if args.bidirectional else 1) * args.receptive_field
    if args.global_attr:
        order += 1
    order *= args.reservoir_layers
    return order
