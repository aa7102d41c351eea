"""One command-line surface for the system knobs of every launcher.

``add_system_args(parser)`` installs the ``SystemConfig`` flags and
``system_config_from_args(args, **overrides)`` builds the config, so
``launch/train.py`` and ``launch/dryrun.py`` take the same knobs with the
JAX package's spellings and defaults (its ``launch/cli.py``).

Two of its flags are left out: ``--quant-impl`` and ``--fused-impl``.
The port has no implementation knob: the device of a tensor picks each
kernel or its plain version (``kernels/ops.py``), so argparse rejects
both flags.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ACTIVATION_POLICIES, SystemConfig
from repro_torch.core.strategy import (DEFAULT_STRATEGY, parse_mode_override,
                                       strategy_names)

# flags whose argparse dest maps 1:1 onto a SystemConfig field
_PASSTHROUGH = ("mode", "peft", "lora_rank", "lora_alpha",
                "activation_policy", "loss_chunk",
                "grad_compress", "param_compress",
                "fused_matmul", "async_grad_reduce",
                "cross_step_pipeline", "device_cache_fraction")


def add_system_args(parser: argparse.ArgumentParser, *,
                    default_prefetch_depth: int | None = None,
                    ) -> argparse._ArgumentGroup:
    """Install the shared ``SystemConfig`` flags on ``parser``.

    default_prefetch_depth: what ``--prefetch-depth`` means when the
    flag is absent (train: None, ``SystemConfig``'s own 0; the dry run
    keeps the reference's default of 1)."""
    g = parser.add_argument_group(
        "system", "distributed-system knobs (shared across launchers)")
    g.add_argument("--mode", default=DEFAULT_STRATEGY,
                   choices=list(strategy_names()),
                   help="sharding strategy for every parameter not "
                        "claimed by a --mode-override rule")
    g.add_argument("--mode-override", action="append", default=[],
                   metavar="GLOB=MODE",
                   help="per-tensor strategy rule matched against dotted "
                        "parameter paths, first match wins; repeatable "
                        "(e.g. --mode-override '*lora*=zero3')")
    g.add_argument("--prefetch-depth", type=int,
                   default=default_prefetch_depth, metavar="N",
                   help="stage-1 prefetch ring depth: layer i+N's 'pod' "
                        "gather is issued before layer i's compute (0: "
                        "the sequential schedule; inert under mics and "
                        "hier and without a pod axis; default "
                        f"{default_prefetch_depth or 0})")
    g.add_argument("--async-grad-reduce", action="store_true",
                   help="differentiate each microbatch w.r.t. a stage-1 "
                        "view and retire its 'pod' gradient reduce-scatter "
                        "one microbatch later (needs --microbatch >= 2; "
                        "inert under mics and hier and without a pod axis)")
    g.add_argument("--cross-step-pipeline", action="store_true",
                   help="carry the last 'pod' reduce, the clip, AdamW and "
                        "the widened gather back across the step boundary "
                        "(needs --async-grad-reduce and --microbatch >= 2)")
    g.add_argument("--device-cache-fraction", type=float, default=0.0,
                   metavar="TAU",
                   help="FCDP-Cache: the share of the stack's leading "
                        "layers whose stage-1 caches wait on the device "
                        "instead of the host (fcdp only; 0: all host)")
    g.add_argument("--peft", action="store_true",
                   help="FCDP-Comm: freeze the trunk and train LoRA "
                        "adapters; only they cross 'pod' under fcdp")
    g.add_argument("--lora-rank", type=int, default=8,
                   help="LoRA adapter rank r (with --peft)")
    g.add_argument("--lora-alpha", type=float, default=None,
                   help="the adapter term is scaled by alpha/rank "
                        "(default: 2*rank, scale 2.0)")
    g.add_argument("--lora-targets", default=None, metavar="NAME[,NAME...]",
                   help="projections to inject adapters next to "
                        "(default: wq,wk,wv,wo)")
    g.add_argument("--activation-policy", default="save_all",
                   choices=ACTIVATION_POLICIES,
                   help="what a layer keeps for its backward: save_all "
                        "(autograd's default), block_io (its input; the "
                        "layer recomputed), offload_acts (= block_io), "
                        "save_collectives (its input and its 'model' "
                        "all-reduce outputs)")
    g.add_argument("--loss-chunk", type=int, default=0,
                   help="chunked cross-entropy over this many positions "
                        "(0: unchunked)")
    g.add_argument("--grad-compress", default="none",
                   choices=("none", "int8_pod"),
                   help="qgZ: int8 block-quantized 'pod' gradient "
                        "reduce-scatter")
    g.add_argument("--param-compress", default="none",
                   choices=("none", "int8_pod"),
                   help="qwZ: int8 block-quantized stage-1 ('pod') weight "
                        "all-gather")
    g.add_argument("--fused-matmul", default="none",
                   choices=("none", "ag_matmul", "both"),
                   help="consume the output projections' stage-2 gather in "
                        "the gather-fused collective matmul (ag_matmul: "
                        "the forward; both: the backward too)")
    return g


def system_config_from_args(args: argparse.Namespace,
                            **overrides) -> SystemConfig:
    """The ``SystemConfig`` of a parser that went through
    ``add_system_args``. ``overrides`` are launcher-supplied fields
    outside the shared surface (``min_shard_size``, ...) and win over
    the parsed flags."""
    kw = {f: getattr(args, f) for f in _PASSTHROUGH}
    kw["mode_overrides"] = tuple(parse_mode_override(s)
                                 for s in args.mode_override)
    if args.prefetch_depth is not None:
        kw["prefetch_depth"] = args.prefetch_depth
    if getattr(args, "lora_targets", None):
        kw["lora_targets"] = tuple(
            t.strip() for t in args.lora_targets.split(",") if t.strip())
    kw.update(overrides)
    return SystemConfig(**kw)
