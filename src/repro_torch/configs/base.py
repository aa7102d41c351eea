"""Configuration dataclasses: the fields of the JAX package's
``configs/base.py`` that the ported paths read (the one-card serve
paths and the FCDP train step)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.models.common import ACT_PSUM

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the activation policies of the layer stack's train forward
# (``models/stack.py``), the JAX package's ``make_remat_policy`` names
ACTIVATION_POLICIES = ("save_all", "block_io", "offload_acts",
                       "save_collectives")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # layers that are MoE: every `moe_period` starting at `moe_offset`
    moe_period: int = 1
    moe_offset: int = 0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64   # rank of the data-dependent decay LoRA


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    act: str = "swiglu"         # swiglu | geglu | gelu | relu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # the head is the embedding table's transpose (no ``head`` leaf)
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 19
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (jamba): within each period, which positions are attention
    hybrid_period: int = 0           # 0 -> not hybrid
    hybrid_attn_positions: Tuple[int, ...] = ()
    # encdec: > 0 -> an encoder of this many layers before the decoder
    num_encoder_layers: int = 0
    # vlm: the VQ image tokenizer is a stub, inputs are token ids over
    # the unified vocabulary; "vq_image" gives attention its qk-norm.
    # encdec: the audio frontend is a stub, the encoder takes frame
    # embeddings [B, S / 4, D] ("audio_frames")
    frontend: str = "none"           # none | vq_image | audio_frames
    # whether the mixer is sub-quadratic (long_500k applies)
    sub_quadratic: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic total parameter count (``models/registry.py``)."""
        from repro_torch.models.registry import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """The same with a MoE's top_k experts only."""
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell."""
    name: str               # train_4k | prefill_32k | decode_32k | long_500k
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int


# the four cells of every arch, as the JAX package defines them
SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(f"unknown shape cell {name!r}; "
                   f"have {[c.name for c in SHAPE_CELLS]}")


@dataclass(frozen=True)
class SystemConfig:
    """dtype: one type for weights and activations (the JAX package's
    param_dtype and compute_dtype; the port's matmuls take both operands
    in one type). serve_frozen: serving classifies every weight frozen,
    as the JAX bundle does.

    Train fields, as in the JAX package: ``mode`` names the sharding
    strategy (``core/strategy.py``; an unknown one raises where the
    train bundle resolves it); leaves smaller than
    ``min_shard_size`` elements stay replicated; ``param_compress`` /
    ``grad_compress`` = "int8_pod" carry the stage-1 (pod-axis) weight
    gather (qwZ) / gradient reduce-scatter (qgZ) in int8 blocks;
    ``loss_chunk`` > 0 computes logits and cross entropy in sequence
    chunks; ``master_dtype`` / ``opt_state_dtype`` type the AdamW
    master weights and moments; ``fused_matmul`` = "ag_matmul" consumes
    the eligible output projections' stage-2 gather in the gather-fused
    collective matmul (backward replays the unfused one), "both" fuses
    the backward too (``kernels/collective_matmul.py``). There is no
    ``quant_impl`` or ``fused_impl``: the device of a tensor picks each
    kernel or its plain version (``kernels/ops.py``).

    PEFT / FCDP-Comm, as in the JAX package: ``peft`` freezes every
    weight of the model and injects trainable LoRA adapters
    (``<t>_lora_a`` [in, r], ``<t>_lora_b`` [r, out]) next to each
    ``lora_targets`` projection (``core/peft.py``); ``lora_rank`` is r;
    the adapter term is scaled by ``lora_alpha`` / r (None: alpha =
    2r, scale 2.0). A strategy with the frozen cached layout (fcdp)
    stores the frozen trunk pod-replicated, so only the adapters cross
    'pod'. ``mode_overrides`` assigns leaves other strategies: ordered
    ``(path glob, mode)`` rules or ``"glob=mode"`` strings, fnmatch'd
    against each leaf's dotted path, first match wins; a rule naming an
    unknown strategy raises here, one that matches no leaf raises where
    the bundle resolves the strategies (``core/strategy.py``).

    ``act_psum`` is the transport of the tensor-parallel activation
    all-reduces over 'model' (``models/common.py``): "bf16", exact (in
    the activations' type), or "int8", block-quantized
    (``core/act_compress.py``); inert at tp 1.

    ``prefetch_depth`` is the depth k of the stage-1 prefetch ring
    (``core/schedule.py``): layer i+k's stage-1 ('pod') gather is issued
    before layer i's compute. 0 is the sequential schedule; a strategy
    with no stage 1 (mics, hier), a mesh without 'pod' and a stack of
    fewer layers cap it.

    The scheduler's streams 2 and 3 (``core/schedule.py``,
    ``core/engine/train.py``), as in the JAX package:
    ``async_grad_reduce`` differentiates each microbatch with respect to
    a leaf-level stage-1 view and issues its 'pod' reduce-scatter as
    async work, retired one microbatch later; ``cross_step_pipeline``
    carries the last microbatch's 'pod' reduce, the clip, AdamW and the
    widened gather back across the step boundary (prime / piped /
    flush). It requires ``async_grad_reduce``, and ``RunConfig``
    requires ``microbatch >= 2`` with it. A strategy with no stage 1
    (mics, hier) and a mesh without 'pod' decline both.

    FCDP-Cache (``core/cache.py``), as in the JAX package:
    ``device_cache_fraction`` (tau's output, in [0, 1]) is the share of
    the stack's leading layers whose stage-1 caches wait on the device
    instead of the host (``device_cache_groups``: under fcdp only; the
    other strategies' caches stay where they are). ``host_offload``
    False keeps every host-placed cache on the device. The
    ``activation_policy`` (``ACTIVATION_POLICIES``) says what a layer
    keeps for its backward: "save_all" everything autograd saves (the
    paper's, torch's default); "block_io" only the layer's input, the
    layer recomputed in its backward; "offload_acts" the same as
    block_io, as in the JAX package, where no value carries the
    activation mark it would offload; "save_collectives" the layer's
    input and the outputs of its 'model' all-reduces, the rest
    recomputed (``models/stack.py``).

    MoE, as in the JAX package: ``moe_token_chunk`` is the number of
    tokens one dispatch takes (its [E, C, D] buffer; more are dispatched
    in chunks of it where it divides them); ``moe_weight_resident``
    gives the experts ``fsdp_scope`` 'inter_only' (sharded over 'pod'
    only, resident within the pod)."""
    dtype: str = "bfloat16"
    serve_frozen: bool = True
    mode: str = "fcdp"
    min_shard_size: int = 2048
    param_compress: str = "none"       # none | int8_pod
    grad_compress: str = "none"        # none | int8_pod
    loss_chunk: int = 0                # 0 -> unchunked
    master_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    fused_matmul: str = "none"         # none | ag_matmul | both
    peft: bool = False
    lora_rank: int = 8
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    lora_alpha: Optional[float] = None
    mode_overrides: Tuple[Tuple[str, str], ...] = ()
    act_psum: str = "bf16"             # bf16 | int8
    prefetch_depth: int = 0
    async_grad_reduce: bool = False
    cross_step_pipeline: bool = False
    device_cache_fraction: float = 0.0
    activation_policy: str = "save_all"
    host_offload: bool = True
    moe_token_chunk: int = 8192
    moe_weight_resident: bool = False

    def __post_init__(self):
        if self.mode_overrides:
            # deferred: the strategy registry imports the mesh helpers
            from repro_torch.core.strategy import normalize_mode_overrides
            object.__setattr__(self, "mode_overrides",
                               normalize_mode_overrides(self.mode_overrides))
        if not 0.0 <= self.device_cache_fraction <= 1.0:
            raise ValueError(
                "device_cache_fraction must be in [0, 1], got "
                f"{self.device_cache_fraction!r}")
        if self.activation_policy not in ACTIVATION_POLICIES:
            raise ValueError(
                f"unknown activation_policy {self.activation_policy!r}; "
                f"known: {sorted(ACTIVATION_POLICIES)}")
        for knob in ("dtype", "master_dtype", "opt_state_dtype"):
            if getattr(self, knob) not in DTYPES:
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r}; "
                                 f"known: {sorted(DTYPES)}")
        for knob in ("grad_compress", "param_compress"):
            if getattr(self, knob) not in ("none", "int8_pod"):
                raise ValueError(
                    f"unknown {knob} {getattr(self, knob)!r}; "
                    "known: none, int8_pod")
        if self.act_psum not in ACT_PSUM:
            raise ValueError(f"unknown act_psum {self.act_psum!r}; "
                             f"known: {', '.join(ACT_PSUM)}")
        if self.fused_matmul not in ("none", "ag_matmul", "both"):
            raise ValueError(
                f"unknown fused_matmul {self.fused_matmul!r}; "
                "known: none, ag_matmul, both")
        depth = self.prefetch_depth
        if not isinstance(depth, int) or isinstance(depth, bool) \
                or depth < 0:
            raise ValueError(
                f"prefetch_depth must be a non-negative int, got {depth!r}")
        if self.cross_step_pipeline and not self.async_grad_reduce:
            raise ValueError(
                "cross_step_pipeline=True requires async_grad_reduce=True: "
                "the carried epilogue is the stream-2 deferred pod reduce "
                "plus the optimizer apply; without the async stream there "
                "is no stage-1-level pending gradient to carry")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with linear warmup and a cosine decay (the JAX package's
    default schedule, the one the port implements)."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeCell
    system: SystemConfig = field(default_factory=SystemConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    microbatch: int = 0          # 0 -> no gradient accumulation

    def __post_init__(self):
        if self.microbatch < 0:
            raise ValueError(f"microbatch must be >= 0, got "
                             f"{self.microbatch}")
        if self.system.cross_step_pipeline and self.microbatch < 2:
            raise ValueError(
                "cross_step_pipeline=True requires gradient accumulation "
                f"(microbatch >= 2), got microbatch={self.microbatch!r}: "
                "the carried epilogue is defined per accumulation step")

    def replace(self, **kw) -> "RunConfig":
        """A copy with ``kw`` changed, validated again
        (``dataclasses.replace`` re-runs ``__post_init__``); the
        reference's ``RunConfig.replace``, kept under its name so that
        code written for either package calls it alike."""
        return dataclasses.replace(self, **kw)
