"""Typed configuration system for the repro framework.

Every run is described by a ``RunConfig`` = (ModelConfig, ShapeConfig, MeshConfig,
TrainConfig).  Architecture configs live in ``repro_torch.configs.<arch>`` and register
themselves with :mod:`repro_torch.config.registry`.

Configs are frozen dataclasses so they can be used as static jit arguments and
hashed into cache keys for lowering artifacts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

FAMILIES = (
    "dense",      # decoder-only transformer
    "moe",        # decoder-only with MoE FFN
    "hybrid",     # Mamba2 backbone + periodic shared attention (zamba2)
    "ssm",        # attention-free (rwkv6)
    "encdec",     # encoder-decoder (seamless)
    "vlm",        # vision frontend stub + LM backbone (internvl2)
    "audio",      # audio frontend stub + enc-dec backbone (seamless is audio+encdec)
    "conv",       # LeNet-style CNN (the paper's own workload)
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    The same dataclass describes every family; family-specific fields default to
    zero/None and are ignored elsewhere.  ``head_dim`` may be decoupled from
    ``d_model // num_heads`` (qwen3, gemma3).
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int = 0            # 0 for attention-free families
    num_kv_heads: int = 0
    d_ff: int = 0                 # per-expert d_ff for MoE families
    vocab_size: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0            # Mamba2 state dimension N
    ssm_expand: int = 2           # Mamba2 expansion factor
    ssm_conv: int = 4             # depthwise conv width
    attn_every: int = 0           # hybrid: shared attention block every N layers
    # --- RWKV ---
    rwkv_head_dim: int = 64

    # --- attention pattern ---
    window_size: int = 0          # >0: sliding-window attention width
    global_every: int = 0         # gemma3: full-attention every N layers (rest windowed)
    qkv_bias: bool = False
    logit_softcap: float = 0.0

    # --- encoder-decoder ---
    encoder_layers: int = 0

    # --- modality frontend (stub: input_specs provides precomputed embeddings) ---
    frontend: str = "none"        # none | audio_frames | vision_patches
    frontend_seq: int = 0         # number of frame/patch embeddings prepended

    # --- conv (LeNet) ---
    conv_channels: Tuple[int, ...] = ()
    conv_kernel: int = 5
    fc_dims: Tuple[int, ...] = ()
    image_hw: int = 28
    image_c: int = 1
    num_classes: int = 10

    # --- numerics ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/param compute dtype
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; expected one of {FAMILIES}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling -> eligible for long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # none of the assigned archs is encoder-only

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models import param_count  # local import to avoid cycle
        return param_count(self)

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: only routed experts count)."""
        from repro_torch.models import param_count
        return param_count(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, global_batch) workload cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    def __post_init__(self):
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"bad shape kind {self.kind!r}")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

STANDARD_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in STANDARD_SHAPES}


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. axis_names align with sharding rules."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    # how the "pod" axis is used when present: "data" (pure DP) or "pipeline"
    pod_role: str = "data"

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def is_multi_pod(self) -> bool:
        return "pod" in self.axis_names

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))
SMOKE_MESH = MeshConfig((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# Training / serving / sharding knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardingConfig:
    """Logical-axis -> mesh-axis mapping knobs (see distributed/sharding.py)."""

    fsdp: bool = True                 # shard params/opt-state over the data axis too
    sequence_sharding: bool = True    # Megatron-SP residual stream over model axis
    shard_embed_over: str = "model"   # embedding table: partition d_model or vocab
    sequence_parallel_decode: bool = False  # SP for long-context decode KV/state
    expert_parallel: bool = True      # shard MoE experts over model axis
    remat_policy: str = "full"        # "none" | "full" | "dots" (checkpoint policy)
    scan_layers: bool = True          # lax.scan over stacked layer params
    gradient_compression: str = "none"  # "none" | "int8"
    moe_gather_once: bool = False     # explicit seq all-gather before dispatch
    bf16_norm_apply: bool = False     # fp32 stats, bf16 scale-apply in norms
    collective_matmul: bool = False   # beyond-paper: overlap AG with matmul
    extra_rules: Tuple[Tuple[str, Any], ...] = ()


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    accum_steps: int = 1
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    label_smoothing: float = 0.0
    z_loss: float = 1e-4
    moe_aux_loss: float = 1e-2


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD_MESH
    sharding: ShardingConfig = ShardingConfig()
    train: TrainConfig = TrainConfig()

    def cache_key(self) -> str:
        return f"{self.model.name}:{self.shape.name}:{'x'.join(map(str, self.mesh.shape))}"
