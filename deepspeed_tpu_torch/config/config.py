"""Training config (counterpart of ``deepspeed_tpu/config/config.py``).

``DeepSpeedTPUConfig`` parses the JSON-style dict the JAX package's
``initialize`` takes, with the same section and field names and defaults, and
resolves the batch triad for a world of one device. The port carries the
subset its training slice reads: the batch triad, ``steps_per_print``,
``gradient_clipping``, ``seed``, ``optimizer``, ``scheduler``,
``zero_optimization.stage`` 0-1 and ``bf16``. An unknown key raises
``ValueError``; a known setting outside the slice (fp16, ZeRO stage 2-3,
offload, quantized collectives, a mesh of more than one device, or an
enabled monitoring / checkpointing / diagnostics section) raises
``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.config.config_utils import DeepSpeedConfigModel


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    # fp32 accumulation of micro-batch gradients; False carries the
    # accumulator in bf16 (the optimizer math is fp32 either way)
    accumulate_grads_in_fp32: bool = True


# zero_optimization keys of the JAX config that shape only the collectives of
# a sharded run (bucketing, overlap, stage-3 gathering and persistence) or a
# checkpoint save. A run on one device issues no collectives, so they change
# nothing there: they are accepted so that a JAX config loads, and not stored.
_ZERO_SINGLE_DEVICE_NOOPS = (
    "contiguous_gradients", "reduce_scatter", "reduce_bucket_size", "allgather_partitions",
    "allgather_bucket_size", "overlap_comm", "sub_group_size", "param_persistence_threshold",
    "model_persistence_threshold", "max_live_parameters", "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save", "mics_hierarchical_params_gather",
    "round_robin_gradients", "ignore_unused_parameters", "log_trace_cache_warnings",
)


@dataclasses.dataclass
class ZeroConfig(DeepSpeedConfigModel):
    """zero_optimization: on one device stages 0 and 1 are the same program
    (there is nothing to shard the optimizer state over). The fields are the
    settings the port refuses when switched on, plus ``stage``."""

    stage: int = 0
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    loco_param: Optional[Dict[str, Any]] = None
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ZeroConfig":
        return super().from_dict(
            {k: v for k, v in data.items() if k not in _ZERO_SINGLE_DEVICE_NOOPS})

    def __post_init__(self):
        out_of_slice = {
            "stage": self.stage >= 2,
            "offload_param": (self.offload_param or {}).get("device", "none") != "none",
            "offload_optimizer": (self.offload_optimizer or {}).get("device", "none") != "none",
            "zero_quantized_weights": self.zero_quantized_weights,
            "zero_quantized_gradients": self.zero_quantized_gradients,
            "loco_param": bool(self.loco_param),
            "zero_hpz_partition_size": self.zero_hpz_partition_size > 1,
            "mics_shard_size": self.mics_shard_size > 0,
        }
        for name, refused in out_of_slice.items():
            if refused:
                raise NotImplementedError(
                    f"zero_optimization.{name}={getattr(self, name)!r} is not ported to PyTorch "
                    "(stages 0-1 on one device, no offload, no quantized collectives)")


@dataclasses.dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "AdamW"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MeshConfig(DeepSpeedConfigModel):
    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    num_slices: int = 1
    dcn_axis: str = "dp"

    def __post_init__(self):
        sizes = {n: getattr(self, n) for n in ("pp", "dp", "fsdp", "ep", "sp", "tp", "num_slices")}
        if any(v > 1 for v in sizes.values()):
            raise NotImplementedError(
                f"mesh {sizes}: the PyTorch port trains on one device (dp=-1 resolves to 1)")


# Sections of the JAX config that switch on with ``enabled``; none is ported.
_ENABLED_SECTIONS = (
    "activation_checkpointing", "tensorboard", "csv_monitor", "wandb", "flops_profiler",
    "comms_logger", "collectives", "telemetry", "diagnostics", "numerics", "hbm_guard",
    "snapshot", "data_efficiency", "moe_autotune", "gradient_compression", "elasticity",
    "autotuning",
)
# Sections without an ``enabled`` switch; any setting in them is outside the slice.
_OTHER_SECTIONS = ("recovery", "pipeline", "checkpoint", "compression_training")
# Top-level settings outside the slice, with the JAX defaults they must keep.
_FIXED_DEFAULTS = {
    "wall_clock_breakdown": False, "memory_breakdown": False, "dump_state": False,
    "prescale_gradients": False, "gradient_predivide_factor": 1.0, "sparse_gradients": False,
    "disable_allgather": False, "communication_data_type": None,
}
_PORTED = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
           "steps_per_print", "gradient_clipping", "seed", "optimizer", "scheduler", "fp16",
           "bf16", "zero_optimization", "mesh")


@dataclasses.dataclass
class EngineConfig:
    """The ported subset of the JAX ``EngineConfig``, field names and defaults
    as there."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    seed: int = 1234
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "EngineConfig":
        known = set(_PORTED) | set(_ENABLED_SECTIONS) | set(_OTHER_SECTIONS) | set(_FIXED_DEFAULTS)
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"config: unknown key(s) {unknown}")
        for name in _ENABLED_SECTIONS:
            section = data.get(name) or {}
            if not isinstance(section, dict):
                raise ValueError(f"config: {name} must be a dict, got {type(section).__name__}")
            if section.get("enabled", False):
                raise NotImplementedError(f"config: {name}.enabled is not ported to PyTorch")
        for name in _OTHER_SECTIONS:
            if data.get(name):
                raise NotImplementedError(f"config: the {name} section is not ported to PyTorch")
        for name, default in _FIXED_DEFAULTS.items():
            if name in data and data[name] != default:
                raise NotImplementedError(
                    f"config: {name}={data[name]!r} is not ported to PyTorch (only {default!r})")
        sections = {"fp16": FP16Config, "bf16": BF16Config, "zero_optimization": ZeroConfig,
                    "mesh": MeshConfig, "optimizer": OptimizerConfig,
                    "scheduler": SchedulerConfig}
        kwargs = {}
        for name in _PORTED:
            if name not in data or data[name] == "auto":
                continue
            value = data[name]
            if name in sections and value is not None:
                value = sections[name].from_dict(value)
            kwargs[name] = value
        cfg = cls(**kwargs)
        if cfg.fp16.enabled:
            raise NotImplementedError("config: fp16 is not ported to PyTorch (use bf16)")
        return cfg


class DeepSpeedTPUConfig:
    """Parsed and resolved config: the runtime-facing object, with the batch
    triad resolved for one device exactly as the JAX package resolves it for
    a data-parallel world of 1."""

    def __init__(self, config: Union[str, Dict[str, Any], None] = None):
        if config is None:
            config = {}
        if isinstance(config, str):
            with open(config, "r") as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ValueError(f"Expected a dict or a path to a JSON file, got {type(config)}")
        self.raw: Dict[str, Any] = dict(config)
        self.model = EngineConfig.from_dict(config)
        self._resolve_batch_triad()

    def _resolve_batch_triad(self) -> None:
        m = self.model
        train, micro, gas = (m.train_batch_size, m.train_micro_batch_size_per_gpu,
                             m.gradient_accumulation_steps)
        if train is not None and micro is not None and gas is not None:
            if train != micro * gas:
                raise ValueError(
                    f"Inconsistent batch config: train_batch_size={train} != "
                    f"micro_batch({micro}) * gas({gas}) * dp_world(1)")
        elif train is not None and micro is not None:
            gas = train // micro
            if train % micro != 0 or gas == 0:
                raise ValueError(f"train_batch_size={train} not divisible by micro_batch({micro})")
        elif train is not None and gas is not None:
            micro = train // gas
            if train % gas != 0 or micro == 0:
                raise ValueError(f"train_batch_size={train} not divisible by gas({gas})")
        elif micro is not None:
            gas = gas or 1
            train = micro * gas
        elif train is not None:
            micro, gas = train, 1
        else:
            micro, gas = 1, gas or 1
            train = micro * gas
        m.train_batch_size, m.train_micro_batch_size_per_gpu = train, micro
        m.gradient_accumulation_steps = gas

    @property
    def train_batch_size(self) -> int:
        return self.model.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.model.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.model.gradient_accumulation_steps

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.model.bf16.enabled else torch.float32

    @property
    def gradient_clipping(self) -> float:
        return self.model.gradient_clipping
