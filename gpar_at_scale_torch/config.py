"""Config system: dataclass tree + CLI overrides.

A copy of ``gpar_at_scale_tpu/config.py`` (which imports no JAX, but the
port imports nothing of the JAX package), so that one configuration, its
JSON and its ``--section.field=value`` flags drive both packages.  Only
``kernel_family`` differs: it resolves names to the port's kernels.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class KernelConfig:
    time_family: str = "Matern52"  # EQ | Matern12 | Matern32 | Matern52 | RQ
    out_family: str = "Matern52"


@dataclass
class OptimizerConfig:
    method: str = "lbfgs"  # lbfgs | adam
    max_steps: int = 200
    learning_rate: float = 5e-2  # adam only
    gtol: float = 1e-6
    num_restarts: int = 1


@dataclass
class SamplerConfig:
    kind: str = "nuts"  # nuts | hmc | smc
    num_samples: int = 1000
    num_warmup: int = 500
    num_chains: int = 4
    max_depth: int = 8  # nuts
    num_leapfrog: int = 16  # hmc
    target_accept: float = 0.8
    num_particles: int = 1024  # smc
    ess_threshold: float = 0.5  # smc


@dataclass
class ModelConfig:
    backend: str = "scaled"  # exact | scaled
    first_output_backend: str = "temporal"  # exact | temporal
    num_pseudo_points: int = 50
    dtype: str = "float32"


@dataclass
class MeshConfig:
    axes: Sequence[str] = ("chain", "data")
    sizes: Optional[Sequence[int]] = None  # None: all devices on first axis


@dataclass
class EngineConfig:
    """Kernel-dispatch switches for the linear-algebra engine.

    pallas_dense: "off" | "on" | "interpret" -- route small dense Cholesky
    factorizations and triangular solves (float32, 8 <= n <= 512) through
    the hand-written CUDA kernels K6a/K6b/K6c (``ops/dense.py``).  "off"
    (the default, as in the JAX package) uses ``torch.linalg``; "on" takes
    the kernels for CUDA tensors and ``torch.linalg`` for anything else;
    "interpret" runs the kernels' plain versions on any device (the CPU
    test hook, the counterpart of Pallas interpret mode).  The name is the
    JAX package's, so one configuration drives both.  Environment overrides
    (highest precedence first): ``GPAR_NO_PALLAS_DENSE=1`` forces off,
    ``GPAR_PALLAS_DENSE_INTERPRET=1`` forces interpret,
    ``GPAR_PALLAS_DENSE=1`` forces on.
    """

    pallas_dense: str = "off"


@dataclass
class RunConfig:
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    profile_dir: Optional[str] = None


@dataclass
class Config:
    kernel: KernelConfig = field(default_factory=KernelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    run: RunConfig = field(default_factory=RunConfig)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        for section, values in d.items():
            sub = getattr(cfg, section)
            for k, v in values.items():
                if not hasattr(sub, k):
                    raise KeyError(f"unknown config field {section}.{k}")
                setattr(sub, k, v)
        return cfg

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    # -- CLI --------------------------------------------------------------
    def apply_overrides(self, argv: List[str]) -> List[str]:
        """Consume ``--section.field=value`` flags; returns unconsumed args."""
        rest = []
        for arg in argv:
            if arg.startswith("--") and "." in arg and "=" in arg:
                path, value = arg[2:].split("=", 1)
                section, key = path.split(".", 1)
                if hasattr(self, section) and hasattr(getattr(self, section), key):
                    sub = getattr(self, section)
                    current = getattr(sub, key)
                    if isinstance(current, bool):
                        value = value.lower() in ("1", "true", "yes")
                    elif isinstance(current, int):
                        value = int(value)
                    elif isinstance(current, float):
                        value = float(value)
                    setattr(sub, key, value)
                    continue
            rest.append(arg)
        return rest


# -- process-global runtime config -----------------------------------------
# The engine (``utils/psd.py``) consults this singleton for dispatch
# switches, so behaviour is configurable and testable without env vars.

_runtime_config: Config | None = None


def get_config() -> Config:
    """The process-global runtime Config (defaults until ``set_config``)."""
    global _runtime_config
    if _runtime_config is None:
        _runtime_config = Config()
    return _runtime_config


def set_config(cfg: Config) -> None:
    """Install a Config as the process-global runtime config."""
    global _runtime_config
    _runtime_config = cfg


def kernel_family(name: str):
    """Resolve a kernel family name from config to the port's class."""
    from gpar_at_scale_torch import kernels

    try:
        return getattr(kernels, name)
    except AttributeError:
        raise ValueError(f"unknown kernel family {name!r}") from None
