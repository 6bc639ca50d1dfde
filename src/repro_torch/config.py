"""Run configuration: copies of ``repro.config.DeFTAConfig`` and
``TrainConfig`` with the same fields and defaults (a test pins them
equal). The field comments of the reference apply; fields this slice does
not carry raise ``NotImplementedError`` where the engine is built
(``core.engine.check_supported``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DeFTAConfig:
    """The paper's algorithm knobs (§3)."""
    num_workers: int = 20
    avg_peers: int = 4               # average outdegree (paper: 4)
    num_sampled: int = 2             # |S_i| sampled peers per round (paper: 2)
    topology: str = "random_kout"    # ring | random_kout | erdos | dense
    aggregation: str = "defta"       # defta | defl | uniform (robust rules
                                     # trimmed_mean | median | krum: later)
    robust_trim: float = 0.25
    use_dts: bool = True
    dts_signal: str = "loss"         # only "loss" in this slice
    dts_geom_weight: float = 1.0
    dts_corr_weight: float = 4.0
    dts_sketch_rounds: int = 8
    dts_sketch_dim: int = 64
    dts_conf_decay: float = 1.0      # cross-device only
    dts_min_obs: int = 2             # cross-device only
    max_staleness: int = 0
    time_machine: bool = True        # §3.3 damage check + backup rollback
    crelu_slope: float = 0.2         # paper Eq. 13
    local_epochs: int = 10           # paper: 10 local epochs per round
    gossip_every: int = 1
    gossip_dtype: str = "float32"    # wire: "float32" | "bfloat16" | "int8"
    gossip_error_feedback: bool = True   # EF21 residuals on a lossy wire
    gossip_wire_round: str = "nearest"   # int8 rounding ("stochastic": later)
    dp_clip: float = 0.0
    dp_sigma: float = 0.0
    dp_update_clip: float = 1.0
    secagg: Optional[str] = None
    secagg_mode: str = "edge"
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"          # the sync engine runs plain SGD
    learning_rate: float = 0.01      # paper default
    weight_decay: float = 0.0
    momentum: float = 0.0
    batch_size: int = 64             # paper default
    epochs: int = 100                # paper: global epochs E
    grad_clip: float = 0.0
    microbatches: int = 1
    seed: int = 0
