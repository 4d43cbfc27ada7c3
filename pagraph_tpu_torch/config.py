"""Single validated configuration shared by every phase.

A copy of ``pagraph_tpu/config.py``: the same five dataclasses, fields,
defaults and ``validate`` rules, so one JSON config drives either package.
Knobs that the port does not read (``scan_unroll``, ``halo_slack``) are
kept for parity; the port's ``Trainer`` says which paths it does not run
yet.
"""
from __future__ import annotations

import dataclasses
import json
import numbers
from typing import Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    arch: str = "gcn"                 # gcn | graphsage | gcn_cv | gat | gin
    n_layers: int = 1                 # hidden layers (total GNN layers = n_layers + 1)
    hidden: int = 32
    feat_dim: int = 600
    n_classes: int = 60
    dropout: float = 0.2
    aggregator: str = "mean"          # graphsage: mean | gcn | pool | lstm
    num_heads: int = 4                # gat: attention heads per layer
    preprocess: bool = False          # layer-0 pre-aggregated server-side
    skip_connection: bool = True      # cat((h, act(h))) on the last hidden layer

    @property
    def num_gnn_layers(self) -> int:
        return self.n_layers + 1

    @property
    def num_sampled_hops(self) -> int:
        """Hops the sampler must expand: one less under preprocess."""
        return self.num_gnn_layers - (1 if self.preprocess else 0)


@dataclasses.dataclass
class SamplerConfig:
    batch_size: int = 6000
    fanout: int = 2                   # neighbors per vertex per hop
    fanouts: Optional[Tuple[int, ...]] = None
                                      # per-layer fanouts, LAYER-ordered like
                                      # DGL: fanouts[0] is the outermost hop.
                                      # None = (fanout,) * num_hops
    num_hops: int = 2                 # layered expansion depth
    include_self: bool = True         # dst vertex kept in src layer
    cap_factor: float = 1.0           # scales worst-case per-layer capacity
    auto_caps: bool = True            # probe batches and shrink caps to occupancy
    backend: str = "auto"             # auto | numpy | native
    prefetch: int = 2                 # batches in flight
    seed: int = 0
    paired_draws: bool = False        # on-device sampler only: row-gather draws

    def hop_fanouts(self) -> Tuple[int, ...]:
        """Fanout at each expansion hop, seeds outward."""
        if self.fanouts is not None:
            fs = tuple(int(f) for f in reversed(self.fanouts))
            if len(fs) != self.num_hops:
                raise ValueError(
                    f"fanouts {tuple(self.fanouts)} must have "
                    f"num_hops={self.num_hops} entries"
                )
            if any(f < 1 for f in fs):
                raise ValueError(
                    f"fanouts must be >= 1, got {tuple(self.fanouts)}")
            return fs
        return (self.fanout,) * self.num_hops

    def block_fanouts(self) -> Tuple[int, ...]:
        """Per-block fanouts, outermost block first."""
        return tuple(reversed(self.hop_fanouts()))

    def layer_capacities(self, num_nodes: int, pad_to: int = 8) -> Tuple[int, ...]:
        """Static padded capacity of each minibatch layer, outermost first.

        Layer ``num_hops`` holds the seeds; each outer layer holds at most
        prev * (hop fanout + include_self) unique vertices, capped at the
        graph size and rounded up to ``pad_to``.
        """
        caps = [self.batch_size]
        inc = 1 if self.include_self else 0
        for f in self.hop_fanouts():
            nxt = min(int(caps[-1] * (f + inc) * self.cap_factor), num_nodes)
            nxt = max(nxt, 1)
            caps.append(nxt)
        caps = [-(-c // pad_to) * pad_to for c in caps]
        return tuple(reversed(caps))


@dataclasses.dataclass
class CacheConfig:
    enabled: bool = True
    capacity: Optional[int] = None    # vertices; None = auto from free device memory
    hbm_reserve_bytes: int = 1 << 30  # headroom kept free
    rank_by: str = "out_degree"       # out_degree | in_degree | access_freq
    track_stats: bool = True
    dtype: str = "float32"            # cache row tier: float32 | bfloat16 | int8


@dataclasses.dataclass
class PartitionConfig:
    num_parts: int = 1
    method: str = "dg"                # dg | hash
    num_hops: int = 1                 # closure depth for self-reliance
    ordering: bool = False            # locality reordering before partitioning
    edge_balance: bool = False        # dg: balance partitions by edge footprint


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-2
    lr_schedule: str = "none"         # none | cosine
    lr_decay_steps: int = 0           # cosine horizon
    epochs: int = 10
    log_every: int = 20
    warmup_epochs: int = 2            # excluded from the epoch-time mean
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0               # epochs between checkpoints; 0 = off
    eval_every: int = 0               # epochs between validation evals; 0 = off
    eval_backend: str = "auto"        # host | device | auto
    remote_sampling: bool = False     # isolation mode: sampling in worker procs
    on_device_sampling: bool = False  # whole epoch sampled on the device
    steps_per_dispatch: int = 8       # host path: K batches per dispatch (a CUDA graph)
    epoch_dispatch: str = "scan"      # scan | steps | pipelined: CUDA graphs on the card
    scan_unroll: int = 1              # JAX package: minibatches per scan step (ignored)
    halo_slack: float = 1.5           # multi-device halo width factor
    halo_pipeline: bool = False       # multi-device edge mode only
    dtype: str = "float32"            # compute dtype: float32 | bfloat16


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    partition: PartitionConfig = dataclasses.field(default_factory=PartitionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        m, s = self.model, self.sampler
        if m.arch not in ("gcn", "graphsage", "gcn_cv", "gat", "gin"):
            raise ValueError(f"unknown arch {m.arch!r}")
        if m.aggregator not in ("mean", "gcn", "pool", "lstm"):
            raise ValueError(f"unknown aggregator {m.aggregator!r}")
        if m.arch == "gcn_cv" and not m.preprocess:
            raise ValueError(
                "gcn_cv consumes pre-aggregated layer-0 features: set "
                "model.preprocess=True"
            )
        if m.arch == "gat":
            if m.preprocess:
                raise ValueError(
                    "gat needs raw per-neighbor features: preprocess "
                    "pre-aggregation is incompatible with attention"
                )
            if m.num_heads < 1:
                raise ValueError("gat needs num_heads >= 1")
        if m.arch == "gin" and m.preprocess:
            raise ValueError(
                "gin needs the raw (1+eps)*self + sum update: the store's "
                "mean pre-aggregation would change the model"
            )
        if (isinstance(s.fanout, bool)
                or not isinstance(s.fanout, numbers.Integral)):
            raise ValueError(
                f"sampler.fanout must be an integer (got "
                f"{type(s.fanout).__name__}); pass per-hop lists via "
                "sampler.fanouts"
            )
        s.hop_fanouts()                 # raises on bad per-hop fanouts
        if s.num_hops != m.num_sampled_hops:
            raise ValueError(
                f"sampler.num_hops={s.num_hops} must equal "
                f"model layers{'-1 (preprocess)' if m.preprocess else ''}"
                f"={m.num_sampled_hops}"
            )
        if self.partition.num_hops < 1:
            raise ValueError("partition.num_hops must be >= 1")
        t = self.train
        if t.lr_schedule not in ("none", "cosine"):
            raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
        if t.lr_schedule == "cosine" and t.lr_decay_steps <= 0:
            raise ValueError(
                "lr_schedule='cosine' needs lr_decay_steps > 0 "
                "(total optimizer steps of the planned run)")
        if t.halo_slack < 1.0:
            raise ValueError("train.halo_slack must be >= 1.0")
        if t.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"train.dtype must be float32|bfloat16, "
                             f"got {t.dtype!r}")
        if t.eval_backend not in ("host", "device", "auto"):
            raise ValueError(f"train.eval_backend must be host|device|auto, "
                             f"got {t.eval_backend!r}")
        if t.epoch_dispatch not in ("scan", "steps", "pipelined"):
            raise ValueError(f"train.epoch_dispatch must be "
                             f"scan|steps|pipelined, "
                             f"got {t.epoch_dispatch!r}")
        if t.epoch_dispatch != "scan" and not t.on_device_sampling:
            raise ValueError(
                f"epoch_dispatch={t.epoch_dispatch!r} only applies to the "
                "on-device sampling path (train.on_device_sampling=True)")
        if self.cache.dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"cache.dtype must be float32|bfloat16|int8, "
                             f"got {self.cache.dtype!r}")
        if t.on_device_sampling:
            if t.remote_sampling:
                raise ValueError(
                    "on_device_sampling and remote_sampling are exclusive"
                )
            if not self.cache.enabled:
                raise ValueError(
                    "on_device_sampling requires cache.enabled (the full "
                    "feature set must live in device memory)"
                )
            if not s.include_self:
                raise ValueError("on_device_sampling requires include_self")

    def sync_hops(self) -> "Config":
        """Derive sampler/partition hops from the model (the safe default)."""
        self.sampler.num_hops = self.model.num_sampled_hops
        self.partition.num_hops = self.model.num_sampled_hops
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        return cls(
            model=ModelConfig(**raw.get("model", {})),
            sampler=SamplerConfig(**raw.get("sampler", {})),
            cache=CacheConfig(**raw.get("cache", {})),
            partition=PartitionConfig(**raw.get("partition", {})),
            train=TrainConfig(**raw.get("train", {})),
        )
