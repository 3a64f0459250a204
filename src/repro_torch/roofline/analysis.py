"""Three-term roofline of a dry-run cell, as ``repro.roofline.analysis``:

  compute term    = FLOPs per chip / peak FLOP/s
  memory term     = bytes per chip / HBM bandwidth
  collective term = collective bytes per chip / link bandwidth

The JAX package reads the per-device terms off a compiled SPMD program.
The port has no partitioner: :func:`from_counted` takes the cost that
``roofline.op_cost`` counted for one data shard's step (the batch split
over the data axes where it divides, else the whole batch) and splits it
evenly over the ``model`` axis. So "per chip" here is the counted
shard's work divided by the model axis's size: what the rule table's
tensor parallelism would leave each device if it split every op evenly.
The collective term is ``op_cost.collective_bytes`` (one forward's),
plus for a train cell ``op_cost.collective_bytes_bwd`` (the recompute's,
the backward's and the smaller sites'), reckoned from the rule table's
layout as the port's tensor-parallel step moves them.

Hardware constants: the NVIDIA H100 SXM5 (700 W), published peaks, not
measurements: 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of
HBM3 (NVIDIA H100 data sheet), the values ``chip_smoke.py`` bounds its
kernels with. The collective rate is 50 GB/s a GPU, one direction: the
NDR InfiniBand link (400 Gb/s) each H100 of a DGX H100 / HGX H100 node has
to the network (NVIDIA DGX H100 user guide: eight ConnectX-7 ports, one a
GPU). The production mesh's 16-wide ``data`` and ``model`` axes span more
than one 8-GPU NVLink node, so a ring over either axis crosses that
network link, which bounds it, and not NVLink's 450 GB/s a direction.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

# --- hardware constants (H100 SXM5, 700 W, published dense peaks) -----------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per GPU (tensor cores, dense)
HBM_BW = 3.35e12             # bytes/s per GPU (HBM3)
LINK_BW = 50e9               # bytes/s per GPU, one direction (NDR 400 Gb/s)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float          # the counted FLOPs, per chip
    hlo_bytes_per_chip: float          # kernel-fused HBM traffic, per chip
    collective_bytes_per_chip: float
    collective_breakdown: dict
    model_flops: float                 # 6*N*D (or 2*N_active per decode token)
    bytes_per_chip_peak: Optional[float] = None   # the dry run's temp bytes
    # traffic the twins materialise inside the LM kernels (scores, states),
    # which the kernels keep on chip; raw = fused + this
    fusible_bytes_per_chip: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def memory_raw_s(self) -> float:
        """Memory term without the kernels' on-chip credit."""
        return (self.hlo_bytes_per_chip + self.fusible_bytes_per_chip) / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — remat/redundancy waste."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x roofline step time)."""
        denom = self.chips * PEAK_FLOPS * self.step_time_s
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            memory_raw_s=self.memory_raw_s,
            collective_s=self.collective_s,
            bottleneck=self.bottleneck,
            step_time_s=self.step_time_s,
            useful_flops_fraction=self.useful_flops_fraction,
            mfu=self.mfu,
        )
        return d

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)


def from_counted(counted, *, arch: str, shape: str, mesh_name: str,
                 chips: int, model_shards: int, model_flops: float,
                 collectives: dict, collectives_bwd: Optional[dict] = None,
                 memory_stats: Optional[dict] = None) -> Roofline:
    """The roofline from ``counted`` (a finished ``op_cost.Counter``, or its
    ``as_dict()``) of one data shard's step, split evenly over the
    ``model_shards`` devices of the model axis, and the per-device
    ``collectives`` (``op_cost.collective_bytes``) plus, for a train cell,
    ``collectives_bwd`` (``op_cost.collective_bytes_bwd``: the recompute,
    the backward and the smaller sites), listed apart in the breakdown
    under ``"bwd and recompute"``, keyed ``"<kind> <fwd|bwd>"``."""
    c = counted if isinstance(counted, dict) else counted.as_dict()
    rest = {f"{k} {d}": v for (k, d), v in (collectives_bwd or {}).items()}
    breakdown = dict(collectives)
    if rest:
        breakdown["bwd and recompute"] = rest
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=c["flops"] / model_shards,
        hlo_bytes_per_chip=c["bytes"] / model_shards,
        collective_bytes_per_chip=float(sum(collectives.values())
                                        + sum(rest.values())),
        collective_breakdown=breakdown,
        model_flops=model_flops,
        bytes_per_chip_peak=(memory_stats or {}).get("temp_bytes"),
        fusible_bytes_per_chip=c["fusible_bytes"] / model_shards,
    )


# --------------------------- model FLOPs (6ND) --------------------------------


def count_params(tree, *, active_moe_fraction: Optional[float] = None) -> float:
    """Total (or active) param count of a param tree (meta tensors do).

    Leaves under a ``moe`` subtree with a leading expert axis are scaled
    by ``active_moe_fraction`` (= experts_per_token / num_experts) when
    given. Packed leaves (w_packed) count as size*32 latent params.
    """
    from repro_torch import tree as tree_mod

    total = 0.0
    for path, leaf in tree_mod.leaves_with_path(tree):
        keys = [str(k) for k in path]
        size = float(math.prod(tuple(getattr(leaf, "shape", ())) or (1,)))
        if keys and keys[-1] == "w_packed":
            size *= 32
        if "moe" in keys and keys[-1] in ("w", "w_packed") \
                and "router" not in keys:
            if active_moe_fraction is not None:
                size *= active_moe_fraction
        total += size
    return total


def model_flops_for(cfg, shape_cfg, n_params_total: float,
                    n_params_active: float) -> float:
    """6*N*D train / 2*N per generated token decode (per step)."""
    n = n_params_active
    tokens = shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "train":
        return 6.0 * n * tokens
    if shape_cfg.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape_cfg.global_batch


__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "count_params",
           "from_counted", "model_flops_for"]
