"""Distribution substrate: sharding specs and placements, the activation
context, the local (per-rank) view of sharded trees with the collectives
between ranks, and pipeline parallelism over a 'stage' axis."""

from .sharding import (BATCH_AXES, FSDP, TP, P, batch_specs,
                       cache_shardings, named, param_shardings, prune_specs,
                       tp_size, zero1_specs)

__all__ = ["BATCH_AXES", "FSDP", "P", "TP", "batch_specs", "cache_shardings",
           "named", "param_shardings", "prune_specs", "tp_size",
           "zero1_specs"]
