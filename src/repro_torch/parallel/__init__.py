"""The distribution layer of the port (serving half).

``sharding`` holds the logical-axis specs of ``repro/parallel/sharding.py``
that the serving tier uses (framework-free arithmetic, equal to the
reference's ``PartitionSpec``s) and ``PairShard``, the runtime form of the
serving rule "the pair tensor is split on j over ``model``".
``collectives`` holds the explicit collectives that GSPMD inserts
implicitly in the reference, counted by name and bytes.
"""
from repro_torch.parallel.sharding import (DATA, MODEL, P, PairShard, act_rules,
                                           constrain, current_shard, data_axes,
                                           ppm_constraints, ppm_input_shardings,
                                           ppm_serving_rules, rule_value)

__all__ = ["DATA", "MODEL", "P", "PairShard", "act_rules", "constrain",
           "current_shard", "data_axes", "ppm_constraints",
           "ppm_input_shardings", "ppm_serving_rules", "rule_value"]
