"""The paper's primary contribution on PyTorch: distributed multi-way joins.

Public API of this slice, by layer:

  Data model / grid
    Relation, concat, flatten_leading   — static-capacity columnar relation
    Grid, SimGrid                       — the simulated reducer grid
    ShardGrid                           — the grid of torch.distributed ranks
    broadcast_along, shuffle_by_bucket  — the shuffle layer
    split_rows, concat_rows             — the overlapped schedule's row blocks

  Logical plan IR
    JoinQuery, QueryAggregate, ChainQuery, ChainAggregate

  Physical executor
    execute_chain / execute_query, mapside_cascade_chain,
    jit_execute_chain /
    jit_execute_query (the whole plan as one cached executable, a CUDA
    graph on the GPU), clear_compiled_caches,
    one_round_chain / one_round_query,
    cascade_chain / cascade_query, shares_skew_chain, two_way_join,
    distributed_groupby_sum, project_product,
    one_round_three_way, cascade_three_way[_agg], one_round_three_way_agg
    (the paper's three-way entry points),
    chain_edge_inputs / query_table_inputs / scatter_to_grid,
    ChainCaps, default_chain_caps / default_query_caps /
    default_mapside_caps

  Data plane
    sort_merge_join, fused_sort_merge_join, groupby_sum, local_join,
    sort_rows, partition; oracles local_join_allpairs,
    groupby_sum_multipass

  Statistics, cost model, planner (copies of the JAX package's)
    QueryStats / query_stats_exact, ChainStats, JoinStats,
    chain_stats_exact, cost_* formulas, optimal_shares_query /
    integer_shares_query, optimal_shares_chain / integer_shares,
    crossover_reducers[_chain], skew_crossover_scale, plan_query,
    plan_chain, plan_three_way

  Partitioned store (map-side joins)
    PartitionSpec, PartitionedRelation, partition_relation,
    repartition, verify_partition_layout, co_partitioned,
    chain_partitioning, default_part_capacity; cost_chain_mapside,
    chain_mapside_modes, chain_mapside_placed, chain_mapside_shuffles

  Skew layer
    heavy_hitters, chain_key_sketch, detect_chain_skew,
    SkewSplitPlan, SkewCombo, balance_threshold

  Workloads
    spmm / a_cubed — join-based matmul and graph analytics
    triangle_count_cycle — the triangle as a cyclic query (primary path)
    triangle_count_chain_filter / triangle_count_from_a3 /
    oracle_triangles — its oracles; edge_relation, oracle_a3
"""

from .relation import Relation, concat, flatten_leading
from .shuffle import (Grid, ShardGrid, SimGrid, broadcast_along,
                      concat_rows, shuffle_by_bucket, split_rows)
from .plan import ChainAggregate, ChainQuery, JoinQuery, QueryAggregate
from .two_way import two_way_join
from .executor import (ChainCaps, CompiledPlan, cascade_chain, cascade_query,
                       chain_edge_inputs, clear_compiled_caches,
                       default_chain_caps, default_mapside_caps,
                       default_query_caps, execute_chain, execute_query,
                       jit_execute_chain, jit_execute_query,
                       mapside_cascade_chain, one_round_chain,
                       one_round_query, query_table_inputs, scatter_to_grid,
                       shares_skew_chain)
from .local import (fused_sort_merge_join, groupby_sum, groupby_sum_multipass,
                    local_join, local_join_allpairs, partition,
                    sort_merge_join, sort_rows)
from .one_round import one_round_three_way
from .cascade import (cascade_three_way, cascade_three_way_agg,
                      one_round_three_way_agg)
from .aggregation import distributed_groupby_sum, project_product
from .cost_model import (ChainPartitioning, ChainStats, JoinStats, QueryStats,
                         balance_threshold, chain_mapside_modes,
                         chain_mapside_placed, chain_mapside_shuffles,
                         chain_replications, cost_cascade, cost_cascade_agg,
                         cost_chain_cascade, cost_chain_cascade_pushdown,
                         cost_chain_mapside, cost_chain_one_round,
                         cost_chain_one_round_agg, cost_chain_shares_skew,
                         cost_one_round, cost_one_round_agg,
                         cost_query_cascade, cost_query_one_round,
                         cost_two_way, crossover_reducers,
                         estimate_join_size, hop_excess, hop_peak_load,
                         integer_shares, integer_shares_query,
                         optimal_k1_k2, optimal_shares_chain,
                         optimal_shares_query, query_replications,
                         replication_lower_bound_chain,
                         replication_lower_bound_query, skew_clamped_shape)
from .partition import (PartitionedRelation, PartitionSpec,
                        chain_partitioning, co_partitioned,
                        default_part_capacity, partition_relation,
                        repartition, verify_partition_layout)
from .planner import (ChainPlan, Plan, QueryPlan, chain_stats_exact,
                      chain_stats_from_three_way, crossover_reducers_chain,
                      plan_chain, plan_query, plan_three_way,
                      query_stats_exact, self_join_stats,
                      self_join_stats_exact, skew_crossover_scale)
from .skew import (SkewCombo, SkewSplitPlan, chain_key_sketch,
                   detect_chain_skew, heavy_hitters)
from .matmul import (a_cubed, edge_relation, oracle_a3, oracle_triangles,
                     spmm, triangle_count_chain_filter, triangle_count_cycle,
                     triangle_count_from_a3)

__all__ = [
    "Relation", "concat", "flatten_leading",
    "Grid", "ShardGrid", "SimGrid", "broadcast_along", "shuffle_by_bucket",
    "split_rows", "concat_rows",
    "JoinQuery", "QueryAggregate", "ChainQuery", "ChainAggregate",
    "ChainCaps", "CompiledPlan", "execute_chain", "execute_query",
    "jit_execute_chain", "jit_execute_query", "clear_compiled_caches",
    "mapside_cascade_chain",
    "one_round_chain",
    "one_round_query", "cascade_chain", "cascade_query", "shares_skew_chain",
    "two_way_join", "one_round_three_way",
    "cascade_three_way", "cascade_three_way_agg", "one_round_three_way_agg",
    "distributed_groupby_sum", "project_product",
    "chain_edge_inputs", "query_table_inputs", "scatter_to_grid",
    "default_chain_caps", "default_query_caps", "default_mapside_caps",
    "sort_merge_join", "fused_sort_merge_join", "groupby_sum",
    "groupby_sum_multipass", "local_join", "local_join_allpairs",
    "sort_rows", "partition",
    "ChainPartitioning", "ChainStats", "JoinStats", "QueryStats",
    "balance_threshold",
    "chain_mapside_modes", "chain_mapside_placed", "chain_mapside_shuffles",
    "chain_replications", "cost_chain_cascade", "cost_chain_cascade_pushdown",
    "cost_chain_mapside",
    "cost_chain_one_round", "cost_chain_one_round_agg",
    "cost_chain_shares_skew", "cost_query_cascade", "integer_shares",
    "skew_clamped_shape",
    "cost_two_way", "cost_one_round", "cost_cascade", "cost_cascade_agg",
    "cost_one_round_agg", "cost_query_one_round", "query_replications",
    "replication_lower_bound_chain", "replication_lower_bound_query",
    "optimal_shares_query", "integer_shares_query", "hop_peak_load",
    "hop_excess", "optimal_shares_chain", "crossover_reducers",
    "estimate_join_size", "optimal_k1_k2",
    "PartitionSpec", "PartitionedRelation", "partition_relation",
    "repartition", "verify_partition_layout", "co_partitioned",
    "chain_partitioning", "default_part_capacity",
    "ChainPlan", "Plan", "QueryPlan", "chain_stats_exact",
    "crossover_reducers_chain", "plan_chain", "plan_query", "plan_three_way",
    "query_stats_exact", "self_join_stats", "self_join_stats_exact",
    "chain_stats_from_three_way", "skew_crossover_scale",
    "SkewCombo", "SkewSplitPlan", "chain_key_sketch", "detect_chain_skew",
    "heavy_hitters",
    "spmm", "a_cubed", "edge_relation", "triangle_count_from_a3",
    "triangle_count_cycle", "triangle_count_chain_filter",
    "oracle_a3", "oracle_triangles",
]
