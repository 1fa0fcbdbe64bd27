from .autoshard import crossgroup_traffic, expert_placement, pipeline_stages
from .baselines import BaselineReport, hash_partition, matching_multilevel, random_balanced
from .contraction import CoarseMap, contract, contract_device, project_labels, relabel
from .engine import EngineStats, LPEngine
from .evolutionary import EvoConfig, EvoInputs, evolve, evolve_batched_numpy
from .fm import fm_refine, gain_round_np
from .initial_partition import best_of, greedy_growing, initial_partition, repair_balance
from .label_propagation import LPResult, lp_cluster, lp_refine, lp_sweep, sclap_numpy
from .metrics import (
    block_weights_np,
    comm_volume_np,
    cut_from_arcs,
    cut_np,
    imbalance_np,
    is_feasible,
    lmax,
    quotient_graph_np,
)
from .modularity import louvain, modularity, modularity_lp
from .multilevel import PartitionerConfig, PartitionReport, partition

__all__ = [
    "crossgroup_traffic", "expert_placement", "pipeline_stages",
    "BaselineReport", "hash_partition", "matching_multilevel", "random_balanced",
    "CoarseMap", "contract", "contract_device", "project_labels", "relabel",
    "EngineStats", "LPEngine",
    "EvoConfig", "EvoInputs", "evolve", "evolve_batched_numpy",
    "fm_refine", "gain_round_np",
    "best_of", "greedy_growing", "initial_partition", "repair_balance",
    "LPResult", "lp_cluster", "lp_refine", "lp_sweep", "sclap_numpy",
    "block_weights_np", "comm_volume_np", "cut_from_arcs", "cut_np",
    "imbalance_np", "is_feasible", "lmax", "quotient_graph_np",
    "louvain", "modularity", "modularity_lp",
    "PartitionerConfig", "PartitionReport", "partition",
]
