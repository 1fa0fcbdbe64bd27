from .contraction import CoarseMap, contract, contract_device, project_labels, relabel
from .engine import EngineStats, LPEngine
from .evolutionary import EvoConfig, evolve
from .fm import fm_refine
from .initial_partition import greedy_growing, repair_balance
from .label_propagation import LPResult, lp_cluster, lp_refine, lp_sweep, sclap_numpy
from .metrics import block_weights_np, cut_from_arcs, cut_np, imbalance_np, lmax
from .multilevel import PartitionerConfig, PartitionReport, partition

__all__ = [
    "CoarseMap", "contract", "contract_device", "project_labels", "relabel",
    "EngineStats", "LPEngine",
    "EvoConfig", "evolve",
    "fm_refine",
    "greedy_growing", "repair_balance",
    "LPResult", "lp_cluster", "lp_refine", "lp_sweep", "sclap_numpy",
    "block_weights_np", "cut_from_arcs", "cut_np", "imbalance_np", "lmax",
    "PartitionerConfig", "PartitionReport", "partition",
]
