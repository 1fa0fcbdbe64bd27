from .csr import (
    GraphDev,
    GraphNP,
    arc_bucket,
    from_edges,
    from_reference,
    pow2,
    to_device_csr,
    validate,
)
from .generators import barabasi_albert, mesh2d, planted_partition, rgg, ring, rmat, star
from .packing import (
    ChunkPack,
    EllPack,
    ShardedGraph,
    chunk_geometry,
    ell_pack,
    gather_ell_device,
    gather_pack_device,
    layout_nodes,
    pack_chunks,
    pad_pack,
    plan_chunks,
    plan_ell_rows,
    plan_region_pack,
    shard_graph,
)

__all__ = [
    "GraphDev", "GraphNP", "arc_bucket", "from_edges", "from_reference",
    "pow2", "to_device_csr", "validate",
    "barabasi_albert", "mesh2d", "planted_partition", "rgg", "ring", "rmat", "star",
    "ChunkPack", "EllPack", "chunk_geometry", "ell_pack", "gather_ell_device",
    "gather_pack_device", "layout_nodes", "pack_chunks", "pad_pack",
    "plan_chunks", "plan_ell_rows", "plan_region_pack",
    "ShardedGraph", "shard_graph",
]
