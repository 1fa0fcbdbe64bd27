from .csr import (
    GraphDev,
    GraphNP,
    arc_bucket,
    from_edges,
    from_reference,
    pow2,
    to_device_csr,
)
from .generators import barabasi_albert, mesh2d, planted_partition, ring, rmat, star
from .packing import (
    ChunkPack,
    EllPack,
    chunk_geometry,
    ell_pack,
    gather_ell_device,
    gather_pack_device,
    layout_nodes,
    pack_chunks,
    pad_pack,
    plan_chunks,
    plan_ell_rows,
)

__all__ = [
    "GraphDev", "GraphNP", "arc_bucket", "from_edges", "from_reference",
    "pow2", "to_device_csr",
    "barabasi_albert", "mesh2d", "planted_partition", "ring", "rmat", "star",
    "ChunkPack", "EllPack", "chunk_geometry", "ell_pack", "gather_ell_device",
    "gather_pack_device", "layout_nodes", "pack_chunks", "pad_pack",
    "plan_chunks", "plan_ell_rows",
]
