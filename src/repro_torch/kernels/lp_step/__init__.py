from .chunk_step import ChunkStep, block_nodes, check_inputs, light_arcs

__all__ = ["ChunkStep", "block_nodes", "check_inputs", "light_arcs"]
