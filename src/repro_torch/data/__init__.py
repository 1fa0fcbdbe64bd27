"""The port's data pipeline (the torch twin of ``repro.data``): host numpy,
handed to the card by ``launch.train``."""

from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
