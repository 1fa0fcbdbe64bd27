"""Architecture and shape configurations of the LM scaffolding: a
field-for-field copy of the reference's ``configs`` (the port imports
nothing of the reference, so it keeps its own copy)."""

from .base import SHAPES, ArchConfig, MoESpec, Shape, SSMSpec
from .registry import ARCHS, cells, get_config

__all__ = ["ArchConfig", "MoESpec", "SSMSpec", "Shape", "SHAPES", "ARCHS",
           "get_config", "cells"]
