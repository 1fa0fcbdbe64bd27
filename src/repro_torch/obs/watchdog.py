"""Shape-bucket watchdog: the "one launch geometry per bucket" rule as a
runtime guard.

The reference (``repro.obs.watchdog``) guards XLA compilations: every
bucketed jit cache notes a new shape key the moment it will compile.
Eager torch compiles nothing per shape, so the port guards the two things
a new key still costs on the card:

* **Bucket notes.**  Every bucketed cache of the port (sweep, dense
  round, gathers, contraction, GA, repair, audit, store merge/view/vacuum,
  group lanes, shard extraction) calls ``watchdog().note(family, key)``
  when it sees a shape key for the first time.  A new key means a new set
  of buffer shapes for the caching allocator and a new launch geometry.
  The keys are the reference's, so the per-family bucket counts of the
  two packages agree on the same run.
* **Kernel builds.**  ``kernels/build.py::build`` notes family
  ``"kernel.build"`` keyed by ``(source stem, digest)``, with the measured
  ``nvcc`` wall time in ``wall_ms`` (0 for a cache hit).  This takes the
  place of the reference's ``jax.monitoring`` compile-duration listener.

Modes, as in the reference:

* **strict** (``set_strict(True)`` or env ``REPRO_OBS_STRICT=1``) raises
  :class:`WatchdogError` on a note for a family outside
  :data:`KERNEL_FAMILIES`;
* ``seal()`` freezes the bucket sets: any later note with a new key raises
  (the production guard: a serving loop that opens a new bucket after
  warm-up).  ``unseal()`` lifts it around a planned rebuild.

``KNOWN_JIT_SITES`` is the manifest the AST static check
(:mod:`repro_torch.obs.static_check`) walks against.  It lists the port's
device-program sites: every kernel load or launch site (the callers of
``kernels/build.py::load``), the counterparts of the reference's jit
functions (plain torch-op functions here, listed by name) and any
``torch.compile`` or CUDA-graph capture.  The port has no
``torch.compile`` and no CUDA-graph capture today; the check fails if one
lands without an entry.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "CompileRecord", "CompileWatchdog", "WatchdogError", "watchdog",
    "note_new", "KERNEL_FAMILIES", "KNOWN_JIT_SITES",
]


class WatchdogError(RuntimeError):
    """An undeclared family (strict) or a new bucket after ``seal()``."""


# Every family the instrumented sites note, declared up front so strict
# mode can run from process start.
KERNEL_FAMILIES: Tuple[str, ...] = (
    "engine.sweep",          # lp_sweep (bucket, statics) combinations
    "engine.dense",          # dense_round_device shape buckets
    "engine.gather",         # gather_pack_device / gather_ell_device
    "engine.contract",       # contract_device (Nb, Mb, wbits)
    "engine.evo",            # evo_seed_step / generation steps
    "engine.repair",         # repair expand/gather/sweep/gain/balance
    "engine.audit",          # resilience audit programs (incl. shard chk)
    "store.compact",         # merge_overlay_device buckets
    "store.view",            # overlay_view_device buckets
    "store.vacuum",          # vacuum_device buckets
    "group.repair",          # the batched group lane programs
    "deploy.extract",        # _shard_masks / _shard_extract buckets
    "kernel.build",          # nvcc builds of the hand-written kernels
)


# Static-check manifest: "<path relative to src/repro_torch>::<site>" ->
# watchdog family, or "exempt:<reason>".
KNOWN_JIT_SITES: Dict[str, str] = {
    # kernel load/launch sites (callers of kernels/build.py::load)
    "kernels/lp_score/lp_score.py::_lib": "kernel.build",
    "kernels/balance/walk.py::_lib": "kernel.build",
    "kernels/lp_step/chunk_step.py::_lib": "kernel.build",
    # counterparts of the reference's jit functions
    "core/label_propagation.py::lp_sweep": "engine.sweep",
    "core/contraction.py::contract_device": "engine.contract",
    "core/evo_device.py::evo_seed_step": "engine.evo",
    "core/evo_device.py::evo_generation_step_sharded": "engine.evo",
    "graph/packing.py::gather_pack_device": "engine.gather",
    "graph/packing.py::gather_ell_device": "engine.gather",
    "kernels/lp_score/lp_score.py::lp_score_rows": "engine.sweep",
    "kernels/lp_score/ops.py::node_scores": "engine.sweep",
    "kernels/lp_score/ops.py::dense_round_device": "engine.dense",
    "kernels/lp_score/ops.py::dense_round_device_batched": "engine.evo",
    "dynamic/repair.py::expand_region_device": "engine.repair",
    "dynamic/repair.py::gain_round_device": "engine.repair",
    "dynamic/repair.py::balance_rounds_device": "engine.repair",
    "dynamic/store.py::merge_overlay_device": "store.compact",
    "dynamic/store.py::overlay_view_device": "store.view",
    "dynamic/store.py::vacuum_device": "store.vacuum",
    # a session's repair and a SessionGroup bucket's: its caller's note
    # names the family (engine.repair, or group.repair for a group)
    "dynamic/repair.py::repair_lanes": "engine.repair",
    "deploy/extract.py::_shard_masks": "deploy.extract",
    "deploy/extract.py::_shard_extract": "deploy.extract",
    "resilience/audit.py::_csr_audit": "engine.audit",
    "resilience/audit.py::_labels_audit": "engine.audit",
    "resilience/audit.py::_shard_owned_chk": "engine.audit",
    "resilience/audit.py::_ghost_owner_audit": "engine.audit",
    # distributed path: keyed by the plan cache, not by shape buckets
    "core/distributed_lp.py::shard_phase": "exempt:plan-cache keyed, one "
    "launch sequence per ShardPlan (see build_plan's plan cache)",
    "core/distributed_lp.py::exchange": "exempt:plan-cache keyed",
    "core/distributed_lp.py::_shard_quotient": "exempt:plan-cache keyed",
    # a call named ``load`` that loads no kernel
    "launch/summarize.py::main": "exempt:summarize.load reads dry-run records",
}


@dataclass
class CompileRecord:
    kernel: str
    key: object
    seq: int
    t_mono: float
    wall_ms: float = 0.0


@dataclass
class CompileWatchdog:
    strict: bool = False
    sealed: bool = False
    records: List[CompileRecord] = field(default_factory=list)
    #: kept for the reference's snapshot layout; the port attributes every
    #: build it times, so this stays 0
    unattributed_compiles: int = 0
    _declared: Dict[str, Set] = field(default_factory=dict)

    def __post_init__(self):
        for fam in KERNEL_FAMILIES:
            self._declared[fam] = set()

    # ----------------------------------------------------------------- api

    def set_strict(self, flag: bool = True) -> None:
        self.strict = bool(flag)

    def seal(self) -> None:
        """Freeze the bucket sets: any later new-bucket note raises."""
        self.sealed = True

    def unseal(self) -> None:
        self.sealed = False

    def note(self, kernel: str, key, wall_ms: float = 0.0) -> bool:
        """Record a shape key; returns True iff the key is new.  Called by
        the bucketed sites only when their own set missed, so warm paths
        pay nothing here.  ``wall_ms`` is the measured cost of the new key
        (an nvcc build's wall time)."""
        buckets = self._declared.get(kernel)
        if buckets is None:
            if self.strict:
                raise WatchdogError(
                    f"compile noted for undeclared kernel family {kernel!r} "
                    f"(key={key!r}); declare it in "
                    f"repro_torch.obs.watchdog.KERNEL_FAMILIES"
                )
            buckets = self._declared[kernel] = set()
        if key in buckets:
            return False
        if self.sealed:
            raise WatchdogError(
                f"recompile outside the sealed bucket set: kernel "
                f"{kernel!r}, new key {key!r} (declared "
                f"{len(buckets)} buckets)"
            )
        buckets.add(key)
        self.records.append(CompileRecord(
            kernel=kernel, key=key, seq=len(self.records),
            t_mono=time.monotonic(), wall_ms=float(wall_ms),
        ))
        return True

    # ----------------------------------------------------------- reporting

    def compile_count(self, kernel: Optional[str] = None) -> int:
        if kernel is None:
            return len(self.records)
        return sum(1 for r in self.records if r.kernel == kernel)

    def bucket_count(self, kernel: Optional[str] = None) -> int:
        if kernel is None:
            return sum(len(s) for s in self._declared.values())
        return len(self._declared.get(kernel, ()))

    def snapshot(self) -> dict:
        per = {
            fam: dict(buckets=len(keys),
                      compiles=self.compile_count(fam),
                      wall_ms=sum(r.wall_ms for r in self.records
                                  if r.kernel == fam))
            for fam, keys in sorted(self._declared.items())
        }
        return dict(
            strict=self.strict, sealed=self.sealed,
            total_compiles=len(self.records),
            unattributed_compiles=self.unattributed_compiles,
            kernels=per,
        )

    def reset(self) -> None:
        self.records.clear()
        self.unattributed_compiles = 0
        for s in self._declared.values():
            s.clear()


_watchdog: Optional[CompileWatchdog] = None


def watchdog() -> CompileWatchdog:
    """The process-global watchdog (kernel builds are process-global too)."""
    global _watchdog
    if _watchdog is None:
        _watchdog = CompileWatchdog(
            strict=os.environ.get("REPRO_OBS_STRICT", "") not in ("", "0")
        )
    return _watchdog


def note_new(buckets: set, kernel: str, key) -> None:
    """A bucketed site's hook: add ``key`` to the site's own ``buckets``
    and note the watchdog when the key is new there, so warm calls pay one
    set lookup."""
    if key not in buckets:
        buckets.add(key)
        watchdog().note(kernel, key)
