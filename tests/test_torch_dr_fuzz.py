"""Port parity for the end-to-end disaster-recovery fuzzer:
repro_torch.resilience.run_fuzz on the CPU against repro.resilience.run_fuzz
with the same config.  Both campaigns inject the same faults in the same
order and land the same outcome counters; only the wall-clock seconds
differ.  The twins of tests/test_dr_fuzz.py's default cases."""

import pytest
import torch

from repro.resilience import FuzzConfig as RefFuzzConfig
from repro.resilience import run_fuzz as ref_run_fuzz

from repro_torch.resilience import FuzzConfig, run_fuzz

torch.set_num_threads(1)

_EPISODE_FIELDS = ("seed", "commits", "quarantined", "faults", "heals",
                   "heal_failures", "restores", "replayed", "failovers",
                   "strict_digest_checks", "violations")


@pytest.mark.parametrize("kw", [
    # tests/test_dr_fuzz.py::test_fuzz_smoke
    dict(n=300, k=3, episodes=2, batches_per_episode=5, batch_size=16,
         seed=7, checkpoint_every=3, replicas=2, audit_cadence=2),
    # tests/test_dr_fuzz.py::test_fuzz_smoke_is_seeded
    dict(n=300, k=3, episodes=1, batches_per_episode=4, batch_size=16,
         seed=11, checkpoint_every=3, replicas=2, audit_cadence=2),
], ids=["smoke", "seeded"])
def test_fuzz_matches_reference(tmp_path, kw):
    port = run_fuzz(FuzzConfig(directory=str(tmp_path / "port"), **kw),
                    device="cpu")
    ref = ref_run_fuzz(RefFuzzConfig(directory=str(tmp_path / "ref"), **kw))
    assert port.ok, port.summary()
    a, b = port.summary(), ref.summary()
    a.pop("seconds")
    b.pop("seconds")
    assert a == b
    assert a["commits"] > 0 and a["strict_digest_checks"] > 0
    assert len(port.episodes) == kw["episodes"]
    for ep, rep in zip(port.episodes, ref.episodes):
        for f in _EPISODE_FIELDS:
            assert getattr(ep, f) == getattr(rep, f), f
