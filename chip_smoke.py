#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which fails the run:

1. print the card's name and power limit and build every hand-written
   kernel of the port from the sources in this checkout;
2. hold each kernel against its plain PyTorch version on the card (exact on
   integral weights at the dense path's finest shape, ``rtol=1e-5`` on
   float weights at small ragged shapes) and time both with CUDA events;
   The batched dense round must equal its one-row rounds on the card;
3. check on a small graph that ``partition()`` on the card returns the same
   labels as the port's CPU path (plain versions instead of kernels), once
   with the host GA and once with the default ``evo_engine`` (the batched
   GA);
4. drive ``partition()`` end to end on ``rmat(19, 16)`` without its
   isolated nodes, at k=16, with dense refinement: first with the default
   ``evo_engine``, whose coarsest stage must run the batched GA on the card
   in both V-cycles, then with the host GA.  Each run counts the kernels'
   launches from zero and must be feasible and beat a hash partition; the
   finish must run on the card (``repair_balance_walk`` launched once per
   device finish whose labels have a block above L), and every chunk step
   of the sweeps must be the ``lp_chunk_step`` kernel (three launches for
   each ``lp.step`` span).
   Then the GA's generation step, which the fast preset skips: card == CPU
   on rmat(14, 16), and two generations on the full graph seeded with the
   run's partition, which must come out no worse than its seed;
5. time each kernel and its plain version on the main path's own input
   (the finest level's ELL pack with the run's labels; the walk inputs of
   each of phase 4's finishes, rebuilt by the prelude from the arguments it
   got, where the kernel must equal its plain version and the host's
   ``repair_balance`` label for label), and work out the walk's bound from
   the latencies of its dependent chain, measured on the card; the first
   sweep of each kind phase 4 made (cluster, cluster under a restriction,
   the GA's refine rows) through the chunk-step kernel and its plain
   version on the CPU, bit for bit, and one step at the finest level's
   largest chunk timed against its bytes bound and the plain version;
6. the dynamic serving subsystem (``repro_torch.dynamic``): (a) a small
   mixed stream (edge churn, node adds, node removals) under the default
   and the throughput session config, and a three-tenant ``SessionGroup``,
   card == CPU after every batch; (b) a session on the phase-4 graph at
   k=16 under the reference benchmark's churn model at 0.1 %: every step
   feasible, the store's CSR equal to a numpy rebuild of the edge multiset,
   one full-width repair card == CPU, then one forced escalation with its
   ``lp_score_rows`` launches; (c) the throughput config on the reference
   benchmark's ba-16384 at 1 % and 0.1 % churn; (d) the reference
   benchmark's four-tenant group against the same sessions solo (labels
   equal after every step);
7. the deployment and fault-tolerance stack (``repro_torch.deploy``,
   ``repro_torch.resilience``): (a) the full DR stack (replicated shards,
   transactions, WAL and checkpoints) on ba-1024 over a mangled stream
   with each fault class injected once, card == CPU after every submit,
   heal() and restore; (b) the same stack around 6b's session at full
   width: shard parity with the numpy oracle, reassembly, ghost exchange,
   comm metrics, commit latencies and their split, one audit pass, one
   checkpoint, the device programs' times, failover, heal, one forced
   escalation (``lp_score_rows`` launches) and a restore whose digest
   equals the live one; (c) the reference benchmark's ``deploy_hot`` and
   (d) its ``resilience_dr``;
8. the distributed path (``engine="dist"``) and the island-sharded GA:
   (a) the distributed sweeps, contraction and ``partition(engine="dist",
   dist_shards=8)`` on ba-8192 with all PEs on the card equal the CPU, and
   the GA sharded over ``[cuda:0] * 2`` equals the unsharded GA; (b) that
   ``partition()`` on the phase-4 graph at k=16, 8 PEs on the card:
   feasible, below the hash cut, with its shards' sizes, the times of its
   host planning, sweeps, per-PE programs, exchange and contraction (equal
   to the host's), the sharded GA's generation step at full width (equal
   to the unsharded one) and the peak device memory;
9. memory accounting, the shape-bucket watchdog, capacity planning and SLO
   export (``repro_torch.obs``): (a) phase 4's ``partition()`` with
   accounting on, the tracer on and the watchdog strict: the same labels,
   one ``lp_score_rows`` launch per dense round, the accountant's peak at
   or below ``max_memory_allocated`` and every family within the closed
   form's tolerance, the trace with its counter events; (b) a session on
   the phase-4 graph under 6b's churn, the watchdog sealed after 2 warm
   batches and 4 batches that open no new bucket; (c) ``will_fit`` on the
   card's budget, a 1 GiB budget and rmat(27, 16)'s size; (d)
   ``write_slo`` of (b)'s session.
10. the paper's quality comparison (``repro_torch.core.baselines``): (a)
   on the reference benchmark's five Table II graphs at k=2, our
   ``partition()`` on the card equals the CPU's labels, is feasible and
   cuts below ``hash_partition``, beside ``matching_multilevel`` (the
   ParMetis stand-in) and each one's first-contraction shrink; (b)
   ``matching_multilevel`` at k=16 on ``rmat(17, 16)`` without isolated
   nodes (``--matching-scale``; 19 is the phase-4 graph) beside our
   ``partition()`` in phase 4's configuration, with its ``lp_score_rows``
   launches, and the hash partition; (c) the chunked ``lp_refine`` the
   baseline runs at levels of 200,000 nodes or more, on mesh2d(512): card
   == CPU;
   (d) four example twins (``examples/torch``) exit 0 on the card.  The
   matching runs are host numpy, in worker processes beside the card work;
11. LM serving (``repro_torch.models``, ``repro_torch.launch.serve``): (a)
   every architecture at smoke width in float32, the same weights on the
   card and the CPU: prefill's logits and caches, four greedy decode steps
   (tokens equal) and ``loss_fn``; (b) qwen2.5-3b at full width in bf16
   through ``launch.serve.main`` (batch 8, prompt 512, 64 tokens), then the
   same seed's model for the numbers (prefill and decode times, tok/s,
   weight bytes, peak memory, the decode step's HBM bound), the first decode
   step against forward over S + 1 tokens in bf16 and in float32, end to end
   and layer by layer, one decode step under ``torch.profiler`` and the
   decode attention beside ``scaled_dot_product_attention``; (c) the same
   for granite-moe-1b-a400m and mamba2-2.7b (batch 4, prompt 256, 32
   tokens) without the profiler; (d) the ``serve_lm`` twin on the card;
12. LM training (``repro_torch.optim``, ``repro_torch.data``,
   ``repro_torch.launch.steps``, ``repro_torch.launch.train``): (a) every
   architecture at smoke width in float32, the same weights and batches on
   the card and the CPU: ``loss_fn``'s loss and every gradient leaf, three
   train steps with int8 compression off and on; mamba2 and jamba at the
   full-width SSD chunk (256), every gradient finite; (b) qwen2.5-3b at full
   width in bf16 with a float32 master through ``launch.train.main`` (batch
   4 x 512, 6 steps, every loss and gnorm finite), then the same seed's
   state for the numbers (step time, tokens/s, peak memory, the step's
   bound), one step under ``torch.profiler`` and ``adamw_update`` beside
   ``torch.optim.AdamW(fused=True)``; (c) granite-moe-1b-a400m and
   mamba2-2.7b at full width, 4 steps; one full-width layer of each of the
   three in float32, its gradients card == CPU; (d) resume at step 6 of 12
   on the card equal to the uninterrupted run, and the ``train_lm`` twin
   (beside 12a);
13. the mesh and expert parallelism (``repro_torch.models.moe.moe_ep``,
   ``repro_torch.models.sharding``, ``repro_torch.ckpt.elastic``), every
   mesh coordinate on the one card: (a) ``moe_ep`` at smoke width in
   float32 on a 2x4 mesh, card == CPU with the same drop sets at capacity
   1.25 and 0.5 and == ``moe_dense`` at 8.0, and granite, dbrx and jamba
   at a 2x2 mesh, the loss and gradients card == CPU; (b)
   granite-moe-1b-a400m at full width through ``launch.train.main --mesh
   2x2`` (2 steps), then 4 timed steps at 1x4, 2x2 and 1x1 (the dense MoE)
   with each MoE layer's dropped share, one ``moe_ep`` call against its
   bound and ``moe_dense``, and prefill and decode at 1x4; (c) the 2x2
   run's train state saved and ``reshard_restore``d onto 1x4 and 4x1, every
   shard bit for bit;
14. the dry-run tooling (``repro_torch.launch.hlo_analysis``,
   ``roofline``, ``dryrun_paper``): 12b's and 13b's cells counted on the
   ``meta`` device, the counted state bytes equal to the card's state
   storage and the counted peak of live bytes within 15 % of
   ``max_memory_allocated``, the roofline terms beside the measured step;
   one PE's refinement phase of the paper's sweep at uk-2007 shard shapes
   on the card against its bound and its counted bytes.
Phases 7b and 8b print each device program's bound (inputs read once,
results written once) beside the counter's unfused per-op bytes.
Then one JSON line with each kernel's numbers and, last, the device line.

Run from the repository root:  python3 chip_smoke.py
(``--scale``/``--edge-factor`` shrink the end-to-end graph for quick runs).
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.  The span traces of phase 4 go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor-core float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _time_ms(fn, torch, warmup: int = 3, batches: int = 5, reps: int = 10) -> float:
    """Milliseconds per ``fn()`` call on the card: CUDA events around
    ``reps`` back-to-back calls (so the host's launch work overlaps the
    device's), the median over ``batches`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def _io_bound(fn, inputs) -> dict:
    """One call of ``fn``: its bound, the bytes of ``inputs`` (what it
    reads) read once and of its results written once at HBM bandwidth, and
    the counter's unfused per-op bytes of the same call
    (``launch.hlo_analysis.count_step``), a ceiling beside the bound."""
    from repro_torch.launch.hlo_analysis import count_step, tensor_bytes

    nbytes = tensor_bytes(inputs) + tensor_bytes(fn())
    counted = count_step(fn).hbm_bytes
    return dict(io_bytes=nbytes, bound_ms=round(nbytes / PEAK_BYTES_PER_S * 1e3, 5),
                counted_bytes=int(counted),
                counted_ms=round(counted / PEAK_BYTES_PER_S * 1e3, 5))


def _phase_inputs(st, c: int, ll, lg, table=None) -> list:
    """What one ``shard_phase`` over chunk ``c`` reads: the chunk's rows,
    the PE's node weights and masks (and its ghosts' for the clustering's
    local table), the labels and, refining, the block weights."""
    rows = [getattr(st, f)[c] for f in ("ch_nodes", "ch_node_valid", "ch_edge_dst",
                                        "ch_edge_w", "ch_edge_slot", "ch_edge_valid")]
    extra = [table] if table is not None else [st.ghost_nw, st.ghost_valid]
    return rows + [st.nw_local, st.local_valid, ll, lg] + extra


def measure_lp_score_rows(torch, lbl, w, k: int) -> dict:
    """lp_score_rows against its plain version on one input: the max abs
    error, both times (CUDA events), the time of the one PyTorch call that
    computes the same function (``scatter_add_`` into a spare column k, the
    index clamped outside the timed region) and the bound for this input."""
    from repro_torch.kernels.lp_score import lp_score_rows, lp_score_rows_ref

    out = lp_score_rows(lbl, w, k)
    err = float((out - lp_score_rows_ref(lbl, w, k)).abs().max())
    ms = _time_ms(lambda: lp_score_rows(lbl, w, k), torch)
    plain_ms = _time_ms(lambda: lp_score_rows_ref(lbl, w, k), torch)
    idx = torch.where((lbl >= 0) & (lbl < k), lbl, k).to(torch.int64)
    acc = torch.zeros((lbl.shape[0], k + 1), dtype=torch.float32, device=lbl.device)
    acc.scatter_add_(1, idx, w)
    if not torch.allclose(acc[:, :k], out, rtol=1e-5, atol=1e-6):
        _fail(f"the library call disagrees with lp_score_rows: "
              f"{float((acc[:, :k] - out).abs().max())}")
    library_ms = _time_ms(lambda: acc.scatter_add_(1, idx, w), torch)
    del idx, acc
    R, W = lbl.shape
    n_bytes = R * W * (4 + 4) + R * k * 4        # each input read, output written once
    n_ops = int(((lbl >= 0) & (lbl < k)).sum())  # one add per in-range slot
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gbytes=n_bytes / 1e9)


def _report(tag: str, R: int, W: int, k: int, m: dict) -> None:
    print(f"lp_score_rows {tag} ({R}x{W}, k={k}): kernel {m['ms']:.4f} ms, "
          f"plain {m['plain_ms']:.4f} ms, library scatter_add_ {m['library_ms']:.4f} ms, "
          f"bound {m['bound_ms']:.4f} ms "
          f"({m['gbytes']:.3f} GB, {m['bound_by']}), "
          f"{m['gbytes'] / m['ms']:.3f} TB/s achieved, max_abs_err {m['max_abs_err']}",
          flush=True)


def check_lp_score_rows(torch, dev, R: int, W: int, k: int) -> None:
    """Phase 2 for lp_score_rows: exact at the path's finest shape ``(R, W)``
    on integral weights, rtol=1e-5 on float weights at small shapes."""
    from repro_torch.kernels.lp_score import lp_score_rows, lp_score_rows_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # uniform labels, including the sentinel k and out-of-range values
    lbl = torch.randint(-1, k + 2, (R, W), generator=gen, device=dev, dtype=torch.int32)
    w = torch.randint(0, 4, (R, W), generator=gen, device=dev).to(torch.float32)
    m = measure_lp_score_rows(torch, lbl, w, k)
    _report("uniform labels", R, W, k, m)
    if m["max_abs_err"] != 0.0:
        _fail(f"lp_score_rows differs from its plain version on integral weights: "
              f"{m['max_abs_err']}")
    # float weights: ragged W (scalar path) and W % 4 == 0 (vector path); the
    # kernel's atomics add in another order
    for (r, wd, kk) in ((1003, 37, 5), (4099, 128, 16), (77, 260, 300)):
        lb = torch.randint(-2, kk + 2, (r, wd), generator=gen, device=dev, dtype=torch.int32)
        ww = torch.rand((r, wd), generator=gen, device=dev)
        o = lp_score_rows(lb, ww, kk)
        e = lp_score_rows_ref(lb, ww, kk)
        torch.cuda.synchronize()
        if not torch.allclose(o, e, rtol=1e-5, atol=1e-6):
            _fail(f"lp_score_rows float mismatch at {(r, wd, kk)}: "
                  f"{float((o - e).abs().max())}")
        print(f"lp_score_rows float check {(r, wd, kk)}: max_abs_err="
              f"{float((o - e).abs().max()):.3e}", flush=True)
    del lbl, w
    torch.cuda.empty_cache()


def path_lp_score_rows(torch, g, labels: "np.ndarray", k: int) -> dict:
    """lp_score_rows on the main path's own finest-level input: the
    bucket-padded ELL pack of ``g`` with the labels the run returned (the
    last dense rounds of the finest level see nearly these)."""
    import numpy as np
    from repro_torch.graph import ell_pack, pow2

    ell = ell_pack(g)
    R = ell.rows
    Rb = pow2(R)
    lab_pad = np.concatenate([labels.astype(np.int32), np.array([k], np.int32)])
    lbl = np.full((Rb, ell.width), k, np.int32)
    lbl[:R] = lab_pad[ell.dst]
    w = np.zeros((Rb, ell.width), np.float32)
    w[:R] = ell.w
    m = measure_lp_score_rows(torch, torch.from_numpy(lbl).cuda(),
                              torch.from_numpy(w).cuda(), k)
    _report("main-path input", Rb, ell.width, k, m)
    if m["max_abs_err"] != 0.0:
        _fail(f"lp_score_rows differs from its plain version on the path's input: "
              f"{m['max_abs_err']}")
    torch.cuda.empty_cache()
    return m


# Latency probe of the walk's dependent chain: one warp times, with clock64,
# chains of the instructions one step of repair_balance_walk.cu waits on in
# turn; a second kernel spins for a number of cycles, which CUDA events time
# to give the SM clock.  Built like the port's kernels (kernels/build.py).
_WALK_PROBE_CU = r"""
#include <cuda_runtime.h>

namespace {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIters = 4096;

// the clock, read after dep is computed
__device__ __forceinline__ long long clock_after(long long dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "l"(dep) : "memory");
  return t;
}
// 0, computed from t: a chain that starts with it starts after t is read
__device__ __forceinline__ long long zero_after(long long t) {
  long long z;
  asm volatile("and.b64 %0, %1, 0;" : "=l"(z) : "l"(t));
  return z;
}

__device__ __forceinline__ void warp_min(double& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// out: cycles of kIters dependent shared loads (every lane the same
// address), kIters dependent float64 adds, kIters / 4 warp argmins (5
// rounds each) and kIters hand-offs (one lane stores, __syncwarp, every
// lane loads it); out[4] is a sink
__global__ void probe(long long* out, const int* next, double y) {
  __shared__ int s_next[1024];
  __shared__ double s_w[32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s_next[i] = next[i];
  s_w[lane] = y;
  __syncwarp();

  long long t0 = clock_after(0);
  int p = (int)zero_after(t0);
#pragma unroll 16
  for (int i = 0; i < kIters; ++i) p = s_next[p];
  long long t1 = clock_after(p);

  double x = y + (double)zero_after(t1);
  long long t2 = clock_after(__double_as_longlong(x));
  x += (double)zero_after(t2);
#pragma unroll 16
  for (int i = 0; i < kIters; ++i) x = x + y;
  long long t3 = clock_after(__double_as_longlong(x));

  double v = x * lane + (double)zero_after(t3);
  int idx = lane;
  long long t4 = clock_after(__double_as_longlong(v));
  v += (double)zero_after(t4);
#pragma unroll 4
  for (int i = 0; i < kIters / 4; ++i) warp_min(v, idx);
  long long t5 = clock_after(__double_as_longlong(v) + idx);

  double z = v + (double)zero_after(t5);
  long long t6 = clock_after(__double_as_longlong(z));
  z += (double)zero_after(t6);
#pragma unroll 16
  for (int i = 0; i < kIters; ++i) {
    if (lane == (i & 31)) s_w[lane] = z;
    __syncwarp();
    z = s_w[i & 31];
  }
  long long t7 = clock_after(__double_as_longlong(z));
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = t3 - t2;
    out[2] = t5 - t4;
    out[3] = t7 - t6;
    out[4] = p + idx + __double_as_longlong(z);
  }
}

__global__ void spin(long long cycles, long long* out) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < cycles) t = clock64();
  out[0] = t - t0;
}
}  // namespace

extern "C" int walk_probe_launch(void* out, const void* next, double y, void* stream) {
  probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), static_cast<const int*>(next), y);
  return (int)cudaGetLastError();
}

extern "C" int walk_spin_launch(long long cycles, void* out, void* stream) {
  spin<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(cycles, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
"""


def walk_chain_cycles(torch) -> dict:
    """The latencies one step of the walk waits on, in SM cycles, measured
    on the card by the probe above (the median of 5 runs), and the SM clock
    under a one-warp load (a spin of 2e8 cycles timed with CUDA events)."""
    import ctypes
    from repro_torch.kernels import build

    tmp = Path(tempfile.mkdtemp(prefix="walk_probe_"))
    try:
        src = tmp / "walk_latency_probe.cu"
        src.write_text(_WALK_PROBE_CU)
        lib = build.load(src)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lib.walk_probe_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_double, ctypes.c_void_p]
    lib.walk_spin_launch.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    nxt = torch.roll(torch.arange(1024, dtype=torch.int32, device="cuda"), -1)
    out = torch.zeros(5, dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(6):   # the first warms the instruction cache
        if lib.walk_probe_launch(out.data_ptr(), nxt.data_ptr(), 1.0, stream) != 0:
            _fail("the walk's latency probe failed to launch")
        runs.append(out[:4].tolist())
    runs = sorted(runs[1:])
    iters = 4096
    per = [sorted(r[i] for r in runs)[2] for i in range(4)]
    cycles = 200_000_000
    spin_out = torch.zeros(1, dtype=torch.int64, device="cuda")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    lib.walk_spin_launch(cycles, spin_out.data_ptr(), stream)   # warm
    a.record()
    lib.walk_spin_launch(cycles, spin_out.data_ptr(), stream)
    b.record()
    b.synchronize()
    hz = int(spin_out[0]) / (a.elapsed_time(b) / 1e3)
    return dict(lds=per[0] / iters, dadd=per[1] / iters, round=per[2] / (iters // 4 * 5),
                handoff=per[3] / iters, sm_hz=hz)


def walk_bound(lat: dict, moves: int, skips: int) -> dict:
    """The walk's floor on one input: its dependent chain at the measured
    latencies.  A skip waits on the candidate's block (a shared load), that
    block's weight (a second, dependent one) and the compare; a move adds
    the new weight (a float64 add), the owner's store, the warp barrier and
    the rescan's load (the hand-off), the rescan's compare and the warp
    argmin's 5 shuffle rounds.  The tile loads (one per 1,024 candidates)
    and the loop's own instructions are left out, so it is a floor."""
    skip = 2 * lat["lds"] + lat["dadd"]
    move = skip + lat["dadd"] + lat["handoff"] + lat["dadd"] + 5 * lat["round"]
    cyc = moves * move + skips * skip
    return dict(skip_cycles=round(skip, 1), move_cycles=round(move, 1),
                bound_ms=round(cyc / lat["sm_hz"] * 1e3, 4))


def path_repair_balance_walk(torch, g, finishes) -> dict:
    """repair_balance_walk on the main path's own inputs: for each of phase
    4's device finishes whose labels had a block above L, the prelude
    (``walk_inputs``) rebuilds the walk's inputs from the arguments the
    finish got.  The kernel's labels and moved count must equal its plain
    version's, and its finish the host ``repair_balance``'s, label for
    label.  Each walk is timed (CUDA events) beside its plain version and
    the host repair (host clock, on the CPU), against its bound
    (:func:`walk_bound`)."""
    import numpy as np
    from repro_torch.core import repair_balance
    from repro_torch.kernels.balance import (
        repair_balance_walk,
        repair_balance_walk_ref,
        walk_inputs,
    )

    lat = walk_chain_cycles(torch)
    print(f"walk chain latencies (cycles): shared load {lat['lds']:.2f}, float64 add "
          f"{lat['dadd']:.2f}, argmin round {lat['round']:.2f}, hand-off "
          f"{lat['handoff']:.2f}; SM clock {lat['sm_hz'] / 1e9:.4f} GHz", flush=True)
    rows = []
    for i, (lab, src, dst, ew, nw, n, k, L) in enumerate(finishes):
        inp = walk_inputs(lab, src, dst, ew, nw, n, k, L)
        if inp is None:
            continue
        cand, cand_lab, cand_nw, bw = inp
        out, moved = repair_balance_walk(cand, cand_lab, cand_nw, lab, bw, L)
        C = int(cand.shape[0])
        t = time.perf_counter()
        ref, ref_moved = repair_balance_walk_ref(
            *(x.cpu() for x in (cand, cand_lab, cand_nw, lab, bw)), L)
        plain_ms = (time.perf_counter() - t) * 1e3
        lab_np = lab[:n].cpu().numpy()
        t = time.perf_counter()
        want = repair_balance(g, lab_np, k, L)
        host_ms = (time.perf_counter() - t) * 1e3
        got = out.cpu()
        diff = int((got != ref).sum())
        if diff or int(moved) != int(ref_moved):
            _fail(f"repair_balance_walk differs from its plain version on finish {i}: "
                  f"{diff} labels, moved {int(moved)} against {int(ref_moved)}")
        if not np.array_equal(got[:n].numpy(), want):
            _fail(f"the device finish differs from repair_balance on finish {i}: "
                  f"{int((got[:n].numpy() != want).sum())} labels")
        # the candidates walked: all, unless the last move left no block
        # above L and the walk stopped there
        end = torch.zeros(k, dtype=torch.float64, device=lab.device).index_add_(
            0, torch.clamp(out, max=k - 1).long(), torch.where(out < k, nw, 0).double())
        hit = torch.nonzero(out[cand] != cand_lab).flatten()
        walked = C if bool((end > L).any()) or hit.numel() == 0 else int(hit[-1]) + 1
        mv = int(moved)
        ms = _time_ms(lambda: repair_balance_walk(cand, cand_lab, cand_nw, lab, bw, L),
                      torch, warmup=1, batches=3, reps=3)
        b = walk_bound(lat, mv, walked - mv)
        row = dict(finish=i, candidates=C, walked=walked, moved=mv, ms=round(ms, 4),
                   ns_per_candidate=round(ms * 1e6 / walked, 2),
                   ns_per_move=round(ms * 1e6 / max(mv, 1), 2), plain_ms=round(plain_ms, 2),
                   host_ms=round(host_ms, 2), **b,
                   over_bound=round(ms / b["bound_ms"], 3) if b["bound_ms"] else None)
        print(f"repair_balance_walk main-path input, finish {i} (n={n}, k={k}): "
              f"{C} candidates, {walked} walked, {mv} moved; kernel {ms:.4f} ms "
              f"({row['ns_per_candidate']} ns a candidate walked, {row['ns_per_move']} a "
              f"move), plain version {plain_ms:.1f} ms and repair_balance {host_ms:.1f} ms "
              f"on the host; bound {b['bound_ms']} ms (latency: {b['move_cycles']} cycles "
              f"a move, {b['skip_cycles']} a skip), {row['over_bound']}x it; labels == "
              f"plain == repair_balance", flush=True)
        rows.append(row)
    if not rows:
        _fail("no finish of phase 4 had a block above L: the walk saw no input")
    torch.cuda.empty_cache()
    return dict(rows=rows, latency=lat)


def _step_bytes(pack, cc: int, moves: int) -> int:
    """Bytes one chunk step needs, each read once and each result written
    once: the chunk's valid arcs (head 8, weight 4, slot 8, valid 1) and
    the label of each head (4), every node slot (id 8, valid 1), each valid
    node's label and weight (4 + 4), and for each move its label (4) and
    two block weights (8)."""
    nodes, node_valid, _, _, _, edge_valid = pack
    arcs = int(edge_valid[cc].sum())
    valid = int(node_valid[cc].sum())
    return arcs * 25 + nodes.shape[-1] * 9 + valid * 8 + moves * 12


def path_lp_chunk_step(torch, sweeps) -> dict:
    """lp_chunk_step on the main path's own inputs: the first sweep of each
    kind phase 4 made (``sweeps``: (refine_mode, use_restrict, rows > 1) ->
    its arguments), through the kernel and through its plain version on
    the CPU; labels, block weights and moves must agree bit for bit.  Then
    one step at the finest level's largest chunk (the first cluster
    sweep's), timed with CUDA events: the kernel's three launches alone, and
    a one-step sweep through the kernel and through the plain version on
    the card, against the step's bytes at HBM bandwidth."""
    import numpy as np
    from repro_torch.core.label_propagation import _sweep_plan, lp_sweep_batched, lp_sweep_plain
    from repro_torch.kernels.lp_step import ChunkStep, block_nodes

    rows = []
    for (refine, restrict, batched), (args, kw) in sorted(sweeps.items()):
        v0 = block_nodes()
        t = time.perf_counter()
        got = lp_sweep_batched(*args, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        visits = block_nodes() - v0
        t = time.perf_counter()
        want = lp_sweep_plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args),
                              **kw)
        cpu_s = time.perf_counter() - t
        for part, x, y in zip(("labels", "weights", "moves"), got, want):
            if not torch.equal(x.cpu(), y):
                _fail(f"lp_chunk_step differs from its plain version on phase 4's "
                      f"{'refine' if refine else 'cluster'} sweep (restrict {restrict}, "
                      f"rows {args[6].shape[0]}): {part}, "
                      f"{int((x.cpu() != y).sum())} entries")
        row = dict(refine=refine, restrict=restrict, rows=int(args[6].shape[0]),
                   pack=list(args[0].shape), iters=kw["iters"],
                   moves=int(want[2].sum()), block_visits=visits,
                   card_s=round(card_s, 4), plain_cpu_s=round(cpu_s, 2))
        print(f"lp_chunk_step main-path input: {json.dumps(row)}; card == plain", flush=True)
        rows.append(row)
    if (False, False, False) not in sweeps:
        _fail("phase 4 made no cluster sweep: lp_chunk_step saw no finest-level input")
    args, kw = sweeps[(False, False, False)]
    # the whole first cluster sweep under the profiler: its steps launch the
    # kernel's three kernels and nothing else (no sort, scan or scatter);
    # the sweep's set-up (copies, fills, the chunks' count of valid arcs)
    # launches a few ops once
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lp_sweep_batched(*args, **kw)
        torch.cuda.synchronize()
    ran = {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"}
    ours = sum(c for k, c in ran.items()
               if any(f"{s}_kernel<" in k for s in ("segment", "propose", "apply")))
    banned = {k: c for k, c in ran.items()
              if any(w in k.lower() for w in ("sort", "scan", "scatter"))}
    steps = kw["iters"] * int(args[13])
    setup = sum(ran.values()) - ours
    print(f"lp_chunk_step profiled sweep ({steps} steps): {ours} kernel launches, {setup} "
          f"set-up ops; device ops {json.dumps(ran)}", flush=True)
    if ours != 3 * steps or banned or setup > 16:
        _fail(f"the profiled sweep launched {ours} lp_chunk_step kernels for {steps} steps, "
              f"{setup} other ops, {banned}")
    pack = args[:6]
    cc = int(torch.argmax(pack[5].sum(dim=1)))
    one = tuple(t[cc:cc + 1] for t in pack)
    rest = (*args[6:13], 1)
    dev = args[6].device
    perm, bj, _ = _sweep_plan(args[11], 1, 1, 1, 1, False, False, dev)
    U = torch.tensor([float(np.float32(args[10]))], device=dev)
    step = ChunkStep(one, *args[6:10], U, torch.from_numpy(perm).to(dev), bj, bj,
                     int(args[12]), refine_mode=False, use_restrict=False)
    step(0, 0)
    moves = int(step.result()[2].sum())
    kernel_ms = _time_ms(lambda: step(0, 0), torch)
    sweep_kw = dict(kw, iters=1)
    sweep_ms = _time_ms(lambda: lp_sweep_batched(*one, *rest, **sweep_kw), torch,
                        warmup=1, batches=3, reps=3)
    plain_ms = _time_ms(lambda: lp_sweep_plain(*one, *rest, **sweep_kw), torch,
                        warmup=1, batches=3, reps=3)
    nbytes = _step_bytes(pack, cc, moves)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    timing = dict(chunk=cc, arcs=int(pack[5][cc].sum()), slots=int(pack[0].shape[-1]),
                  nodes=int(pack[1][cc].sum()), first_step_moves=moves,
                  ms=round(kernel_ms, 4), sweep_ms=round(sweep_ms, 4),
                  plain_ms=round(plain_ms, 4), bytes=nbytes, bound_ms=round(bound_ms, 5),
                  over_bound=round(kernel_ms / bound_ms, 2))
    print(f"lp_chunk_step one step at the finest level's largest chunk: {json.dumps(timing)}",
          flush=True)
    torch.cuda.empty_cache()
    return dict(rows=rows, timing=timing)


def check_dense_round_batched(torch, g, k: int, B: int = 4) -> None:
    """Phase 2 for the batched dense round: ``B`` label rows on the finest
    level's ELL pack, scored with one kernel launch, must equal ``B``
    one-row rounds with the same seeds (integral weights: exact)."""
    import numpy as np
    from repro_torch.graph import ell_pack, pow2
    from repro_torch.kernels.lp_score import (
        dense_round_device,
        dense_round_device_batched,
        lp_score_rows,
    )

    ell = ell_pack(g)
    Rb = pow2(ell.rows)
    dev = torch.device("cuda")
    dst = torch.full((Rb, ell.width), g.n, dtype=torch.int64, device=dev)
    dst[: ell.rows] = torch.from_numpy(ell.dst).to(dev)
    w = torch.zeros((Rb, ell.width), dtype=torch.float32, device=dev)
    w[: ell.rows] = torch.from_numpy(ell.w).to(dev)
    row_node = torch.full((Rb,), g.n, dtype=torch.int64, device=dev)
    row_node[: ell.rows] = torch.from_numpy(ell.row_node).to(dev)
    nb = pow2(g.n + 1)
    lab = np.full((B, nb), k, np.int32)
    lab[:, : g.n] = np.random.default_rng(5).integers(0, k, (B, g.n))
    labs = torch.from_numpy(lab).to(dev)
    nw = torch.zeros(nb, dtype=torch.float32, device=dev)
    nw[: g.n] = torch.from_numpy(g.nw).to(dev)
    U = float(np.ceil(g.nw.sum() / k) * 1.03)
    seeds = [11 + b for b in range(B)]
    before = lp_score_rows.launches
    got = dense_round_device_batched(dst, w, row_node, labs, nw, U, seeds, 0.5, g.n, k=k)
    torch.cuda.synchronize()
    if lp_score_rows.launches != before + 1:
        _fail("the batched dense round did not score its rows with one launch")
    moved = 0
    for b in range(B):
        one = dense_round_device(dst, w, row_node, labs[b], nw, U, seeds[b], 0.5, g.n, k=k)
        if not torch.equal(got[b], one):
            _fail(f"batched dense round row {b} differs from its one-row round: "
                  f"{int((got[b] != one).sum())} labels")
        moved += int((got[b, : g.n] != labs[b, : g.n]).sum())
    if moved == 0:
        _fail("the batched dense round moved no node")
    print(f"dense_round_device_batched ({B} x {Rb}x{ell.width}, k={k}): one launch, "
          f"every row == its one-row round, {moved} moves", flush=True)
    del dst, w, labs, got
    torch.cuda.empty_cache()


def check_small_parity(torch) -> None:
    """Phase 3: on a small integral graph the card's path (kernel, device
    sorts and atomics) must give the CPU path's labels exactly, with the
    host GA and with the default ``evo_engine`` (the batched GA)."""
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.graph import rmat

    g = rmat(12, 8, seed=3)
    base = dict(k=8, preset="fast", refine_engine="dense", coarsest_factor=40,
                dense_min_n=256, numpy_below=256, seed=0)
    for evo in ("host", "auto"):
        cfg = dict(base, evo_engine=evo)
        on_card = partition(g, PartitionerConfig(**cfg), device="cuda")
        on_cpu = partition(g, PartitionerConfig(**cfg), device="cpu")
        st = on_card.engine_stats
        if st["dense_rounds"] == 0:
            _fail(f"small parity run (evo_engine={evo}) made no dense rounds")
        if (st["evo_calls"] > 0) != (evo == "auto"):
            _fail(f"small parity run (evo_engine={evo}): evo_calls {st['evo_calls']}")
        if not (on_card.labels == on_cpu.labels).all() or on_card.cut != on_cpu.cut:
            _fail(f"card and CPU partitions differ (evo_engine={evo}): "
                  f"cut {on_card.cut} vs {on_cpu.cut}")
        print(f"small parity rmat(12, 8) k=8 evo_engine={evo}: card == cpu, "
              f"cut {on_card.cut}, evo_calls {st['evo_calls']}, "
              f"levels {on_card.level_sizes}", flush=True)


def _evo_key(g, lab, k: int, Lmax: float) -> int:
    """The GA's fitness key of ``lab`` on the host: the cut, plus the
    penalty if a block is heavier than ``Lmax``."""
    import numpy as np
    from repro_torch.core.evolutionary import INFEAS_PENALTY
    from repro_torch.core.metrics import cut_np

    bw = np.bincount(lab, weights=g.nw, minlength=k).astype(np.float32)
    return int(cut_np(g, lab)) + (0 if (bw <= np.float32(Lmax)).all() else INFEAS_PENALTY)


def check_ga_generations(torch, g, seed_labels, k: int = 16, generations: int = 2) -> None:
    """Phase 4 for the GA's generation step, which the fast preset never
    runs (it has no generations): (a) card == CPU on rmat(14, 16) without
    isolated nodes with the eco preset's population (4 islands x 3) over
    ``generations`` generations; (b) the fast preset's population (2 x 2)
    over ``generations`` generations on the full graph ``g`` (Ab = 2^19,
    the shape gate's limit), seeded with ``seed_labels``: the best key must
    be no worse than the seed's.  Prints the seconds and the peak device
    memory of (b)."""
    import numpy as np
    from repro_torch.core import LPEngine
    from repro_torch.core.evolutionary import EvoConfig
    from repro_torch.core.metrics import lmax
    from repro_torch.graph import pow2, rmat

    small = drop_isolated(rmat(14, 16, seed=1))
    cfg = EvoConfig(k=k, Lmax=lmax(float(small.nw.sum()), k, 0.03), islands=4,
                    pop_per_island=3, generations=generations, refine_iters=6, seed=7)
    card = LPEngine(small, seed=0)
    if not card.can_evolve_device(small, k, cfg.islands, cfg.pop_per_island):
        _fail("the batched GA's gate refuses rmat(14, 16)")
    card._evo_arrays(small)    # pack and upload before the clock starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = card.evolve_device(small, cfg).cpu()
    card_s = time.perf_counter() - t
    on_cpu = LPEngine(small, seed=0, device="cpu").evolve_device(small, cfg)
    if card.stats.evo_calls != 1 + generations:
        _fail(f"GA generations on rmat(14, 16): evo_calls {card.stats.evo_calls}")
    if not torch.equal(on_card, on_cpu):
        _fail(f"GA generations on rmat(14, 16): card and CPU differ in "
              f"{int((on_card != on_cpu).sum())} labels")
    print(f"GA 4x3, {generations} generations, rmat(14, 16) n={small.n}: card == cpu, "
          f"key {_evo_key(small, on_card.numpy(), k, cfg.Lmax)}, card {card_s:.3f} s",
          flush=True)

    L = lmax(float(g.nw.sum()), k, 0.03)
    cfg = EvoConfig(k=k, Lmax=L, islands=2, pop_per_island=2, generations=generations,
                    refine_iters=6, seed=7, seed_individuals=[seed_labels])
    eng = LPEngine(g, seed=0)
    if not eng.can_evolve_device(g, k, cfg.islands, cfg.pop_per_island):
        _fail(f"the batched GA's gate refuses the full graph (n={g.n})")
    eng._evo_arrays(g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lab = eng.evolve_device(g, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    lab = lab.cpu().numpy()
    seed_key = _evo_key(g, np.asarray(seed_labels, np.int32), k, L)
    best_key = _evo_key(g, lab, k, L)
    print(f"GA 2x2, {generations} generations, full graph n={g.n} (Ab={pow2(g.n + 1)}), "
          f"seeded: {secs:.3f} s, evo_calls {eng.stats.evo_calls}, best key {best_key} "
          f"(seed {seed_key}), peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before)",
          flush=True)
    if eng.stats.evo_calls != 1 + generations:
        _fail(f"GA generations on the full graph: evo_calls {eng.stats.evo_calls}")
    if best_key > seed_key:
        _fail(f"GA generations on the full graph: best key {best_key} worse than "
              f"the seed's {seed_key}")
    del eng
    torch.cuda.empty_cache()


def drop_isolated(g):
    """The subgraph of ``g`` on its nodes of degree > 0 (ids renumbered in
    order, so every CSR row stays sorted)."""
    import numpy as np
    from repro_torch.graph import GraphNP

    deg = g.degrees()
    keep = np.flatnonzero(deg > 0)
    new_id = np.full(g.n, -1, np.int64)
    new_id[keep] = np.arange(keep.size)
    return GraphNP(
        indptr=np.concatenate([[0], np.cumsum(deg[keep])]).astype(np.int64),
        indices=new_id[g.indices].astype(np.int32),
        ew=g.ew,
        nw=g.nw[keep],
    )


def make_graph(scale: int, edge_factor: int):
    """The end-to-end input: ``rmat(scale, edge_factor, seed=1)`` without
    its isolated nodes.  R-MAT leaves about a third of its 2^scale ids
    without an edge; an isolated node can join no cluster, so with them the
    coarsening stalls near their count and the host GA would see hundreds of
    thousands of nodes.  The web graphs rmat stands in for have none."""
    from repro_torch.graph import rmat

    t = time.perf_counter()
    g_full = rmat(scale, edge_factor, seed=1)
    g = drop_isolated(g_full)
    print(f"rmat({scale}, {edge_factor}): {g_full.n} ids, {g.n} with edges, "
          f"m={g.m} arcs, generated in {time.perf_counter() - t:.1f} s", flush=True)
    return g


def run_partition(torch, g, out_dir: Path, evo_engine: str) -> dict:
    """Phase 4: the port's main path end to end with the given GA engine;
    the kernels' launch counts are set to 0 just before and read just
    after, and each device finish's arguments are kept (its labels cloned)
    for phase 5."""
    import repro_torch.core.engine as engine_mod
    import repro_torch.core.evo_device as evo_mod
    import repro_torch.core.label_propagation as lp_mod
    from repro_torch.core import PartitionerConfig, hash_partition, partition
    from repro_torch.core.metrics import cut_np
    from repro_torch.kernels.balance import repair_balance_walk
    from repro_torch.kernels.lp_score import lp_score_rows
    from repro_torch.kernels.lp_step import ChunkStep, block_nodes
    from repro_torch.obs import Tracer, set_tracer
    cfg = PartitionerConfig(k=16, preset="fast", refine_engine="dense",
                            evo_engine=evo_engine, coarsest_factor=100, seed=0)
    tracer = Tracer()
    set_tracer(tracer)
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    repair_balance_walk.launches = 0
    ChunkStep.launches = 0
    block0 = block_nodes()
    sweeps = {}   # (refine_mode, use_restrict, rows > 1) -> the first such sweep's (args, kw)

    def keep_sweep(a, kw):
        kind = (kw["refine_mode"], kw["use_restrict"], a[6].shape[0] > 1)
        if kind not in sweeps:
            sweeps[kind] = ((*a[:6], a[6].clone(), a[7].clone(), *a[8:]), kw)

    # (labels, src, dst, ew, nw, n, k, L) of each device finish
    with _Counted(torch, engine_mod, "repair_balance_device",
                  keep=lambda a, kw: (a[0].clone(), *a[1:])) as fin, \
            _Counted(torch, lp_mod, "lp_sweep_batched", keep=keep_sweep), \
            _Counted(torch, evo_mod, "lp_sweep_batched", keep=keep_sweep):
        t = time.perf_counter()
        rep = partition(g, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = lp_score_rows.launches
    walk_launches = repair_balance_walk.launches
    step_launches = ChunkStep.launches
    block_visits = block_nodes() - block0
    set_tracer(None)

    k = cfg.k
    hash_cut = cut_np(g, hash_partition(g.n, k))
    tag = f"[evo_engine={evo_engine}]"
    print(f"{tag} partition: {wall:.3f} s wall ({rep.seconds:.3f} s in partition), "
          f"cut {rep.cut} ({rep.cut / hash_cut:.4f} of hash cut {hash_cut}), "
          f"imbalance {rep.imbalance:.5f}, feasible {rep.feasible}", flush=True)
    print(f"{tag} level_sizes {rep.level_sizes}", flush=True)
    print(f"{tag} cycle_cuts {rep.cycle_cuts}", flush=True)
    print(f"{tag} engine_stats {json.dumps(rep.engine_stats)}", flush=True)
    print(f"{tag} lp_score_rows launches {launches}", flush=True)
    # a finish launches the walk iff its labels have a block above L
    infeasible = sum(
        bool((torch.zeros(kk + 1, dtype=torch.float64, device=lab.device).index_add_(
            0, torch.clamp(lab, max=kk).long(), nw.double())[:kk] > L).any())
        for lab, _s, _d, _w, nw, _n, kk, L in fin.kept)
    finish_device = rep.engine_stats["finish_device"]
    print(f"{tag} repair_balance_walk launches {walk_launches}; device finishes "
          f"{finish_device} ({infeasible} with a block above L), finish_moved "
          f"{rep.engine_stats['finish_moved']}", flush=True)
    lp_steps = sum(ev["name"] == "lp.step" for ev in tracer.events)
    print(f"{tag} lp_chunk_step launches {step_launches} for {lp_steps} lp.step spans "
          f"(3 a step); {block_visits} hub visits", flush=True)

    # where the time went, by span (spans do not nest on this path)
    groups = {}
    evolves = []
    for ev in tracer.events:
        a = ev.get("args", {})
        if ev["name"] == "vcycle.pack":
            key = "pack.ell" if a.get("mode") == "ell" else "pack.gather"
        elif ev["name"] == "vcycle.sweep":
            key = f"sweep.{a.get('mode')}"
        elif ev["name"] == "vcycle.evolve":
            key = f"evolve.{a.get('engine')}"
            evolves.append((a.get("engine"), a.get("n"), ev["dur"] / 1e6))
        else:
            key = ev["name"].split(".", 1)[1]
        groups[key] = groups.get(key, 0.0) + ev["dur"] / 1e6
    groups["other"] = rep.seconds - sum(groups.values())
    print(f"{tag} breakdown_s " + json.dumps({k_: round(v, 4) for k_, v in sorted(groups.items())}),
          flush=True)
    print(f"{tag} evolve spans (engine, coarsest n, s): {evolves}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracer.export_chrome(str(out_dir / f"chip_smoke_trace_{evo_engine}.json"))

    if not rep.feasible or rep.imbalance > cfg.eps + 1e-9:
        _fail(f"{tag} infeasible partition: imbalance {rep.imbalance}")
    if not rep.cut < hash_cut:
        _fail(f"{tag} cut {rep.cut} not below the hash partition's {hash_cut}")
    if launches <= 0:
        _fail(f"{tag} the main path never launched lp_score_rows")
    if launches != rep.engine_stats["dense_rounds"]:
        _fail(f"{tag} {launches} launches for {rep.engine_stats['dense_rounds']} dense rounds")
    if finish_device != cfg.vcycles or fin.calls != finish_device:
        _fail(f"{tag} {finish_device} device finishes ({fin.calls} calls) in "
              f"{cfg.vcycles} V-cycles")
    if walk_launches <= 0:
        _fail(f"{tag} the main path never launched repair_balance_walk")
    if walk_launches != infeasible:
        _fail(f"{tag} {walk_launches} repair_balance_walk launches for {infeasible} "
              f"finishes with a block above L")
    if lp_steps <= 0 or step_launches != 3 * lp_steps:
        _fail(f"{tag} {step_launches} lp_chunk_step launches for {lp_steps} lp.step spans")
    want_engine = "host" if evo_engine == "host" else "device"
    if len(evolves) != cfg.vcycles or any(e[0] != want_engine for e in evolves):
        _fail(f"{tag} want the {want_engine} GA in all {cfg.vcycles} V-cycles, "
              f"got {evolves}")
    return dict(rep=rep, launches=launches, walk_launches=walk_launches, wall=wall,
                evolve_s=sum(e[2] for e in evolves), evolves=evolves, finishes=fin.kept,
                step_launches=step_launches, lp_steps=lp_steps, sweeps=sweeps)


# --------------------------------------------------------------------------
# phase 6: the dynamic serving subsystem
# --------------------------------------------------------------------------


def _pcts(xs) -> str:
    import numpy as np

    a = np.asarray(xs, np.float64)
    return (f"p50 {np.percentile(a, 50):.4f} s, p99 {np.percentile(a, 99):.4f} s, "
            f"min {a.min():.4f} s, max {a.max():.4f} s")


def churn_batches(g, rng, nb: int, n_now):
    """The reference benchmark's churn model (``benchmarks/run.py``,
    ``_churn_stream``): per batch ``nb`` random adds plus ``nb`` removals of
    surviving original edges, each of weight 1, so the edge-weight sum
    stays constant.  ``n_now()`` gives the current node count.  Yields
    ``(update, (add_u, add_v), (rem_u, rem_v))``."""
    import numpy as np
    from repro_torch.dynamic import GraphUpdate

    src0 = g.arc_sources()
    removed = src0 >= g.indices        # canonical (src < dst) arcs only
    while True:
        n = n_now()
        au = rng.integers(0, n, nb)
        av = (au + 1 + rng.integers(0, n - 1, nb)) % n
        cand = rng.permutation(np.flatnonzero(~removed))[:nb]
        removed[cand] = True
        ru, rv = src0[cand], g.indices[cand]
        upd = GraphUpdate.add_edges(au, av).merged(GraphUpdate.remove_edges(ru, rv))
        yield upd, (au, av), (ru, rv)


def _small_stream(g, seed: int):
    """Phase 6a's six actions on ``g``: edge churn, 32 added nodes, 24 of
    them wired in, the 8 left isolated removed."""
    import numpy as np
    from repro_torch.dynamic import GraphUpdate

    rng = np.random.default_rng(seed)
    n0 = g.n
    batches = churn_batches(g, rng, 24, lambda: n0)
    acts = [("update", next(batches)[0]), ("update", next(batches)[0])]
    acts.append(("update", GraphUpdate.add_nodes(np.ones(32, np.int64)).merged(
        next(batches)[0])))
    new = np.arange(n0, n0 + 24)
    acts.append(("update", GraphUpdate.add_edges(new, rng.integers(0, n0, 24)).merged(
        next(batches)[0])))
    acts.append(("update", next(batches)[0]))
    acts.append(("remove_nodes", np.arange(n0 + 24, n0 + 32)))
    return acts


def _same_step(tag, a, b, la, lb):
    import numpy as np

    if not np.array_equal(la, lb):
        _fail(f"{tag}: card and CPU labels differ in {int((la != lb).sum())} nodes")
    for f in ("cut", "region_size", "imbalance", "feasible", "escalated", "used_view", "n", "m"):
        if getattr(a, f) != getattr(b, f):
            _fail(f"{tag}: {f} {getattr(a, f)} on the card, {getattr(b, f)} on the CPU")


def check_dynamic_small(torch) -> None:
    """Phase 6a: a small mixed stream on the card and on the CPU, under the
    default and the throughput session config, then a three-tenant group
    (one tenant at k=3): labels, cuts and region sizes equal after every
    batch."""
    import numpy as np
    from repro_torch.dynamic import PartitionSession, SessionConfig, SessionGroup
    from repro_torch.graph import barabasi_albert

    g = barabasi_albert(1024, 4, seed=5)
    acts = _small_stream(g, seed=1)
    for name, cfg in (("default", dict()), ("throughput", dict(compact_fraction=0.02))):
        make = SessionConfig.throughput if name == "throughput" else SessionConfig
        sess = {d: PartitionSession(g, make(k=4, seed=0, **cfg), device=d)
                for d in ("cuda", "cpu")}
        _same_step(f"6a {name} start", sess["cuda"].trajectory[0], sess["cpu"].trajectory[0],
                   sess["cuda"].labels_np(), sess["cpu"].labels_np())
        views = 0
        for i, (kind, x) in enumerate(acts):
            res = {d: (s.update(x) if kind == "update" else s.remove_nodes(x))
                   for d, s in sess.items()}
            _same_step(f"6a {name} batch {i}", res["cuda"], res["cpu"],
                       sess["cuda"].labels_np(), sess["cpu"].labels_np())
            views += int(res["cuda"].used_view)
        c = sess["cuda"]
        if c.n != g.n + 24 or c.store.stats.vacuum_calls != 1:
            _fail(f"6a {name}: n {c.n}, vacuum_calls {c.store.stats.vacuum_calls}")
        print(f"6a {name}: 6 batches on ba-1024 k=4 (churn, +32 nodes, 24 wired, 8 removed): "
              f"card == cpu, cut {c.cut}, view steps {views}, "
              f"repair_calls {c.stats()['repair_calls']}", flush=True)
    tenants = {f"t{i}": (barabasi_albert(1024, 4, seed=5 + i), k) for i, k in enumerate((4, 4, 3))}
    groups, last = {}, {}
    for d in ("cuda", "cpu"):
        groups[d] = SessionGroup({
            name: PartitionSession(gi, SessionConfig(k=k, seed=i, repair_iters=2), device=d)
            for i, (name, (gi, k)) in enumerate(tenants.items())})
    streams = {name: churn_batches(gi, np.random.default_rng(20 + i), 16, lambda gi=gi: gi.n)
               for i, (name, (gi, _)) in enumerate(tenants.items())}
    for step in range(4):
        batch = [(name, next(st)[0]) for name, st in streams.items()]
        for d, grp in groups.items():
            last[d] = grp.update_many(batch)
        for name in tenants:
            _same_step(f"6a group step {step} tenant {name}", last["cuda"][name],
                       last["cpu"][name], groups["cuda"].sessions[name].labels_np(),
                       groups["cpu"].sessions[name].labels_np())
    sd = groups["cuda"].stats_dict()
    if sd["lanes_repaired"] != 12:
        _fail(f"6a group: lanes_repaired {sd['lanes_repaired']}, want 12")
    print(f"6a group of 3 tenants (k=4, 4, 3), 4 steps: card == cpu, {json.dumps(sd)}",
          flush=True)


def _span_ms(tracer) -> dict:
    out = {}
    for ev in tracer.events:
        out[ev["name"]] = round(out.get(ev["name"], 0.0) + ev["dur"] / 1e3, 3)
    return out


def _traced(torch, fn):
    """Run ``fn()`` once with span tracing on (spans synchronize the card at
    their close); returns ``(result, {span: ms})``."""
    from repro_torch.obs import Tracer, set_tracer

    tracer = Tracer()
    set_tracer(tracer)
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        set_tracer(None)
    return res, _span_ms(tracer)


def _report_batch(tag, res) -> None:
    print(f"{tag}: {res.seconds:.4f} s, region {res.region_size}, cut {res.cut}, "
          f"imbalance {res.imbalance:.5f}, feasible {res.feasible}, view {res.used_view}, "
          f"escalated {res.escalated}, span_ms "
          + json.dumps({k: round(v, 3) for k, v in res.span_ms.items()}), flush=True)


def check_dynamic_full(torch, g, warm: int = 2, timed: int = 8) -> dict:
    """Phase 6b: a session on the phase-4 graph at k=16 (dense refinement
    at session start and in escalations) under the reference churn model
    at 0.1 % of the edges per batch.  Checks feasibility at every step, the
    store's CSR against a numpy rebuild of the edge multiset, one full-width
    repair card == CPU, and runs one forced escalation."""
    import numpy as np
    from repro_torch.core import LPEngine, PartitionerConfig, partition
    from repro_torch.dynamic import PartitionSession, SessionConfig
    from repro_torch.graph import from_edges, to_device_csr
    from repro_torch.kernels.lp_score import lp_score_rows

    k = 16
    pcfg = PartitionerConfig(k=k, preset="fast", refine_engine="dense", coarsest_factor=100)
    nb = g.m // 2 // 1000
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    t = time.perf_counter()
    sess = PartitionSession(g, SessionConfig(k=k, seed=0, partition_cfg=pcfg))
    torch.cuda.synchronize()
    print(f"6b session start on n={g.n}, m={g.m}: {time.perf_counter() - t:.3f} s, "
          f"cut {sess.cut}, lp_score_rows launches {lp_score_rows.launches}", flush=True)
    batches = churn_batches(g, np.random.default_rng(11), nb, lambda: sess.n)
    adds, rems, secs, last_touched = [], [], [], None
    for i in range(warm + timed):
        upd, a, r = next(batches)
        last_upd = upd
        adds.append(a)
        rems.append(r)
        if i == warm + timed - 1:
            res, spans = _traced(torch, lambda: sess.update(upd))
            print(f"6b traced batch spans_ms {json.dumps(spans)}", flush=True)
        else:
            res = sess.update(upd)
        last_touched = np.concatenate([a[0], a[1], r[0], r[1]])
        _report_batch(f"6b batch {i} ({nb} adds + {nb} removals)", res)
        if not res.feasible:
            _fail(f"6b batch {i} infeasible: imbalance {res.imbalance}")
        if i >= warm and i < warm + timed - 1:
            secs.append(res.seconds)
    print(f"6b per-update seconds over {len(secs)} untraced timed batches: {_pcts(secs)}",
          flush=True)
    print(f"6b stats {json.dumps(sess.stats(), default=str)}", flush=True)
    time_store_programs(torch, sess.store.base, last_upd)

    # ---- the store's CSR against a numpy rebuild of the edge multiset
    t = time.perf_counter()
    gh = sess.store.csr_host()
    src0 = g.arc_sources()
    canon = src0 < g.indices
    u = np.concatenate([src0[canon]] + [x[0] for x in adds] + [x[0] for x in rems])
    v = np.concatenate([g.indices[canon]] + [x[1] for x in adds] + [x[1] for x in rems])
    w = np.concatenate([g.ew[canon], np.ones(sum(x[0].size for x in adds)),
                        -np.ones(sum(x[0].size for x in rems))])
    lo, hi = np.minimum(u, v).astype(np.int64), np.maximum(u, v).astype(np.int64)
    keys, inv = np.unique(lo * g.n + hi, return_inverse=True)
    net = np.bincount(inv, weights=w)
    live = net > 0
    want = from_edges(g.n, keys[live] // g.n, keys[live] % g.n, net[live], nw=g.nw)
    for name in ("indptr", "indices", "ew", "nw"):
        if not np.array_equal(getattr(gh, name), getattr(want, name)):
            _fail(f"6b store CSR differs from the numpy rebuild in {name}")
    print(f"6b store CSR == numpy rebuild of the edge multiset (m={gh.m}, "
          f"{time.perf_counter() - t:.1f} s)", flush=True)

    # ---- one full-width repair, card against CPU, from the same state
    U = sess._lmax()
    kw = dict(hops=sess.cfg.hops, iters=sess.cfg.repair_iters, seed=12345,
              hop_degree_cap=sess._hop_cap())
    lab = sess.labels_np()
    outs = {}
    for d in ("cuda", "cpu"):
        eng = LPEngine(g, target_chunks=sess.cfg.target_chunks, seed=0, device=d)
        eng._repair_E = sess.engine._repair_E
        gd = sess.store.graph() if d == "cuda" else to_device_csr(gh, "cpu")
        t = time.perf_counter()
        out, rsize, cut, bw = eng.repair(gd, lab, last_touched, k, U, **kw)
        if d == "cuda":
            torch.cuda.synchronize()
        outs[d] = (out.cpu().numpy(), rsize, cut, bw, time.perf_counter() - t)
    a, b = outs["cuda"], outs["cpu"]
    if not np.array_equal(a[0], b[0]):
        _fail(f"6b full-width repair: card and CPU labels differ in "
              f"{int((a[0] != b[0]).sum())} nodes")
    if a[1] != b[1] or a[2] != b[2] or not np.array_equal(a[3], b[3]):
        _fail(f"6b full-width repair: region/cut/weights differ: {a[1:4]} vs {b[1:4]}")
    print(f"6b one repair at full width (region {a[1]} of {g.n}): card == cpu, cut {a[2]}, "
          f"card {a[4]:.3f} s, cpu {b[4]:.3f} s", flush=True)

    # ---- one forced escalation
    upd, _, _ = next(batches)
    sess.cfg.escalate_cut_ratio = 0.0
    torch.cuda.synchronize()
    before = lp_score_rows.launches
    res = sess.update(upd)
    torch.cuda.synchronize()
    esc_launches = lp_score_rows.launches - before
    sess.cfg.escalate_cut_ratio = 1.6
    _report_batch("6b forced escalation", res)
    if not res.escalated or not res.feasible:
        _fail(f"6b forced escalation: escalated {res.escalated}, feasible {res.feasible}")
    total = lp_score_rows.launches
    t = time.perf_counter()
    fresh = partition(sess.store.csr_host(), PartitionerConfig(
        k=k, preset="fast", refine_engine="dense", coarsest_factor=100, seed=0))
    print(f"6b escalation: {res.seconds:.3f} s, lp_score_rows launches {esc_launches}, "
          f"cut {res.cut} against a fresh partition() of the final graph: {fresh.cut} "
          f"({res.cut / fresh.cut:.4f}; fresh run {time.perf_counter() - t:.3f} s)",
          flush=True)
    print(f"6b lp_score_rows launches over session start, stream and escalation: {total}",
          flush=True)
    if esc_launches <= 0 or total <= 0:
        _fail("6b: the dynamic path never launched lp_score_rows")
    return dict(secs=secs, esc_s=res.seconds, esc_launches=esc_launches, launches=total,
                sess=sess)


def time_store_programs(torch, b, upd) -> None:
    """CUDA-event times of the store's three device programs on the base
    CSR ``b`` with one batch's overlay: the merge, the view (timed here
    although the session's view gate refuses this node bucket) and a
    vacuum pass that keeps every node."""
    import numpy as np
    from repro_torch.dynamic.store import (
        merge_overlay_device,
        overlay_view_device,
        vacuum_device,
    )
    from repro_torch.graph import pow2

    u, v, w = upd.arcs()
    r = u.size
    Rb = pow2(max(r, 8))

    dev = b.indptr.device

    def pad(a, dt):
        return torch.from_numpy(np.concatenate([a, np.zeros(Rb - r, a.dtype)]).astype(dt)).to(dev)

    ou, ov, ow = pad(u, np.int64), pad(v, np.int64), pad(w, np.float32)
    Nb = b.indptr.shape[0] - 1
    newid = torch.arange(Nb, device=dev)
    keep = torch.ones(Nb, dtype=torch.bool, device=dev)
    kw = dict(warmup=1, batches=3, reps=3)
    ms = dict(
        merge=_time_ms(lambda: merge_overlay_device(
            b.src, b.indices, b.ew, ou, ov, ow, b.nw, b.n, b.m, r), torch, **kw),
        view=_time_ms(lambda: overlay_view_device(
            b.indptr, b.src, b.indices, b.ew, ou, ov, ow, b.n, b.m, r), torch, **kw),
        vacuum=_time_ms(lambda: vacuum_device(
            b.src, b.indices, b.ew, newid, keep, b.nw, b.m), torch, **kw),
    )
    print(f"6b store programs on the card (Mb={b.indices.shape[0]}, Rb={Rb}, Nb={Nb}), "
          f"ms: {json.dumps({k_: round(v_, 4) for k_, v_ in ms.items()})}", flush=True)


def check_dynamic_throughput(torch, warm: int = 2, timed: int = 8) -> None:
    """Phase 6c: the reference benchmark's throughput rows — ba-16384,
    k=4, ``SessionConfig.throughput`` at 1 % and then 0.1 % churn."""
    import numpy as np
    from repro_torch.dynamic import PartitionSession, SessionConfig
    from repro_torch.graph import barabasi_albert

    g = barabasi_albert(16384, 6, seed=3)
    sess = PartitionSession(g, SessionConfig.throughput(k=4, seed=0))
    for tag, nb, rng_seed, n_warm in (("1%", max(g.m // 2 // 200, 64), 11, warm),
                                      ("0.1%", max(g.m // 2 // 2000, 8), 13, 1)):
        batches = churn_batches(g, np.random.default_rng(rng_seed), nb, lambda: sess.n)
        for _ in range(n_warm):
            sess.update(next(batches)[0])
        secs = []
        for i in range(timed):
            res = sess.update(next(batches)[0])
            secs.append(res.seconds)
            if not res.feasible:
                _fail(f"6c {tag} batch {i} infeasible")
        res, spans = _traced(torch, lambda: sess.update(next(batches)[0]))
        _report_batch(f"6c {tag} traced batch", res)
        print(f"6c {tag} traced batch spans_ms {json.dumps(spans)}", flush=True)
        st = sess.stats()
        print(f"6c ba-16384 k=4 throughput config, {tag} churn ({nb} adds + {nb} removals): "
              f"per-update {_pcts(secs)}; view_hits {st['view_hits']}, "
              f"compact_deferred {st['compact_deferred']}, compact_calls "
              f"{st['compact_calls']}, escalations {st['escalations']}, cut {sess.cut}",
              flush=True)


def check_dynamic_group(torch, warm: int = 2, timed: int = 8) -> None:
    """Phase 6d: the reference benchmark's multi-tenant row — 4 tenants
    ba-4096 at k=4, repair_iters=2, ``4096 * 6 // 200`` random adds per
    tenant per step — as a group and as the same sessions solo; labels
    equal after every step."""
    import numpy as np
    from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig, SessionGroup
    from repro_torch.graph import barabasi_albert

    Ngt, Tn = 4096, 4
    gs = {f"t{i}": barabasi_albert(Ngt, 6, seed=20 + i) for i in range(Tn)}

    def tenants():
        return {name: PartitionSession(gi, SessionConfig(k=4, seed=i, repair_iters=2))
                for i, (name, gi) in enumerate(gs.items())}

    solo, grp = tenants(), tenants()
    group = SessionGroup(grp)
    rng = np.random.default_rng(17)
    nbt = max(Ngt * 6 // 200, 16)
    t_solo, t_grp = [], []
    for s in range(warm + timed + 1):
        batch = []
        for name in gs:
            au = rng.integers(0, Ngt, nbt)
            batch.append((name, GraphUpdate.add_edges(
                au, (au + 1 + rng.integers(0, Ngt - 1, nbt)) % Ngt)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for name, upd in batch:
            solo[name].update(upd)
        torch.cuda.synchronize()
        dt_solo = (time.perf_counter() - t) / Tn
        if s == warm + timed:
            _, spans = _traced(torch, lambda: group.update_many(batch))
            print(f"6d traced group step spans_ms {json.dumps(spans)}", flush=True)
        else:
            t = time.perf_counter()
            group.update_many(batch)
            torch.cuda.synchronize()
            dt_grp = (time.perf_counter() - t) / Tn
            if s >= warm:
                t_solo.append(dt_solo)
                t_grp.append(dt_grp)
        for name in gs:
            if not np.array_equal(solo[name].labels_np(), grp[name].labels_np()):
                _fail(f"6d step {s} tenant {name}: group and solo labels differ")
    print(f"6d {Tn} tenants ba-{Ngt} k=4, {nbt} adds each per step: group == solo after "
          f"every step; per-update solo {_pcts(t_solo)}; group (amortized) {_pcts(t_grp)}; "
          f"{json.dumps(group.stats_dict())}", flush=True)


# --------------------------------------------------------------------------
# phase 7: the deployment and fault-tolerance stack
# --------------------------------------------------------------------------

# the fields of a result that read a clock, and so differ between two runs
_CLOCK_FIELDS = ("seconds", "t_mono", "span_ms")


def _dr_stack(sess, directory: str, *, audit_cadence: int, checkpoint_every: int,
              replicas: int = 2, halo: int = 1):
    """``ReplicatedDeployment`` + ``ResilientSession`` + ``DurableSession``
    over ``sess``, checkpointing into ``directory``."""
    from repro_torch.deploy import ReplicatedDeployment
    from repro_torch.resilience import (
        DurableConfig, DurableSession, ResilientConfig, ResilientSession,
    )

    dep = ReplicatedDeployment(sess, halo=halo, replicas=replicas)
    rs = ResilientSession(sess, deployment=dep, cfg=ResilientConfig(audit_cadence=audit_cadence))
    return DurableSession(rs, DurableConfig(directory=directory,
                                            checkpoint_every=checkpoint_every))


def _digest_diff(a: dict, b: dict):
    """The first field in which two host digests differ, or None."""
    import numpy as np

    for key in a:
        if not np.array_equal(a[key], b[key]):
            return key
    return None


def _shards_diff(xs, ys):
    """The first (block, field) in which two shard lists differ, or None:
    every field of ``BlockShardNP``, arrays with their dtypes; ``ys`` may
    hold host views."""
    import dataclasses

    import numpy as np

    if len(xs) != len(ys):
        return (None, "count")
    for x, y in zip(xs, ys):
        hx = x.host()
        hy = y.host() if hasattr(y, "host") else y
        for f in dataclasses.fields(hx):
            a, b = getattr(hx, f.name), getattr(hy, f.name)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                same = (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                        and a.dtype == b.dtype and np.array_equal(a, b))
            else:
                same = a == b
            if not same:
                return (hx.block, f.name)
    return None


def _tx_key(x):
    """A ``TxResult`` as a tuple of every field but the clock's, with its
    ``UpdateResult``, ``AuditReport`` and follow-ups taken the same way."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return tuple((f.name, _tx_key(getattr(x, f.name))) for f in dataclasses.fields(x)
                     if f.name not in _CLOCK_FIELDS)
    if isinstance(x, (list, tuple)):
        return tuple(_tx_key(v) for v in x)
    return x


def _inject_7a(i: int, inj, ds):
    """Phase 7a's fault before submit ``i``: each class of the injector
    once.  Returns the fault's kind (None when there was nothing to hit)."""
    import numpy as np

    sess, dep = ds.session, ds.rs.deployment
    f = None
    if i in (1, 5, 10):
        # corruption outside a transaction: a clean version for heal()
        ds.rs.snapshots.take()
    if i == 1:
        f = inj.corrupt_labels(sess, count=2)
    elif i == 2:
        f = inj.corrupt_shard(dep, block=0)
        dep.read_block(0)                 # fails over to the audited standby
    elif i == 3:
        f = inj.lose_shard(dep, block=1)
        dep.read_block(1)
        dep.run_recovery()
    elif i == 4:
        f = inj.corrupt_replica(dep, block=2)
    elif i == 5:
        f = inj.corrupt_base_csr(sess.store, mode="endpoint")
    elif i == 6:
        f = inj.fail_next_extract(dep)
    elif i == 7:
        f = inj.fail_next_escalation(sess)
    elif i == 8:
        # the hook patches the process-global ckpt.save: fire it here, so
        # the two stacks of this process do not share one armed hook
        f = inj.fail_mid_checkpoint(ds)
        if ds.checkpoint() is not None:
            _fail("7a: the injected mid-checkpoint crash did not fire")
    elif i == 9:
        f = inj.corrupt_wal(ds)
    elif i == 10:
        # a pending overlay chunk (staged as the reference's test does),
        # then one flipped weight bit in it
        u = np.random.default_rng(9).integers(0, sess.n, 16)
        sess.store._ou.append(u.astype(np.int64))
        sess.store._ov.append(((u + 1) % sess.n).astype(np.int64))
        sess.store._ow.append(np.ones(16, np.float32))
        sess.store._olen += 16
        f = inj.bitflip_overlay(sess.store)
    return None if f is None else f.kind


def check_dr_small(torch, workdir: str, devs=("cuda", "cpu")) -> None:
    """Phase 7a: the full DR stack (2 replicas, halo 1, audit cadence 2,
    checkpoint every 4) on ba-1024 at k=4 on the card and on the CPU over
    the same mangled stream (phase 6a's edge churn and node adds, dropped,
    duplicated and swapped by the injector) with each fault class injected
    once.  Digests, transaction outcomes and every shard equal after every
    submit, after heal() and after a restore from disk."""
    import os

    import numpy as np
    from repro_torch.dynamic import PartitionSession, SessionConfig
    from repro_torch.graph import barabasi_albert
    from repro_torch.resilience import DurableSession, FaultInjector, host_digest

    g = barabasi_albert(1024, 4, seed=5)
    ups = [a for kind, a in _small_stream(g, seed=1) if kind == "update"]
    churn = churn_batches(g, np.random.default_rng(2), 24, lambda: g.n)
    ups += [next(churn)[0] for _ in range(9)]
    stacks, injs, streams = {}, {}, {}
    for d in devs:
        sess = PartitionSession(g, SessionConfig(k=4, seed=0), device=d)
        stacks[d] = _dr_stack(sess, os.path.join(workdir, f"7a_{d}"), audit_cadence=2,
                              checkpoint_every=4)
        injs[d] = FaultInjector(seed=3)
        streams[d] = injs[d].mangle_stream(ups, drop=0.1, dup=0.15, swap=0.2)
    a, b = devs
    if [s for s, _ in streams[a]] != [s for s, _ in streams[b]]:
        _fail("7a: the two injectors mangled the stream differently")

    def same(tag):
        da, db = (host_digest(stacks[d].session) for d in devs)
        key = _digest_diff(da, db)
        if key is not None:
            _fail(f"7a {tag}: card and CPU digests differ in {key}")
        diff = _shards_diff(stacks[a].rs.deployment.shards, stacks[b].rs.deployment.shards)
        if diff is not None:
            _fail(f"7a {tag}: card and CPU shards differ at {diff}")

    def heal(tag):
        reps = {d: stacks[d].heal() for d in devs}
        if not reps[a].ok or reps[a].failures != reps[b].failures:
            _fail(f"7a heal {tag}: card {reps[a].failures} vs CPU {reps[b].failures}")
        same(f"heal {tag}")

    same("start")
    kinds = []
    for i, (seq, upd) in enumerate(streams[a]):
        txs = {}
        for d in devs:
            kind = _inject_7a(i, injs[d], stacks[d])
            txs[d] = stacks[d].submit(upd, seq=seq)
        kinds.append(kind)
        if _tx_key(txs[a]) != _tx_key(txs[b]):
            _fail(f"7a submit {i}: card {_tx_key(txs[a])} vs CPU {_tx_key(txs[b])}")
        same(f"submit {i}")
        if kind in ("corrupt_labels", "corrupt_base_csr", "bitflip_overlay"):
            heal(f"after {kind}")   # corruption outside a transaction
    heal("final")
    st = {d: stacks[d].stats() for d in devs}
    keys = ("tx_committed", "tx_rollbacks", "tx_retries", "tx_quarantined",
            "tx_duplicates_dropped", "tx_lost", "failovers", "failover_misses",
            "dr_checkpoints_written", "dr_failed_checkpoints", "failed_migrations")
    if any(st[a][k_] != st[b][k_] for k_ in keys):
        _fail(f"7a stats differ: {[(k_, st[a][k_], st[b][k_]) for k_ in keys]}")
    for d in devs:
        injs[d].disarm()
        stacks[d], _ = DurableSession.restore(os.path.join(workdir, f"7a_{d}"), device=d)
    same("restore")
    if not stacks[a].session.labels.is_cuda and a == "cuda":
        _fail("7a: the restored card stack is not on the card")
    print(f"7a DR stack ba-1024 k=4 ({len(streams[a])} mangled submits, faults "
          f"{[k_ for k_ in kinds if k_]}): card == cpu after every submit, heal and "
          f"restore; " + json.dumps({k_: st[a][k_] for k_ in keys}), flush=True)


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def time_dr_programs(torch, sess, dep) -> dict:
    """Times (ms) of the deploy and audit device programs at the serving
    stack's own shapes: block 0's hop layering and extraction, the CSR
    audit of the store's base, the label audit, and block 0's owned-arc
    checksum and ghost-owner audit.  CUDA events on the card."""
    from repro_torch.deploy.extract import _shard_extract, _shard_masks
    from repro_torch.resilience.audit import (
        _csr_audit, _ghost_owner_audit, _labels_audit, _shard_owned_chk,
    )

    gd = sess.store.graph()
    ex = dep.extractor
    lab = ex._labels_nb(gd, sess.labels, sess.k)
    s = dep.shards[0]
    hop, _ = _shard_masks(lab, gd.src, gd.indices, gd.indptr, 0, gd.n, dep.halo)
    # name -> (program, the tensors it reads)
    fns = dict(
        shard_masks=(lambda: _shard_masks(lab, gd.src, gd.indices, gd.indptr, 0, gd.n,
                                          dep.halo), [lab, gd.src, gd.indices, gd.indptr]),
        shard_extract=(lambda: _shard_extract(
            hop, lab, gd.indptr, gd.indices, gd.ew, gd.nw, gd.n, dep.halo, s.n_own,
            s.n_ghost, s.n_rows, Ob=s.own_g.shape[0], Gb=s.ghost_g.shape[0],
            Eb=s.indices.shape[0]), [hop, lab, gd.indptr, gd.indices, gd.ew, gd.nw]),
        csr_audit=(lambda: _csr_audit(gd.indptr, gd.src, gd.indices, gd.ew, gd.nw, gd.n, gd.m),
                   [gd.indptr, gd.src, gd.indices, gd.ew, gd.nw]),
        labels_audit=(lambda: _labels_audit(sess.labels, sess.n, sess.k), [sess.labels]),
        shard_owned_chk=(lambda: _shard_owned_chk(s.own_g, s.ghost_g, s.indptr, s.indices,
                                                  s.ew, s.n_own, s.m_local),
                         [s.own_g, s.ghost_g, s.indptr, s.indices, s.ew]),
        ghost_owner_audit=(lambda: _ghost_owner_audit(s.ghost_g, s.ghost_block_dev,
                                                      sess.labels, s.n_ghost),
                           [s.ghost_g, s.ghost_block_dev, sess.labels]),
    )
    out = {name: _time_ms(fn, torch, warmup=1, batches=3, reps=3)
           for name, (fn, _) in fns.items()}
    shapes = dict(Nb=gd.indptr.shape[0] - 1, Mb=gd.indices.shape[0], Ob=s.own_g.shape[0],
                  Gb=s.ghost_g.shape[0], Eb=s.indices.shape[0], A=sess.labels.shape[0])
    print(f"7b DR device programs (block 0, {json.dumps(shapes)}), ms: "
          f"{json.dumps({k_: round(v, 4) for k_, v in out.items()})}", flush=True)
    bounds = {name: _io_bound(fn, ins) for name, (fn, ins) in fns.items()}
    print("7b DR device programs' bounds (inputs read once, results written once, at 3.35 "
          "TB/s) and the counter's unfused per-op bytes: " + json.dumps(bounds), flush=True)
    return out


def check_dr_full(torch, sess, g, workdir: str, partition_s: float, warm: int = 2,
                  timed: int = 8) -> dict:
    """Phase 7b: phase 6b's session (rmat(19, 16) without isolated nodes,
    k=16, dense refinement) inside the full DR stack (2 replicas, halo 1,
    audit cadence 8, checkpoint every 4) under 6b's 0.1 % churn.  Checks
    shard parity with the numpy oracle, reassembly, the ghost exchange and
    the comm metrics; times the commits, one audit pass and one
    checkpoint; then corrupt_shard/lose_shard with failover, corrupt_labels
    with heal(), one forced escalation (lp_score_rows launches), and a
    restore from disk whose digest must equal the live one."""
    import gc
    import os

    import numpy as np
    from repro_torch.deploy import (
        block_comm_metrics_np, extract_blocks_numpy, ghost_exchange_numpy, reassemble,
        shard_comm_metrics,
    )
    from repro_torch.kernels.lp_score import lp_score_rows
    from repro_torch.resilience import DurableSession, FaultInjector, host_digest

    k = sess.k
    directory = os.path.join(workdir, "7b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ds = _dr_stack(sess, directory, audit_cadence=8, checkpoint_every=4)
    torch.cuda.synchronize()
    dep, rs = ds.rs.deployment, ds.rs
    print(f"7b DR stack on n={sess.n}, m={sess.store.m}, k={k}: built in "
          f"{time.perf_counter() - t:.3f} s (16 shards x 2 replicas + first checkpoint)",
          flush=True)

    # ---- shard parity, reassembly, ghost exchange, comm metrics
    t = time.perf_counter()
    gh, lab = sess.store.csr_host(), sess.labels_np()
    oracle = extract_blocks_numpy(gh, lab, k, halo=1)
    diff = _shards_diff(dep.shards, oracle)
    if diff is not None:
        _fail(f"7b shard {diff} differs from extract_blocks_numpy")
    g2 = reassemble(dep.shards, sess.n)
    for f in ("indptr", "indices", "ew", "nw"):
        if not np.array_equal(getattr(g2, f), getattr(gh, f)):
            _fail(f"7b reassemble differs from the store's CSR in {f}")
    payload = np.random.default_rng(3).integers(0, 10**6, sess.n)
    for vals in (lab, payload):
        for s, r in zip(dep.shards, ghost_exchange_numpy(dep.shards, vals)):
            if not np.array_equal(r, vals[s.ghost_global_np()]):
                _fail(f"7b ghost exchange of block {s.block} does not round-trip")
    m_sh, m_lab = shard_comm_metrics(dep.shards), block_comm_metrics_np(gh, lab, k)
    if m_sh["total_volume"] != m_lab["total_volume"]:
        _fail(f"7b comm volume {m_sh['total_volume']} vs {m_lab['total_volume']}")
    sizes = [(s.n_own, s.n_ghost, s.m_local) for s in dep.shards]
    print(f"7b {k} shards == extract_blocks_numpy bit for bit, reassemble == store CSR, "
          f"ghost exchange round-trips, comm volume {m_sh['total_volume']} == label view "
          f"({time.perf_counter() - t:.1f} s of host checks); (n_own, n_ghost, m_local) "
          f"min {min(sizes)} max {max(sizes)}", flush=True)

    # ---- the commit path under 6b's churn
    nb = g.m // 2 // 1000
    batches = churn_batches(g, np.random.default_rng(31), nb, lambda: sess.n)
    secs, split = [], {}
    for i in range(warm + timed):
        upd = next(batches)[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i >= warm:
            tx, spans = _traced(torch, lambda: ds.submit(upd, seq=rs._expected_seq))
            for k_, v in spans.items():
                split[k_] = split.get(k_, 0.0) + v
        else:
            tx = ds.submit(upd, seq=rs._expected_seq)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not tx.committed or not tx.result.feasible:
            _fail(f"7b submit {i}: committed {tx.committed}, reason {tx.reason}")
        if i >= warm:
            secs.append(dt)
    top = ("resilience.snapshot", "session.update", "resilience.audit", "deploy.migrate",
           "deploy.replicas", "wal.fsync", "checkpoint.write")
    print(f"7b per-commit seconds over {len(secs)} timed submits ({nb} adds + {nb} "
          f"removals each, tracer on): {_pcts(secs)}", flush=True)
    print(f"7b commit split over the timed submits, ms: "
          f"{json.dumps({k_: round(split.get(k_, 0.0), 3) for k_ in top})}; all spans "
          f"{json.dumps({k_: round(v, 3) for k_, v in sorted(split.items())})}", flush=True)
    st = ds.stats()
    print(f"7b stats " + json.dumps({k_: st[k_] for k_ in (
        "tx_committed", "audits", "failed_audits", "full_rebuilds", "blocks_patched_total",
        "dr_checkpoints_written", "replica_refreshes", "escalations")}), flush=True)

    # ---- one audit pass, one checkpoint
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = rs.auditor.audit()
    audit_ms = (time.perf_counter() - t) * 1e3
    if not rep.ok:
        _fail(f"7b audit failed: {rep.failures}")
    t = time.perf_counter()
    step = ds.checkpoint()
    ckpt_s = time.perf_counter() - t
    if step is None:
        _fail(f"7b checkpoint failed: {ds.last_checkpoint_error!r}")
    ckpt_bytes = _dir_bytes(os.path.join(directory, f"step_{step:08d}"))
    print(f"7b one audit pass ({len(rep.checked)} checks): {audit_ms:.3f} ms; one "
          f"checkpoint: {ckpt_s:.3f} s, {ckpt_bytes} bytes", flush=True)
    programs = time_dr_programs(torch, sess, dep)

    # ---- faults: failover, recovery, heal
    inj = FaultInjector(seed=5)
    inj.corrupt_shard(dep, block=3)
    t = time.perf_counter()
    s = dep.read_block(3)
    fo_s = time.perf_counter() - t
    if dep.failovers != 1 or not dep.verify_shard(3, s) or dep.recovery_pending != {3}:
        _fail(f"7b corrupt_shard: failovers {dep.failovers}, pending {dep.recovery_pending}")
    dep.run_recovery()
    inj.lose_shard(dep, block=5)
    dep.read_block(5)
    t = time.perf_counter()
    dep.run_recovery()
    rec_s = time.perf_counter() - t
    if dep.shards[5] is None or not dep.verify_shard(5, dep.shards[5]) or dep.failovers != 2:
        _fail("7b lose_shard: block 5 not recovered")
    before = host_digest(sess)
    rs.snapshots.take()
    inj.corrupt_labels(sess, count=8)
    t = time.perf_counter()
    hrep = ds.heal()
    heal_s = time.perf_counter() - t
    key = _digest_diff(host_digest(sess), before)
    if not hrep.ok or key is not None:
        _fail(f"7b heal after corrupt_labels: ok {hrep.ok}, digest differs in {key}")
    print(f"7b corrupt_shard -> read_block served the audited standby in {fo_s:.4f} s; "
          f"lose_shard -> failover, run_recovery {rec_s:.3f} s; corrupt_labels -> heal() "
          f"{heal_s:.3f} s, digest == pre-fault", flush=True)

    # ---- one forced escalation through the transactional path
    upd = next(batches)[0]
    sess.cfg.escalate_cut_ratio = 0.0
    torch.cuda.synchronize()
    before = lp_score_rows.launches
    t = time.perf_counter()
    tx = ds.submit(upd, seq=rs._expected_seq)
    torch.cuda.synchronize()
    esc_s = time.perf_counter() - t
    esc_launches = lp_score_rows.launches - before
    sess.cfg.escalate_cut_ratio = 1.6
    if not tx.committed or not tx.result.escalated:
        _fail(f"7b forced escalation: committed {tx.committed}, escalated "
              f"{tx.result.escalated if tx.result else None}")
    if esc_launches <= 0:
        _fail("7b: the escalation never launched lp_score_rows")
    print(f"7b forced escalation through ResilientSession: {esc_s:.3f} s, "
          f"lp_score_rows launches {esc_launches}, cut {tx.result.cut}", flush=True)

    # ---- restore from disk: checkpoint after the escalation (its replay
    # would need the forced ratio), two WAL records past it
    if ds.checkpoint() is None:
        _fail(f"7b checkpoint after the escalation failed: {ds.last_checkpoint_error!r}")
    for _ in range(2):
        tx = ds.submit(next(batches)[0], seq=rs._expected_seq)
        if not tx.committed:
            _fail(f"7b submit before restore: {tx.reason}")
    live = host_digest(sess)
    cfg = sess.cfg
    peak = torch.cuda.max_memory_allocated()
    ds.close()
    del ds, dep, rs, sess, tx, s
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ds2, rrep = DurableSession.restore(directory, session_cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    key = _digest_diff(host_digest(ds2.session), live)
    if key is not None:
        _fail(f"7b restore: digest differs from the live one in {key}")
    print(f"7b restore: {restore_s:.3f} s (checkpoint step {rrep.checkpoint_step}, "
          f"{rrep.records_replayed} WAL records replayed, shards re-extracted) against "
          f"phase 4's partition() {partition_s:.3f} s; digest == live; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del ds2
    gc.collect()
    return dict(secs=secs, split=split, audit_ms=audit_ms, ckpt_s=ckpt_s,
                ckpt_bytes=ckpt_bytes, programs=programs, esc_launches=esc_launches,
                restore_s=restore_s, peak=peak)


def check_deploy_hot(torch, warm: int = 2, timed: int = 3) -> None:
    """Phase 7c: the reference benchmark's ``deploy_hot`` — pp-16384 at k=8,
    halo 1: all k shards extracted on the device against
    ``extract_blocks_numpy`` (parity asserted), then per-batch incremental
    migration under ~1 % churn inside one block's interior against a full
    re-extraction (min of ``timed``)."""
    import numpy as np
    from repro_torch.deploy import ShardDeployment, extract_blocks_numpy
    from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
    from repro_torch.graph import planted_partition

    g = planted_partition(16384, 16, p_in=0.01, p_out=0.00002, seed=4)
    k = 8
    sess = PartitionSession(g, SessionConfig(k=k, seed=0), device="cuda")
    dep = ShardDeployment(sess, halo=1)
    ex = dep.extractor
    gh, lab = sess.store.csr_host(), sess.labels_np()
    diff = _shards_diff(dep.shards, extract_blocks_numpy(gh, lab, k, halo=1))
    if diff is not None:
        _fail(f"7c shard {diff} differs from extract_blocks_numpy")
    t_dev, t_np = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.extract(sess.store.graph(), sess.labels, k, halo=1)
        torch.cuda.synchronize()
        t_dev.append(time.perf_counter() - t)
        t = time.perf_counter()
        extract_blocks_numpy(gh, lab, k, halo=1)
        t_np.append(time.perf_counter() - t)
    rng = np.random.default_rng(11)
    nb = max(g.m // 2 // 200, 64)

    def one_batch():
        lab_ = sess.labels_np()
        gh_ = sess.store.csr_host()
        src = gh_.arc_sources()
        bnd = np.zeros(gh_.n, bool)
        bnd[src[lab_[src] != lab_[gh_.indices]]] = True
        b = int(np.argmax(np.bincount(lab_[~bnd], minlength=k)))
        ids = np.flatnonzero((lab_ == b) & ~bnd)
        m = min(nb, ids.size // 2)
        au, av = rng.choice(ids, m), rng.choice(ids, m)
        keep = au != av
        inb = (lab_[src] == b) & (lab_[gh_.indices] == b) & ~bnd[src] \
            & ~bnd[gh_.indices] & (src < gh_.indices)
        cand = rng.permutation(np.flatnonzero(inb))[:m]
        return dep.update(GraphUpdate.add_edges(au[keep], av[keep]).merged(
            GraphUpdate.remove_edges(src[cand], gh_.indices[cand])))

    for _ in range(warm):
        one_batch()
    t_mig, t_full, patched = [], [], []
    for _ in range(timed):
        _, delta = one_batch()
        t_mig.append(delta.seconds)
        patched.append(int(delta.blocks_patched.size))
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.extract(sess.store.graph(), sess.labels, k, halo=1)
        torch.cuda.synchronize()
        t_full.append(time.perf_counter() - t)
    diff = _shards_diff(dep.shards, extract_blocks_numpy(
        sess.store.csr_host(), sess.labels_np(), k, halo=1))
    if diff is not None:
        _fail(f"7c shard {diff} differs from the oracle after migration")
    st = dep.stats()
    print(f"7c deploy_hot pp-16384 k=8 halo 1 (m={g.m}): extract all {k} shards on the "
          f"device {min(t_dev) * 1e3:.3f} ms vs extract_blocks_numpy {min(t_np) * 1e3:.3f} ms "
          f"(parity asserted); migration under {2 * nb} churned edges in one block "
          f"{min(t_mig) * 1e3:.3f} ms vs full re-extraction {min(t_full) * 1e3:.3f} ms "
          f"(blocks patched {patched}, full_rebuilds {st['full_rebuilds']}, "
          f"deploy_bucket_count {st['deploy_bucket_count']})", flush=True)


def check_resilience_dr(torch, workdir: str, cadence: int = 8) -> None:
    """Phase 7d: the reference benchmark's ``resilience_dr`` — ba-16384 at
    k=4, audit cadence 8: transactional submits without (bare
    ``ResilientSession``) and with the DR stack (2 replicas, fsynced WAL),
    one checkpoint, a restore (checkpoint_every = 4 WAL records replayed)
    against a fresh ``partition()``, and a standby failover against
    ``recover_block``."""
    import os

    import numpy as np
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
    from repro_torch.graph import barabasi_albert
    from repro_torch.resilience import (
        DurableSession, FaultInjector, ResilientConfig, ResilientSession, host_digest,
    )

    g = barabasi_albert(16384, 6, seed=3)
    k, ckpt_every = 4, 4
    directory = os.path.join(workdir, "7d")
    bare = ResilientSession(PartitionSession(g, SessionConfig(k=k, seed=0), device="cuda"),
                            cfg=ResilientConfig(audit_cadence=cadence))
    ds = _dr_stack(PartitionSession(g, SessionConfig(k=k, seed=0), device="cuda"), directory,
                   audit_cadence=cadence, checkpoint_every=1 << 30)
    nb = max(g.m // 2 // 200, 64)
    rng = np.random.default_rng(11)

    def batch():
        au = rng.integers(0, g.n, nb)
        return GraphUpdate.add_edges(au, (au + 1 + rng.integers(0, g.n - 1, nb)) % g.n)

    per = {}
    for name, submit in (("bare", bare.submit), ("durable", ds.submit)):
        for _ in range(cadence):           # warm
            submit(batch())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(cadence):
            submit(batch())
        torch.cuda.synchronize()
        per[name] = (time.perf_counter() - t) / cadence
    t_ck = []
    for _ in range(2):
        t = time.perf_counter()
        if ds.checkpoint() is None:
            _fail(f"7d checkpoint failed: {ds.last_checkpoint_error!r}")
        t_ck.append(time.perf_counter() - t)
    for _ in range(ckpt_every):
        ds.submit(batch())
    live = host_digest(ds.session)
    t = time.perf_counter()
    ds2, rep = DurableSession.restore(directory, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    key = _digest_diff(host_digest(ds2.session), live)
    if key is not None or rep.records_replayed != ckpt_every:
        _fail(f"7d restore: digest differs in {key}, replayed {rep.records_replayed}")
    del ds2
    t = time.perf_counter()
    partition(ds.session.store.csr_host(), PartitionerConfig(k=k, preset="fast", seed=0),
              device="cuda")
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t
    dep = ds.rs.deployment
    inj = FaultInjector(seed=1)
    t_fo, t_rec = [], []
    for _ in range(2):
        inj.corrupt_shard(dep, block=0)
        t = time.perf_counter()
        if dep.read_block(0) is None:
            _fail("7d failover served no shard")
        t_fo.append(time.perf_counter() - t)
        dep.run_recovery()
        t = time.perf_counter()
        dep.recover_block(0)
        t_rec.append(time.perf_counter() - t)
    print(f"7d resilience_dr ba-16384 k=4 ({nb} adds per update, audit cadence {cadence}): "
          f"submit per update without the DR stack {per['bare'] * 1e3:.3f} ms, with it "
          f"(2 replicas + fsynced WAL) {per['durable'] * 1e3:.3f} ms; one checkpoint "
          f"{min(t_ck):.3f} s; restore ({rep.records_replayed} records replayed) "
          f"{restore_s:.3f} s vs fresh partition() {part_s:.3f} s; failover read "
          f"{min(t_fo) * 1e3:.3f} ms vs recover_block {min(t_rec) * 1e3:.3f} ms "
          f"(failovers {dep.failovers})", flush=True)
    ds.close()


# --------------------------------------------------------------------------
# phase 8: the distributed path (engine="dist") and the island-sharded GA
# --------------------------------------------------------------------------


def _dist_cfg(**kw):
    from repro_torch.core import PartitionerConfig

    return PartitionerConfig(engine="dist", dist_shards=8, preset="minimal", seed=0, **kw)


def _noisy_halves(side: int):
    """mesh2d(side)'s two halves with 15 % of the labels flipped (the
    reference's distributed refinement test input)."""
    import numpy as np

    lab = (np.arange(side * side) // side >= side // 2).astype(np.int32)
    lab[np.random.default_rng(0).random(side * side) < 0.15] ^= 1
    return lab


def check_dist_small(torch, devs=("cuda", "cpu")) -> None:
    """Phase 8a (sweeps): the distributed clustering (rmat(12, 8)) and
    refinement (noisy mesh2d(64)) sweeps on 8 PEs, the distributed
    contraction, and partition(engine="dist", dist_shards=8) on ba-8192 at
    k=2 give the same result with every PE on the card as on the CPU."""
    import numpy as np
    from repro_torch.core import contract, partition
    from repro_torch.core.distributed_lp import (
        build_plan, contract_distributed, lp_cluster_distributed, lp_refine_distributed,
    )
    from repro_torch.core.metrics import lmax
    from repro_torch.graph import barabasi_albert, mesh2d, rmat

    a, b = devs
    g = rmat(12, 8, seed=2)
    plan = build_plan(g, 8, chunks_per_shard=4)
    clus = {d: lp_cluster_distributed(plan, U=lmax(g.n, 2, 0.03) / 14, iters=3, seed=1,
                                      devices=[d]) for d in devs}
    if not np.array_equal(clus[a], clus[b]):
        _fail(f"8a: distributed clustering differs in {int((clus[a] != clus[b]).sum())} labels")
    gm = mesh2d(64)
    planm = build_plan(gm, 8, chunks_per_shard=4, order="random")
    ref = {d: lp_refine_distributed(planm, _noisy_halves(64), k=2, U=lmax(gm.n, 2, 0.03),
                                    iters=6, seed=0, devices=[d]) for d in devs}
    if not np.array_equal(ref[a], ref[b]):
        _fail(f"8a: distributed refinement differs in {int((ref[a] != ref[b]).sum())} labels")
    host, C_host = contract(g, clus[a])
    for d in devs:
        coarse, C = contract_distributed(plan, clus[a], devices=[d])
        if not (np.array_equal(C, C_host) and all(
                np.array_equal(getattr(coarse, f), getattr(host, f))
                for f in ("indptr", "indices", "ew", "nw"))):
            _fail(f"8a: contract_distributed on {d} differs from the host contract")
    gb = barabasi_albert(8192, 6, seed=3)
    reps = {d: partition(gb, _dist_cfg(k=2, coarsest_factor=100), device=d) for d in devs}
    ra, rb = reps[a], reps[b]
    if not (np.array_equal(ra.labels, rb.labels) and ra.cut == rb.cut
            and ra.level_sizes == rb.level_sizes and ra.cycle_cuts == rb.cycle_cuts):
        _fail(f"8a: partition(engine='dist') differs: cut {ra.cut} vs {rb.cut}, levels "
              f"{ra.level_sizes} vs {rb.level_sizes}")
    print(f"8a dist sweeps rmat(12, 8) P=8 ({np.unique(clus[a]).size} clusters), mesh2d(64) "
          f"refine, contract_distributed == host contract, partition(engine='dist') ba-8192 "
          f"k=2 (cut {ra.cut}, levels {ra.level_sizes}): {a} == {b}", flush=True)


def check_sharded_ga_small(torch) -> None:
    """Phase 8a (GA): the batched GA with its 4 islands split over
    ``["cuda"] * 2`` and ``["cuda"] * 4`` gives the unsharded GA's labels
    on the card: the reference's sharding test case (planted_partition(600),
    k=2, 3 generations) and one whose result depends on the gossip crossing
    shards (barabasi_albert(1000, 3), k=4, 4 generations)."""
    from repro_torch.core import LPEngine
    from repro_torch.core.evolutionary import EvoConfig
    from repro_torch.core.metrics import lmax
    from repro_torch.graph import barabasi_albert, planted_partition

    cases = (("planted_partition(600)", planted_partition(600, 6, p_in=0.05, p_out=0.004,
                                                          seed=1), 2, 3),
             ("barabasi_albert(1000, 3)", barabasi_albert(1000, 3, seed=2), 4, 4))
    for name, g, k, gens in cases:
        cfg = EvoConfig(k=k, Lmax=lmax(g.n, k, 0.03), islands=4, pop_per_island=2,
                        generations=gens, refine_iters=3, seed=5)
        single = LPEngine(g, seed=0, device="cuda").evolve_device(g, cfg)
        for D in (2, 4):
            sharded = LPEngine(g, seed=0, device="cuda").evolve_device(
                g, cfg, shard=True, devices=["cuda"] * D)
            if not torch.equal(sharded, single):
                _fail(f"8a: the GA on {name} sharded over [cuda] * {D} differs from the "
                      f"unsharded GA in {int((sharded != single).sum())} labels")
        print(f"8a GA 4x2, {gens} generations, {name} k={k}: sharded over [cuda] * 2 "
              f"and * 4 == unsharded", flush=True)


class _Counted:
    """Counts the calls of a module function while installed, keeps the
    first call's arguments (and ``keep(args, kwargs)`` of every call in
    ``kept``), and records CUDA events around each, for the per-call device
    time."""

    def __init__(self, torch, module, name: str, timed: bool = False, keep=None):
        self.torch, self.module, self.name = torch, module, name
        self.fn = getattr(module, name)
        self.calls, self.events, self.timed = 0, [], timed
        self.first, self.keep, self.kept = None, keep, []

    def __enter__(self):
        def wrapper(*a, **kw):
            self.calls += 1
            if self.first is None:
                self.first = (a, kw)
            if self.keep is not None:
                self.kept.append(self.keep(a, kw))
            if not self.timed:
                return self.fn(*a, **kw)
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.fn(*a, **kw)
            ev[1].record()
            self.events.append(ev)
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _dist_breakdown(tracer, seconds: float) -> dict:
    """Seconds of a dist partition() by span: host planning and the sweeps
    by mode, the rest of the coarsening (host contraction, numpy levels)
    and of the refinement (guard, numpy levels), the host GA and the
    finish (balance repair, final cut)."""
    sums = {}
    for ev in tracer.events:
        a = ev.get("args", {})
        key = {"dist.plan": f"dist.plan.{a.get('order')}",
               "dist.sweep": f"dist.sweep.{a.get('mode')}",
               "vcycle.host": f"host.{a.get('phase')}"}.get(ev["name"], ev["name"])
        sums[key] = sums.get(key, 0.0) + ev["dur"] / 1e6
    out = {
        "plan_degree": sums.get("dist.plan.degree", 0.0),
        "sweep_cluster": sums.get("dist.sweep.cluster", 0.0),
        "plan_random": sums.get("dist.plan.random", 0.0),
        "sweep_refine": sums.get("dist.sweep.refine", 0.0),
        "evolve_host": sums.get("vcycle.evolve", 0.0),
        "finish": sums.get("vcycle.finish", 0.0),
    }
    # the spans of one level nest in its vcycle.host span
    out["coarsen_other"] = (sums.get("host.coarsen", 0.0) - out["plan_degree"]
                            - out["sweep_cluster"])
    out["refine_other"] = (sums.get("host.refine", 0.0) - out["plan_random"]
                           - out["sweep_refine"])
    out["other"] = seconds - sum(out.values())
    return out


def check_dist_full(torch, g, phase4_cut: float, out_dir: Path) -> dict:
    """Phase 8b: partition(engine="dist", dist_shards=8, preset="minimal",
    coarsest_factor=100, seed=0) at k=16 on the phase-4 graph, all 8 PEs on
    the card: feasible, below the hash cut.  Prints the run's seconds and
    level sizes, each PE's shard sizes, the synchronized times of
    build_plan (host), one clustering and one refinement on the finest
    graph, the CUDA-event times of one phase's per-PE program and of one
    exchange, contract_distributed against the host contract (equal, both
    timed), the sharded GA's generation step on the full graph against the
    unsharded one (equal labels), and the peak device memory.  The run's
    span trace goes to ``out_dir``."""
    import numpy as np
    import repro_torch.core.distributed_lp as TD
    import repro_torch.core.engine as TE
    from repro_torch.core import LPEngine, contract, hash_partition, partition
    from repro_torch.core.evolutionary import EvoConfig
    from repro_torch.core.metrics import cut_np, lmax
    from repro_torch.kernels.lp_score import lp_score_rows
    from repro_torch.kernels.lp_score.threefry import fold_in, prng_key, split
    from repro_torch.launch import make_mesh
    from repro_torch.obs import Tracer, set_tracer

    k = 16
    cfg = _dist_cfg(k=k, coarsest_factor=100)
    L = lmax(float(g.nw.sum()), k, cfg.eps)
    hash_cut = cut_np(g, hash_partition(g.n, k))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lp_score_rows.launches = 0
    tracer = Tracer()
    set_tracer(tracer)
    with _Counted(torch, TD, "shard_phase") as ph, _Counted(torch, TD, "exchange") as ex:
        t = time.perf_counter()
        rep = partition(g, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    set_tracer(None)
    peak_run = torch.cuda.max_memory_allocated()
    out_dir.mkdir(parents=True, exist_ok=True)
    tracer.export_chrome(str(out_dir / "chip_smoke_trace_dist.json"))
    print(f"8b partition(engine='dist', dist_shards=8, minimal) k={k} on n={g.n}, m={g.m}: "
          f"{wall:.3f} s, cut {rep.cut} ({rep.cut / hash_cut:.4f} of hash cut {hash_cut}, "
          f"{rep.cut / phase4_cut:.4f} of phase 4's {phase4_cut}), imbalance "
          f"{rep.imbalance:.5f}, feasible {rep.feasible}", flush=True)
    print(f"8b level_sizes {rep.level_sizes}; shard_phase calls {ph.calls}, exchanges "
          f"{ex.calls}, lp_score_rows launches {lp_score_rows.launches}, evo_calls "
          f"{rep.engine_stats['evo_calls']}; peak device memory {peak_run / 2**30:.3f} GiB",
          flush=True)
    print("8b breakdown_s " + json.dumps(
        {k_: round(v, 4) for k_, v in _dist_breakdown(tracer, rep.seconds).items()}),
        flush=True)
    if not rep.feasible or rep.imbalance > cfg.eps + 1e-9:
        _fail(f"8b: infeasible partition, imbalance {rep.imbalance}")
    if not rep.cut < hash_cut:
        _fail(f"8b: cut {rep.cut} not below the hash partition's {hash_cut}")
    if ph.calls == 0 or ex.calls == 0:
        _fail("8b: the run made no distributed sweep")

    # ---- the finest level's plan, sweeps and contraction, one at a time
    t = time.perf_counter()
    plan = TD._build_plan_impl(g, 8, cfg.dist_chunks_per_shard, "degree", cfg.seed)
    plan_s = time.perf_counter() - t
    sg = plan.sg
    print("8b shards (PE: n_local, n_ghost, n_iface, m_local): " + json.dumps(
        {p: [int(sg.n_local[p]), int(sg.n_ghost[p]), int(sg.n_iface[p]), int(sg.m_local[p])]
         for p in range(8)}) + f"; chunk layout (P, C, Nc, Ec) {list(plan.ch_nodes.shape)}"
        f" + [{plan.ch_edge_dst.shape[2]}]; build_plan (host) {plan_s:.3f} s", flush=True)
    U = max(float(g.nw.max()), L / cfg.f_social)
    torch.cuda.synchronize()
    t = time.perf_counter()
    clus = TD.lp_cluster_distributed(plan, U=U, iters=cfg.lp_iters_coarsen, seed=1)
    cluster_s = time.perf_counter() - t
    plan_r = TD._build_plan_impl(g, 8, cfg.dist_chunks_per_shard, "random", cfg.seed)
    t = time.perf_counter()
    TD.lp_refine_distributed(plan_r, rep.labels, k=k, U=L, iters=cfg.lp_iters_refine,
                             seed=1)
    refine_s = time.perf_counter() - t
    C = plan.ch_nodes.shape[1]
    print(f"8b one lp_cluster_distributed {cluster_s:.3f} s ({cfg.lp_iters_coarsen * C} "
          f"phases, {np.unique(clus).size} clusters), one lp_refine_distributed "
          f"{refine_s:.3f} s ({cfg.lp_iters_refine * plan_r.ch_nodes.shape[1]} phases)",
          flush=True)

    # one phase's per-PE program (PE 0, chunk 0) and one exchange, CUDA events
    mesh = make_mesh(8)
    shards = TD.upload_plan(plan, mesh)
    ll0, lg0 = TD._initial_labels(sg, None)
    lls = [torch.from_numpy(ll0[p]).to(mesh[p]) for p in range(8)]
    lgs = [torch.from_numpy(lg0[p]).to(mesh[p]) for p in range(8)]
    _, sub = split(fold_in(prng_key(1), 0))
    prog = {f"shard_phase_cluster_pe{p}": _time_ms(
        lambda p=p: TD.shard_phase(shards[p], 0, lls[p], lgs[p], sub, U), torch,
        warmup=1, batches=3, reps=3) for p in (0, 7)}
    ll_r, lg_r = TD._initial_labels(sg, rep.labels)
    lls_r = [torch.from_numpy(ll_r[p]).to(mesh[p]) for p in range(8)]
    lgs_r = [torch.from_numpy(lg_r[p]).to(mesh[p]) for p in range(8)]
    tw = torch.stack([TD.block_weights(st, ll, k) for st, ll in zip(shards, lls_r)]).sum(0)
    tw[k] = float("inf")
    prog["shard_phase_refine_pe0"] = _time_ms(
        lambda: TD.shard_phase(shards[0], 0, lls_r[0], lgs_r[0], sub, L, tw, k), torch,
        warmup=1, batches=3, reps=3)
    prog["exchange"] = _time_ms(lambda: TD.exchange(shards, lls, lgs), torch,
                                warmup=1, batches=3, reps=3)
    print("8b device programs at the finest level's shapes (CUDA events), ms: "
          + json.dumps({k_: round(v, 4) for k_, v in prog.items()}), flush=True)
    bounds = {
        "shard_phase_cluster_pe0": _io_bound(
            lambda: TD.shard_phase(shards[0], 0, lls[0], lgs[0], sub, U),
            _phase_inputs(shards[0], 0, lls[0], lgs[0])),
        "shard_phase_refine_pe0": _io_bound(
            lambda: TD.shard_phase(shards[0], 0, lls_r[0], lgs_r[0], sub, L, tw, k),
            _phase_inputs(shards[0], 0, lls_r[0], lgs_r[0], tw)),
        "exchange": _io_bound(
            lambda: TD.exchange(shards, lls, lgs),
            [[st.iface_nodes, st.ghost_owner, st.ghost_slot, st.ghost_valid] for st in shards]
            + lls + lgs),
    }
    print("8b bounds (inputs read once, results written once, at 3.35 TB/s) and the "
          "counter's unfused per-op bytes: " + json.dumps(bounds), flush=True)
    del shards, lls, lgs, lls_r, lgs_r

    # ---- contract_distributed against the host contract
    torch.cuda.synchronize()
    with _Counted(torch, TD, "_shard_quotient", timed=True) as q:
        t = time.perf_counter()
        coarse, C_map = TD.contract_distributed(plan, clus)
        dist_s = time.perf_counter() - t
    t = time.perf_counter()
    host, C_host = contract(g, clus)
    host_s = time.perf_counter() - t
    if not (np.array_equal(C_map, C_host) and all(
            np.array_equal(getattr(coarse, f), getattr(host, f))
            for f in ("indptr", "indices", "ew", "nw"))):
        _fail("8b: contract_distributed differs from the host contract")
    q_ms = q.ms()
    a, kw = q.first
    qb = _io_bound(lambda: TD._shard_quotient(*a, **kw), (a, kw))
    print(f"8b contract_distributed == host contract (n_c={coarse.n}, m_c={coarse.m}): "
          f"{dist_s:.3f} s (per-PE device programs {sum(q_ms):.3f} ms in all, max "
          f"{max(q_ms):.3f} ms; PE 0's {q_ms[0]:.3f} ms against its bound "
          f"{json.dumps(qb)}) vs host {host_s:.3f} s", flush=True)
    del plan, plan_r

    # ---- the sharded GA's generation step at full width (Ab = 2^19)
    ga = EvoConfig(k=k, Lmax=L, islands=2, pop_per_island=2, generations=2,
                   refine_iters=6, seed=7, seed_individuals=[rep.labels])
    labs, steps = {}, {}
    for name, kw in (("unsharded", {}), ("sharded", dict(shard=True, devices=["cuda:0"] * 2))):
        eng = LPEngine(g, seed=0)
        eng._evo_arrays(g)
        with _Counted(torch, TE, "evo_generation_step_sharded", timed=True) as st:
            labs[name] = eng.evolve_device(g, ga, **kw)
        steps[name] = st.ms()
        if st.calls != ga.generations:
            _fail(f"8b: {name} GA made {st.calls} generation steps, want {ga.generations}")
        fa, fkw = st.first
        print(f"8b GA {name} generation step bound: " + json.dumps(
            _io_bound(lambda: TE.evo_generation_step_sharded(*fa, **fkw), (fa, fkw))),
            flush=True)
        del fa, fkw, st
        del eng
    if not torch.equal(labs["sharded"], labs["unsharded"]):
        _fail(f"8b: the GA sharded over [cuda:0] * 2 differs from the unsharded GA in "
              f"{int((labs['sharded'] != labs['unsharded']).sum())} labels")
    peak = torch.cuda.max_memory_allocated()
    print(f"8b GA 2x2, 2 generations, full graph, seeded with the run's labels: sharded "
          f"over [cuda:0] * 2 == unsharded; generation step ms (CUDA events) " + json.dumps(
              {k_: [round(x, 3) for x in v] for k_, v in steps.items()})
          + f"; peak device memory over phase 8b {peak / 2**30:.3f} GiB", flush=True)
    torch.cuda.empty_cache()
    return dict(rep=rep, wall=wall, phase_calls=ph.calls, exchanges=ex.calls)


# --------------------------------------------------------------------------
# phase 9: device-memory accounting, the shape-bucket watchdog, will_fit and
# SLO export on the main path
# --------------------------------------------------------------------------


def _family_table(peaks: dict, est: dict, tol: float) -> list:
    """(family, measured peak, estimate, relative error, held) per family;
    families under 1 % of the measured total are not held (as in the
    reference's test)."""
    from repro_torch.obs import MEMORY_FAMILIES

    total = sum(peaks.values())
    rows = []
    for f in MEMORY_FAMILIES:
        meas, e = peaks.get(f, 0), est.get(f, 0)
        held = max(meas, e) >= 0.01 * total
        err = (e - meas) / meas if meas else float("inf") if e else 0.0
        rows.append((f, meas, e, err, held))
    rows.append(("total", total, est["total"], (est["total"] - total) / total, True))
    for f, meas, e, err, held in rows:
        print(f"    {f:15s} measured {meas / 2**30:9.4f} GiB  estimate {e / 2**30:9.4f} GiB  "
              f"error {err:+.4f}" + ("" if held else "  (under 1 %, not held)"), flush=True)
    return [r for r in rows if r[4] and not abs(r[3]) <= tol]


def check_obs_partition(torch, g, phase4: dict, out_dir: Path) -> None:
    """Phase 9a: phase 4's partition() with accounting on, the tracer on and
    the watchdog strict: the labels must equal phase 4's bit for bit, the
    run be feasible with one lp_score_rows launch per dense round, the
    accountant's peak stay at or below the allocator's, and each family's
    peak lie within the closed form's tolerance."""
    import numpy as np
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.kernels.lp_score import lp_score_rows
    from repro_torch.obs import (
        MetricsRegistry, Tracer, accountant, estimate_footprint, set_accounting,
        set_tracer, watchdog,
    )
    from repro_torch.obs.memory import FOOTPRINT_TOLERANCE

    cfg = PartitionerConfig(k=16, preset="fast", refine_engine="dense",
                            coarsest_factor=100, seed=0)
    acct = accountant()
    acct.reset()
    set_accounting(True, MetricsRegistry("obs"))
    tracer = Tracer()
    set_tracer(tracer)
    watchdog().set_strict(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    lp_score_rows.launches = 0
    t = time.perf_counter()
    rep = partition(g, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = lp_score_rows.launches
    set_tracer(None)
    set_accounting(False)
    max_alloc = torch.cuda.max_memory_allocated()
    snap = acct.snapshot()
    peaks, peak_total = snap["peak_by_family"], snap["peak_total"]
    print(f"9a partition() with accounting, tracing and a strict watchdog: {wall:.3f} s "
          f"(phase 4: {phase4['wall']:.3f} s, {wall / phase4['wall']:.4f}x), cut {rep.cut}, "
          f"feasible {rep.feasible}, lp_score_rows launches {launches}, dense_rounds "
          f"{rep.engine_stats['dense_rounds']}, {acct.calls} account() calls", flush=True)
    if not np.array_equal(rep.labels, phase4["rep"].labels):
        _fail(f"9a: labels differ from phase 4's in "
              f"{int((rep.labels != phase4['rep'].labels).sum())} nodes")
    if not rep.feasible:
        _fail(f"9a: infeasible partition (imbalance {rep.imbalance})")
    if launches <= 0 or launches != rep.engine_stats["dense_rounds"]:
        _fail(f"9a: {launches} lp_score_rows launches for "
              f"{rep.engine_stats['dense_rounds']} dense rounds")
    print("9a peak_by_family (GiB) " + json.dumps(
        {f: round(b / 2**30, 4) for f, b in peaks.items()}), flush=True)
    print(f"9a accountant peak_total {peak_total / 2**30:.4f} GiB, "
          f"max_memory_allocated {max_alloc / 2**30:.4f} GiB ({before / 2**30:.4f} GiB "
          f"allocated before the run), ratio {peak_total / max_alloc:.4f}", flush=True)
    if peak_total > max_alloc:
        _fail(f"9a: the accountant's peak {peak_total} exceeds max_memory_allocated "
              f"{max_alloc}")
    est = estimate_footprint(g.n, g.m, cfg.k, cfg)
    print(f"9a estimate_footprint(n={g.n}, m={g.m}, k={cfg.k}) against the measured peaks "
          f"(tolerance {FOOTPRINT_TOLERANCE}):", flush=True)
    missed = _family_table(peaks, est, FOOTPRINT_TOLERANCE)
    if missed:
        _fail("9a: estimate_footprint misses the tolerance in " + ", ".join(
            f"{f} ({err:+.4f})" for f, _, _, err, _ in missed))
    counters = [ev for ev in tracer.events if ev["ph"] == "C"]
    spans = [ev for ev in tracer.events if ev["ph"] == "X"]
    if not counters or len(counters) != len(spans):
        _fail(f"9a: {len(counters)} counter events for {len(spans)} spans")
    peak_span = max(acct.span_marks, key=lambda m_: m_["total"])
    print(f"9a largest span-close watermark: {peak_span['name']} "
          f"(mode {peak_span.get('mode')}, n {peak_span.get('n')}) at "
          f"{peak_span['total'] / 2**30:.4f} GiB", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = tracer.export_chrome(str(out_dir / "chip_smoke_trace_obs.json"))
    print(f"9a trace with {len(counters)} \"ph\": \"C\" counter events -> {path}",
          flush=True)
    acct.reset()


def check_obs_session(torch, g, warm: int = 2, sealed: int = 4):
    """Phase 9b: a session on the phase-4 graph under 6b's churn with
    accounting on: ``warm`` batches, then ``watchdog().seal()`` and
    ``sealed`` batches that must open no new bucket.  No escalation is
    planned, so the seal stays on throughout.  Returns the session."""
    import numpy as np
    from repro_torch.core import PartitionerConfig
    from repro_torch.dynamic import PartitionSession, SessionConfig
    from repro_torch.obs import (
        MEMORY_FAMILIES, accountant, estimate_footprint, set_accounting, watchdog,
    )
    from repro_torch.obs.memory import FOOTPRINT_TOLERANCE

    k = 16
    pcfg = PartitionerConfig(k=k, preset="fast", refine_engine="dense", coarsest_factor=100)
    scfg = SessionConfig(k=k, seed=0, partition_cfg=pcfg)
    acct = accountant()
    acct.reset()
    set_accounting(True)
    wd = watchdog()
    t = time.perf_counter()
    sess = PartitionSession(g, scfg)
    torch.cuda.synchronize()
    print(f"9b session start: {time.perf_counter() - t:.3f} s", flush=True)
    acct.reset_peaks()
    batches = churn_batches(g, np.random.default_rng(11), g.m // 2 // 1000, lambda: sess.n)
    try:
        for i in range(warm + sealed):
            if i == warm:
                wd.seal()
                print(f"9b watchdog sealed after {warm} warm batches at "
                      f"{wd.bucket_count()} buckets", flush=True)
            res = sess.update(next(batches)[0])
            print(f"9b batch {i}{' (sealed)' if i >= warm else ''}: {res.seconds:.4f} s, "
                  f"feasible {res.feasible}, escalated {res.escalated}, m {res.m}", flush=True)
            if not res.feasible or res.escalated:
                _fail(f"9b batch {i}: feasible {res.feasible}, escalated {res.escalated}")
    finally:
        wd.unseal()
    torch.cuda.synchronize()
    set_accounting(False)
    snap = wd.snapshot()
    print("9b watchdog " + json.dumps(
        {**snap, "kernels": {f: d for f, d in snap["kernels"].items() if d["buckets"]}}),
        flush=True)
    peaks = acct.snapshot()["peak_by_family"]
    est = estimate_footprint(g.n, g.m, k, scfg, workload="dynamic")
    print(f"9b serving peaks against estimate_footprint(workload='dynamic') (tolerance "
          f"{FOOTPRINT_TOLERANCE}, printed, not held):", flush=True)
    _family_table({f: peaks[f] for f in MEMORY_FAMILIES}, est, FOOTPRINT_TOLERANCE)
    acct.reset()
    return sess


def check_will_fit(torch, g, build_records) -> None:
    """Phase 9c: the capacity check against the card's own budget, a 1 GiB
    budget (half the requirement where that is less, as on the small graphs
    of ``--scale``) and rmat(27, 16)'s size, and the kernel builds' nvcc
    times."""
    from repro_torch.core import LPEngine, PartitionerConfig

    cfg = PartitionerConfig(k=16, preset="fast", refine_engine="dense",
                            coarsest_factor=100, seed=0)
    card = LPEngine.will_fit(g.n, g.m, 16, cfg)
    small = LPEngine.will_fit(g.n, g.m, 16, cfg,
                              budget_bytes=min(1 << 30, card["required_bytes"] // 2))
    n27, m27 = 1 << 27, 2 * 16 * (1 << 27)     # rmat(27, 16) before deduplication
    big = LPEngine.will_fit(n27, m27, 16, cfg)
    for tag, r, want in (("phase-4 graph, card budget", card, True),
                         ("phase-4 graph, small budget", small, False),
                         (f"rmat(27, 16) n={n27} m={m27}, card budget", big, False)):
        print(f"9c will_fit {tag}: required {r['required_bytes'] / 2**30:.4f} GiB of "
              f"{r['budget_bytes'] / 2**30:.4f} GiB -> fits {r['fits']}", flush=True)
        if r["fits"] is not want:
            _fail(f"9c will_fit {tag}: fits {r['fits']}, want {want}")
    if not build_records:
        _fail("9c: phase 1 noted no kernel.build record")
    for r in build_records:
        print(f"9c kernel.build {r.key}: nvcc {r.wall_ms:.1f} ms", flush=True)


def check_slo_export(sess, out_dir: Path) -> None:
    """Phase 9d: ``write_slo`` of 9b's session into ``out_dir``."""
    from repro_torch.obs import write_slo

    out_dir.mkdir(parents=True, exist_ok=True)
    paths = write_slo(str(out_dir / "chip_smoke_slo"), sess.stats(), [sess.metrics])
    prom = Path(paths["prom"]).read_text()
    if "repro_updates_applied" not in prom or "_bucket{le=" not in prom:
        _fail(f"9d: {paths['prom']} lacks repro_updates_applied or histogram buckets")
    print(f"9d write_slo -> {paths['prom']} ({len(prom.encode())} bytes), "
          f"{paths['json']} ({Path(paths['json']).stat().st_size} bytes)", flush=True)


def check_obs(torch, g, phase4: dict, out_dir: Path) -> None:
    """Phase 9: the accounted, traced, sealed main path (9a, 9b), the
    capacity check (9c) and SLO export (9d)."""
    from repro_torch.obs import watchdog

    wd = watchdog()
    build_records = [r for r in wd.records if r.kernel == "kernel.build"]
    wd.reset()      # 9a and 9b count their own buckets
    try:
        check_obs_partition(torch, g, phase4, out_dir)
        sess = check_obs_session(torch, g)
    finally:
        wd.set_strict(False)
    check_will_fit(torch, g, build_records)
    check_slo_export(sess, out_dir)
    del sess
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 10: the paper's quality comparison — our partitioner against the
# matching multilevel (the ParMetis stand-in) and the hash partition
# --------------------------------------------------------------------------

#: the reference benchmark's Table II graphs (``benchmarks/run.py``
#: ``_graphs_quality``): name, type (S social/web, M mesh), generator call
QUALITY_GRAPHS = (
    ("ba-social", "S", "barabasi_albert", (16384, 6), dict(seed=3)),
    ("pp-community", "S", "planted_partition", (16384, 16),
     dict(p_in=0.01, p_out=0.0002, seed=4)),
    ("rmat-web", "S", "rmat", (13, 8), dict(seed=2)),
    ("rgg14", "M", "rgg", (14,), dict(seed=1)),
    ("mesh64", "M", "mesh2d", (64,), {}),
)
TWINS = ("quickstart", "cluster_modularity", "autoshard_moe", "partition_web")


def _quality_graph(i: int):
    import repro_torch.graph as G

    _, _, fn, a, kw = QUALITY_GRAPHS[i]
    return getattr(G, fn)(*a, **kw)


def _worker_init(src: str) -> None:
    sys.path.insert(0, src)
    import torch

    torch.set_num_threads(1)


def _matching_job(job) -> dict:
    """One ``matching_multilevel(g, k, seed=0)`` in a worker process (host
    numpy; the device branch, if a level reaches it, runs on the card):
    ``job`` is ``("quality", i, k)`` for Table II graph i or ``("csr",
    indptr, indices, ew, nw, k)``."""
    from repro_torch.core import matching_multilevel
    from repro_torch.graph import GraphNP

    if job[0] == "quality":
        g, k = _quality_graph(job[1]), job[2]
    else:
        g, k = GraphNP(*job[1:5]), job[5]
    rep = matching_multilevel(g, k, seed=0)
    return dict(labels=rep.labels, cut=rep.cut, imbalance=rep.imbalance,
                level_sizes=rep.level_sizes, shrink_first=rep.shrink_first,
                coarsening_stalled=rep.coarsening_stalled, seconds=rep.seconds)


def check_quality_table(torch, futs) -> None:
    """Phase 10a: at k=2 on each Table II graph, our partition() on the card
    (the reference benchmark's config, seed 0) must equal the CPU's labels,
    be feasible and cut below ``hash_partition``; the matching baseline
    (from ``futs``, running in worker processes) is recorded beside it."""
    import numpy as np
    from repro_torch.core import PartitionerConfig, hash_partition, partition
    from repro_torch.core.metrics import cut_np
    from repro_torch.kernels.lp_score import lp_score_rows

    t0 = time.perf_counter()
    k = 2
    print("10a graph,type,n,m,ours_cut,ours_t_s,hem_cut,hem_t_s,hash_cut,"
          "impr_vs_hem_pct,ours_shrink,hem_shrink,hem_stalled,ours_imbalance,"
          "hem_imbalance", flush=True)
    s_impr = []
    for i, (name, typ, *_) in enumerate(QUALITY_GRAPHS):
        g = _quality_graph(i)
        cfg = PartitionerConfig(k=k, preset="fast", coarsest_factor=50,
                                f_mesh=64 if typ == "M" else 14.0, seed=0)
        torch.cuda.synchronize()
        lp_score_rows.launches = 0
        t = time.perf_counter()
        rep = partition(g, cfg)
        torch.cuda.synchronize()
        ours_t = time.perf_counter() - t
        launches = lp_score_rows.launches
        cpu = partition(g, cfg, device="cpu")
        if not np.array_equal(rep.labels, cpu.labels):
            _fail(f"10a {name}: card labels differ from the CPU's in "
                  f"{int((rep.labels != cpu.labels).sum())} nodes")
        hash_cut = cut_np(g, hash_partition(g.n, k))
        mb = futs[i].get()
        impr = 100.0 * (mb["cut"] - rep.cut) / max(mb["cut"], 1)
        if typ == "S":
            s_impr.append(impr)
        print(f"10a {name},{typ},{g.n},{g.m // 2},{rep.cut:.0f},{ours_t:.3f},"
              f"{mb['cut']:.0f},{mb['seconds']:.3f},{hash_cut:.0f},{impr:.1f},"
              f"{rep.shrink_first:.3f},{mb['shrink_first']:.3f},"
              f"{mb['coarsening_stalled']},{rep.imbalance:.4f},"
              f"{mb['imbalance']:.4f}", flush=True)
        ml = mb["level_sizes"]
        print(f"10a {name}: card == cpu; ours level_sizes {rep.level_sizes}, "
              f"lp_score_rows launches {launches} (chunked refinement); matching "
              f"{len(ml)} levels {ml[:2]} ... {ml[-1]}", flush=True)
        if not rep.feasible:
            _fail(f"10a {name}: infeasible, imbalance {rep.imbalance}")
        if not rep.cut < hash_cut:
            _fail(f"10a {name}: cut {rep.cut} not below the hash cut {hash_cut}")
    print(f"10a social/web improvement over matching: {np.mean(s_impr):.1f}% on "
          f"average (per graph {[round(x, 1) for x in s_impr]}); 10a: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def check_matching_full(torch, g, fut, t_submit: float) -> None:
    """Phase 10b: ``matching_multilevel(g, 16, seed=0)`` (run in a worker
    process since phase 10 began) beside our ``partition()`` in phase 4's
    configuration on the card, its ``lp_score_rows`` launches counted from
    zero, and ``hash_partition``.  Ours must be feasible, below the hash
    cut and launch the kernel once per dense round."""
    from repro_torch.core import PartitionerConfig, hash_partition, partition
    from repro_torch.core.metrics import cut_np, imbalance_np, is_feasible
    from repro_torch.kernels.lp_score import lp_score_rows

    k = 16
    cfg = PartitionerConfig(k=k, preset="fast", refine_engine="dense",
                            coarsest_factor=100, seed=0)
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    t = time.perf_counter()
    rep = partition(g, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = lp_score_rows.launches
    hash_lab = hash_partition(g.n, k)
    hash_cut = cut_np(g, hash_lab)
    print(f"10b k={k} on n={g.n}, m={g.m}: ours (phase 4's config) cut {rep.cut} "
          f"({rep.cut / hash_cut:.4f} of hash), imbalance {rep.imbalance:.5f}, "
          f"{wall:.3f} s, shrink_first {rep.shrink_first:.4f}, lp_score_rows "
          f"launches {launches} for {rep.engine_stats['dense_rounds']} dense rounds",
          flush=True)
    print(f"10b ours level_sizes {rep.level_sizes}", flush=True)
    t = time.perf_counter()
    mb = fut.get()
    waited = time.perf_counter() - t
    print(f"10b matching cut {mb['cut']} ({mb['cut'] / hash_cut:.4f} of hash, "
          f"{mb['cut'] / rep.cut:.4f} of ours), imbalance {mb['imbalance']:.5f}, "
          f"feasible {is_feasible(g, mb['labels'], k, 0.03)}, "
          f"{mb['seconds']:.3f} s (host numpy in a worker), shrink_first "
          f"{mb['shrink_first']:.4f}, coarsening_stalled {mb['coarsening_stalled']}",
          flush=True)
    print(f"10b matching level_sizes {mb['level_sizes']}", flush=True)
    print(f"10b hash cut {hash_cut}, imbalance "
          f"{imbalance_np(g, hash_lab, k):.5f}; 10b: waited {waited:.1f} s, "
          f"{time.perf_counter() - t_submit:.1f} s since its submit", flush=True)
    if not rep.feasible or not rep.cut < hash_cut:
        _fail(f"10b: ours infeasible or not below the hash cut {hash_cut}: {rep.cut}")
    if launches <= 0 or launches != rep.engine_stats["dense_rounds"]:
        _fail(f"10b: {launches} lp_score_rows launches for "
              f"{rep.engine_stats['dense_rounds']} dense rounds")


def check_baseline_device_branch(torch) -> None:
    """Phase 10c: the call ``matching_multilevel`` makes at levels of
    200,000 nodes or more — the chunked ``lp_refine`` of a hash partition —
    on mesh2d(512): card labels == CPU labels."""
    import numpy as np
    from repro_torch.core import hash_partition, lp_refine
    from repro_torch.core.metrics import cut_np, lmax
    from repro_torch.graph import mesh2d

    t0 = time.perf_counter()
    g = mesh2d(512)
    k = 2
    lab0 = hash_partition(g.n, k)
    L = lmax(g.total_node_weight, k, 0.03)
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = lp_refine(g, lab0, k=k, U=L, iters=6, seed=0)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu = lp_refine(g, lab0, k=k, U=L, iters=6, seed=0, device="cpu")
    cpu_s = time.perf_counter() - t
    if not np.array_equal(card.labels, cpu.labels) or card.moves != cpu.moves:
        _fail(f"10c: card labels differ from the CPU's in "
              f"{int((card.labels != cpu.labels).sum())} nodes")
    print(f"10c lp_refine(hash_partition) mesh2d(512) n={g.n} m={g.m} k={k}, 6 "
          f"iters: card {card_s:.3f} s, cpu {cpu_s:.3f} s, cut {cut_np(g, lab0)} -> "
          f"{cut_np(g, card.labels)}, {card.moves} moves: card == cpu; 10c: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _start_twins(names):
    """Start example twins with ``--device cuda``, side by side, each in
    its own process."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"), "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for name in names}


def _wait_twins(procs, tag: str, t0: float, timeout: float = 240.0) -> None:
    """Each started twin must exit 0 within ``timeout`` of ``t0``; every one
    still running when this returns or fails is killed."""
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            if p.returncode != 0:
                _fail(f"{tag} {name}: exit {p.returncode}\n{err[-2000:]}")
            lines = out.strip().splitlines()
            print(f"{tag} {name}: exit 0 at {time.perf_counter() - t0:.1f} s; last "
                  f"line: {lines[-1] if lines else ''}", flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"{tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def check_twins() -> None:
    """Phase 10d: four example twins on the card, side by side: each must
    exit 0."""
    t0 = time.perf_counter()
    _wait_twins(_start_twins(TWINS), "10d", t0)


def check_quality(torch, g) -> None:
    """Phase 10: the matching baselines run host numpy in worker processes
    (spawned, one thread each) while the card runs 10a's partitions, 10c,
    10d and 10b's partition of ``g``; 10b's matching, the longest, is
    submitted first.  Leaving the pool terminates its workers, also when a
    check fails."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1 + len(QUALITY_GRAPHS), initializer=_worker_init,
                  initargs=(str(ROOT / "src"),)) as pool:
        t_b = time.perf_counter()
        fut_b = pool.apply_async(_matching_job,
                                 (("csr", g.indptr, g.indices, g.ew, g.nw, 16),))
        futs_a = [pool.apply_async(_matching_job, (("quality", i, 2),))
                  for i in range(len(QUALITY_GRAPHS))]
        check_quality_table(torch, futs_a)
        check_baseline_device_branch(torch)
        check_twins()
        check_matching_full(torch, g, fut_b, t_b)


# --------------------------------------------------------------------------
# phase 11: LM serving (repro_torch.models, repro_torch.launch.serve)
# --------------------------------------------------------------------------

#: 11a, card against CPU in float32 at smoke width: the CPU parity tests'
#: tolerance against the reference
LM_F32_TOL = dict(rtol=1e-4, atol=1e-3)
#: 11b/11c at full width: the first decode step's logits against forward
#: over the S + 1 tokens at the last position, as ||d|| / ||forward||, in
#: bf16 and on the same weights in float32, end to end and layer by layer
#: (PERF.md section 6 says how each limit was chosen)
DECODE_VS_FORWARD_REL = 0.05
DECODE_VS_FORWARD_REL_F32 = 1e-3
#: the full-width serving runs: (arch, batch, prompt, generated tokens,
#: profile one decode step, hold the end-to-end gaps).  mamba2's end-to-end
#: gaps are recorded, not held: its 64 random-weight SSD layers amplify
#: rounding, in the reference as in the port (tools/decode_gap.py: bf16
#: 0.6077, float32 0.0046 on the card); every layer's own gap is held
LM_FULL = (("qwen2.5-3b", 8, 512, 64, True, True),
           ("granite-moe-1b-a400m", 4, 256, 32, False, True),
           ("mamba2-2.7b", 4, 256, 32, False, False))


def _lm_diff(torch, tag: str, got, want, tol=LM_F32_TOL) -> float:
    """Max |got - want|; fails the run unless they agree within ``tol``."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        _fail(f"{tag}: shapes {tuple(got.shape)} != {tuple(want.shape)}")
    d = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        _fail(f"{tag}: card != cpu, max |diff| {d}")
    return d


def check_lm_smoke(torch) -> None:
    """Phase 11a: every architecture at smoke width in float32, the same
    weights on the card and the CPU: prefill's last logits and caches, four
    greedy decode steps' logits and tokens, and loss_fn's value.  Tokens
    must be equal, the rest within ``LM_F32_TOL``; TF32 must be off."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import decode_step, init_params, loss_fn, prefill

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        _fail("11a: float32 matmuls may use TF32")
    t0 = time.perf_counter()
    B, S, steps = 2, 24, 4
    for arch in ARCHS:
        cfg = ARCHS[arch].smoke()
        gen = torch.Generator().manual_seed(0)
        cpu = init_params(cfg, gen, "cpu")
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
        pe = (torch.randn((B, cfg.n_prefix, cfg.d_model), generator=gen)
              if cfg.n_prefix else None)
        cur = S + cfg.n_prefix
        runs = {}
        for dev in ("cpu", "cuda"):
            model = cpu if dev == "cpu" else copy.deepcopy(cpu).to(dev)
            t = tokens.to(dev)
            e = None if pe is None else pe.to(dev)
            batch = {"tokens": t} if e is None else {"tokens": t, "prefix_embeds": e}
            with torch.no_grad():
                loss, _ = loss_fn(cfg, model, batch)
            last, caches = prefill(cfg, model, t, prefix_embeds=e)
            # decode writes K/V in place: keep prefill's caches apart
            at_prefill = [{k: v.clone() for k, v in c.items()} for c in caches]
            caches = pad_caches(cfg, caches, cur, cur + steps + 1)
            tok = last.argmax(-1)
            logits, toks = [last], [tok]
            for i in range(steps):
                lg, caches = decode_step(cfg, model, tok, caches, cur + i)
                tok = lg.argmax(-1)
                logits.append(lg)
                toks.append(tok)
            runs[dev] = (loss, at_prefill, logits, torch.stack(toks, 1).cpu())
        (l0, c0, g0, k0), (l1, c1, g1, k1) = runs["cpu"], runs["cuda"]
        if not torch.equal(k0, k1):
            _fail(f"11a {arch}: greedy tokens differ: cpu {k0.tolist()} card {k1.tolist()}")
        e_log = max(_lm_diff(torch, f"11a {arch} logits {i}", b, a)
                    for i, (a, b) in enumerate(zip(g0, g1)))
        e_c = max(_lm_diff(torch, f"11a {arch} cache {l}.{k}", c1[l][k], c0[l][k])
                  for l in range(len(c0)) for k in c0[l])
        e_l = _lm_diff(torch, f"11a {arch} loss", l1, l0)
        print(f"11a {arch}: prefill, {steps} greedy decode steps, loss_fn: card == cpu "
              f"(max |diff| logits {e_log:.3g}, caches {e_c:.3g}, loss {e_l:.3g}; "
              f"tokens equal)", flush=True)
    print(f"11a: {time.perf_counter() - t0:.1f} s", flush=True)


def _decode_bytes(cfg, model, caches, B: int, n_valid: int) -> int:
    """Bytes one decode step must move at ``n_valid`` filled cache slots:
    every parameter once, except an untied embedding table, of which it
    reads B rows; each attention cache's filled K/V slots read and one slot
    written; each Mamba state and conv window read and written."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        e = model.embed
        n -= e.numel() * e.element_size() - B * e.shape[1] * e.element_size()
    for c in caches:
        if "k" in c:
            k = c["k"]
            slots = min(n_valid, k.shape[1]) + 1
            n += 2 * slots * k[:, 0].numel() * k.element_size()
        else:
            n += 2 * sum(t.numel() * t.element_size() for t in c.values())
    return n


def _profile(torch, tag: str, what: str, fn, step_ms: float, top: int = 12) -> dict:
    """``fn()`` once under torch.profiler: the kernels' device time by
    name, and the card's idle share against the profiled call's wall time
    and against the unprofiled time ``step_ms``.  Only kernels count: a CPU
    op's self device time repeats its kernels' time, and a user annotation
    on the device's timeline (``Optimizer.step#AdamW.step``) spans them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print(f"{tag} profiler: no device time recorded", flush=True)
        return dict(busy_us=None)
    print(f"{tag} profiler, {what}: {len(rows)} kernels' names, "
          f"{sum(r[1] for r in rows)} launches, device busy {busy:.1f} us of a "
          f"{wall_us:.1f} us profiled step", flush=True)
    print(f"{tag}   {'self device us':>14s} {'share':>6s} {'calls':>5s}  kernel", flush=True)
    for us, n, key in rows[:top]:
        print(f"{tag}   {us:14.1f} {us / busy:6.1%} {n:5d}  {key[:90]}", flush=True)
    return dict(busy_us=round(busy, 1), launches=sum(r[1] for r in rows),
                profiled_wall_us=round(wall_us, 1),
                idle_share_profiled=round(1 - busy / wall_us, 4),
                idle_share=round(1 - busy / (step_ms * 1e3), 4),
                top=[[key[:60], round(us, 1), n] for us, n, key in rows[:8]])


def _profile_step(torch, cfg, model, tok, caches, pos: int, step_ms: float) -> dict:
    """One decode step under torch.profiler (``_profile``)."""
    from repro_torch.models import decode_step

    return _profile(torch, "11b", f"one decode step at pos {pos}",
                    lambda: decode_step(cfg, model, tok, caches, pos), step_ms)


def _sdpa_yardstick(torch, cfg, caches, B: int, n_valid: int) -> dict:
    """The port's decode attention core (``layers._attend``) beside one
    ``scaled_dot_product_attention`` call on the same full-width inputs: a
    bf16 query per head against layer 0's filled cache.  A yardstick: the
    port does not call SDPA."""
    import torch.nn.functional as F

    from repro_torch.models.layers import _attend

    G, dh = cfg.n_kv_heads, cfg.d_head
    R = cfg.n_heads // G
    ck, cv = caches[0]["k"], caches[0]["v"]
    gen = torch.Generator(device=ck.device).manual_seed(1)
    q = torch.randn((B, G, R, dh), generator=gen, device=ck.device, dtype=ck.dtype)
    kT = ck[:, :n_valid].transpose(1, 2).contiguous()
    vT = cv[:, :n_valid].transpose(1, 2).contiguous()
    qs = q.reshape(B, G * R, 1, dh)
    scale = dh ** -0.5
    port = _attend(q, ck, cv, n_valid, scale)
    lib = F.scaled_dot_product_attention(qs, kT, vT, enable_gqa=True)
    err = float((port.reshape(B, G * R, 1, dh) - lib.float()).abs().max())
    ms = _time_ms(lambda: _attend(q, ck, cv, n_valid, scale), torch)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(qs, kT, vT, enable_gqa=True),
                      torch)
    nbytes = (2 * kT.numel() + q.numel() + lib.numel()) * ck.element_size()
    return dict(attend_ms=round(ms, 4), sdpa_ms=round(lib_ms, 4), max_abs_diff=err,
                bound_ms=round(nbytes / PEAK_BYTES_PER_S * 1e3, 4), n_valid=n_valid)


def _decode_vs_forward(torch, cfg, model, prompts, pe, tok, first=None):
    """(relative L2, max |d|, argmax agreement) of the first decode step's
    logits (``first``, else computed here) against forward over the prompt
    and ``tok`` at the last position."""
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import decode_step, forward, prefill

    cur = prompts.shape[1] + cfg.n_prefix
    if first is None:
        _, caches = prefill(cfg, model, prompts, prefix_embeds=pe)
        first, _ = decode_step(cfg, model, tok, pad_caches(cfg, caches, cur, cur + 1), cur)
    with torch.no_grad():
        full = forward(cfg, model, torch.cat([prompts, tok[:, None]], 1),
                       prefix_embeds=pe)[0][:, -1].float()
    d = first.float() - full
    return (float(d.norm() / full.norm()), float(d.abs().max()),
            float((first.argmax(-1) == full.argmax(-1)).float().mean()))


def _per_layer_gap(torch, cfg, model, prompts, pe, tok) -> float:
    """The largest relative L2, over the layers, between a layer's decode
    update of token S + 1 and its forward update at that position, every
    layer fed forward's own hidden states (so rounding does not compound
    across layers): the decode path of each layer at full width."""
    from repro_torch.launch.serve import pad_caches

    with torch.no_grad():
        x = model.embed[torch.cat([prompts, tok[:, None]], 1)]
        if pe is not None:
            x = torch.cat([pe.to(x.dtype), x], 1)
        cur = x.shape[1] - 1
        pos = torch.arange(cur + 1, device=x.device)
        worst = 0.0
        for layer in model.layers:
            y = layer(x, pos)[0]
            cache = layer(x[:, :cur], pos[:cur], return_cache=True)[2]
            yd = layer.decode(x[:, cur:], pad_caches(cfg, [cache], cur, cur + 1)[0], cur)[0]
            want = (y[:, cur] - x[:, cur]).float()
            got = (yd[:, 0] - x[:, cur]).float()
            worst = max(worst, float((got - want).norm() / want.norm()))
            x = y
    return worst


def serve_full(torch, card: str, arch: str, B: int, S: int, gen: int, profile: bool,
               end_to_end: bool) -> dict:
    """Phase 11b/11c: ``repro_torch.launch.serve.main`` at full width in
    bf16 (B prompts of S tokens, ``gen`` greedy tokens), then the same seed's
    weights and prompts again for the numbers: prefill seconds, decode ms
    per step (CUDA events), weight bytes, peak memory, the decode step's HBM
    bound, and the first decode step's logits against forward over S + 1
    tokens, in bf16 (``DECODE_VS_FORWARD_REL``) and on the same weights in
    float32 (``DECODE_VS_FORWARD_REL_F32``), held where ``end_to_end``, and
    each layer's own float32 gap (held everywhere).  With
    ``profile``, one decode step under torch.profiler and the SDPA
    yardstick."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, prefill

    tag = "11b" if profile else "11c"
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(S),
                       "--gen", str(gen), "--seed", "0"])
    main_s = time.perf_counter() - t0
    main_peak = torch.cuda.max_memory_allocated()
    if tuple(toks.shape) != (B, gen) or toks.device.type != "cuda":
        _fail(f"{tag} {arch}: main returned {tuple(toks.shape)} on {toks.device}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        _fail(f"{tag} {arch}: a token outside the vocabulary")

    model, prompts, pe = serve.make_inputs(cfg, 0, B, S, dev)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    nparams = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    last, caches = prefill(cfg, model, prompts, prefix_embeds=pe)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    if not bool(torch.isfinite(last).all()):
        _fail(f"{tag} {arch}: prefill logits not finite")
    cur = S + cfg.n_prefix
    caches = serve.pad_caches(cfg, caches, cur, cur + gen)
    tok = last.argmax(-1)
    out, first, finite = [tok], None, []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(gen - 1):
        logits, caches = decode_step(cfg, model, tok, caches, cur + i)
        finite.append(torch.isfinite(logits).all())
        if i == 0:
            first = logits.clone()
        tok = logits.argmax(-1)
        out.append(tok)
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b) / (gen - 1)
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.stack(finite).all()):
        _fail(f"{tag} {arch}: decode logits not finite")
    mine = torch.stack(out, 1)
    rel, max_abs, agree = _decode_vs_forward(torch, cfg, model, prompts, pe, out[0], first)
    if end_to_end and not rel <= DECODE_VS_FORWARD_REL:
        _fail(f"{tag} {arch}: first decode step vs forward(S+1): relative L2 {rel} > "
              f"{DECODE_VS_FORWARD_REL}")
    nbytes = _decode_bytes(cfg, model, caches, B, cur + gen // 2)
    row = dict(
        arch=arch, card=card, batch=B, prompt=S, gen=gen, params=nparams,
        weight_bytes=wbytes, main_s=round(main_s, 3), main_peak_bytes=main_peak,
        prefill_s=round(prefill_s, 4), prefill_tok_s=round(B * S / prefill_s, 1),
        decode_ms_per_step=round(step_ms, 4), decode_tok_s=round(B * 1e3 / step_ms, 1),
        max_memory_allocated=peak, decode_bytes=nbytes,
        decode_bound_ms=round(nbytes / PEAK_BYTES_PER_S * 1e3, 4),
        decode_vs_forward_rel_l2=round(rel, 6), decode_vs_forward_max_abs=round(max_abs, 5),
        argmax_equal=agree, tokens_equal_main=bool(torch.equal(mine, toks)))
    print(f"{tag} {arch} at full width ({nparams / 1e9:.3f} G params, bf16), batch {B}, "
          f"prompt {S}, {gen} tokens: prefill {prefill_s:.4f} s ({row['prefill_tok_s']} "
          f"tok/s); decode {step_ms:.4f} ms/step ({row['decode_tok_s']} tok/s) against a "
          f"bound of {row['decode_bound_ms']} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s); "
          f"weights {wbytes / 1e9:.3f} GB, max_memory_allocated {peak / 2**30:.3f} GiB; "
          f"decode step 1 vs forward(S+1): relative L2 {rel:.5f} (limit "
          f"{DECODE_VS_FORWARD_REL if end_to_end else 'none, recorded'}), max |diff| "
          f"{row['decode_vs_forward_max_abs']}; [{card}]", flush=True)
    if profile:
        row["profile"] = _profile_step(torch, cfg, model, tok, caches, cur + gen - 1, step_ms)
        row["sdpa"] = _sdpa_yardstick(torch, cfg, caches, B, cur + gen)
        print(f"{tag} decode attention core vs scaled_dot_product_attention, layer 0, "
              f"{row['sdpa']['n_valid']} keys: {row['sdpa']['attend_ms']} ms vs "
              f"{row['sdpa']['sdpa_ms']} ms (bound {row['sdpa']['bound_ms']} ms), max |diff| "
              f"{row['sdpa']['max_abs_diff']:.3g}; [{card}]", flush=True)
    # the same weights and tokens in float32 (TF32 off): the two paths must
    # compute the same function
    del caches, last, first
    model.float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rel32, max32, agree32 = _decode_vs_forward(torch, cfg32, model, prompts, pe, out[0])
    layer32 = _per_layer_gap(torch, cfg32, model, prompts, pe, out[0])
    row.update(decode_vs_forward_rel_l2_f32=rel32, decode_vs_forward_max_abs_f32=max32,
               argmax_equal_f32=agree32, decode_vs_forward_worst_layer_f32=layer32)
    print(f"{tag} {arch} float32 on the same weights: decode step 1 vs forward(S+1) "
          f"relative L2 {rel32:.3g} (limit "
          f"{DECODE_VS_FORWARD_REL_F32 if end_to_end else 'none, recorded'}), max |diff| "
          f"{max32:.3g}; worst layer's own update {layer32:.3g} (limit "
          f"{DECODE_VS_FORWARD_REL_F32})", flush=True)
    if end_to_end and not rel32 <= DECODE_VS_FORWARD_REL_F32:
        _fail(f"{tag} {arch}: float32 decode step 1 vs forward(S+1): relative L2 {rel32} > "
              f"{DECODE_VS_FORWARD_REL_F32}")
    if not layer32 <= DECODE_VS_FORWARD_REL_F32:
        _fail(f"{tag} {arch}: float32 decode vs forward of one layer: relative L2 {layer32} "
              f"> {DECODE_VS_FORWARD_REL_F32}")
    print(f"{tag} {json.dumps(row)}", flush=True)
    return row


def check_lm_serving(torch, card: str) -> None:
    """Phase 11: 11a every architecture at smoke width, card == CPU; 11b
    qwen2.5-3b and 11c granite-moe-1b-a400m and mamba2-2.7b at full width
    through ``launch.serve.main``; 11d the ``serve_lm`` twin on the card,
    in its own process beside 11a-11c."""
    t0 = time.perf_counter()
    twin = _start_twins(("serve_lm",))
    try:
        check_lm_smoke(torch)
        for arch, B, S, gen, prof, gate in LM_FULL:
            serve_full(torch, card, arch, B, S, gen, prof, gate)
            torch.cuda.empty_cache()
    except BaseException:
        for p in twin.values():
            p.kill()
            p.wait()
        raise
    _wait_twins(twin, "11d", t0)


# --------------------------------------------------------------------------
# phase 12: LM training (repro_torch.optim, repro_torch.data,
# repro_torch.launch.steps, repro_torch.launch.train)
# --------------------------------------------------------------------------

#: 12a, card against CPU in float32 at smoke width: the limits the CPU
#: parity tests hold the port to against the reference
#: (tests/test_torch_grads*.py, tests/test_torch_train.py)
TRAIN_LOSS_RTOL = 1e-5
GRAD_REL_L2 = 3e-5
#: jamba's 14 random-weight SSD layers amplify rounding (the reference's
#: own gradients move by 2.1e-4 under half-ulp noise on its embedding)
GRAD_REL_L2_JAMBA = 5e-4
#: three train steps, each from the same state on both devices: each
#: parameter leaf, and all of them together (Adam's per-element
#: normalization turns rounding-level gradients into steps of lr; a
#: quantizer flip under compression does the same).  jamba's leaves and
#: its free-running losses are recorded, not held: its gradients agree to
#: GRAD_REL_L2_JAMBA, Adam turns that into sign noise on its zero-initialized
#: leaves (0.13 against the reference on the CPU), and two runs part after
#: two steps, the reference and the port on the CPU too (gnorm 1.42x apart
#: at step 3), while each step from the same state agrees
STEP_LEAF_REL_L2 = 1e-2
STEP_ALL_REL_L2 = {False: 1e-5, True: 1e-4}
#: jamba's limit for all its parameters together, as loose against the
#: others' as its gradient limit (measured on the card: 3.0e-5 plain,
#: 5.6e-5 with compression)
STEP_ALL_REL_L2_JAMBA = 1e-3
#: one full-width layer in float32, card against CPU: its input and
#: parameter gradients (the limit phase 11 holds decode to)
LAYER_GRAD_REL_L2 = 1e-3
#: the full-width training runs: (arch, batch, sequence, steps, through
#: launch.train.main with the profiler and the optimizer yardstick)
TRAIN_FULL = (("qwen2.5-3b", 4, 512, 6, True),
              ("granite-moe-1b-a400m", 4, 512, 4, False),
              ("mamba2-2.7b", 4, 512, 4, False))
#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate
PEAK_BF16_FLOPS_PER_S = 989e12


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in float64 on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    d, n = float((got - want).norm()), float(want.norm())
    return d / n if n else d


def _pipeline_batch(torch, cfg, step: int, B: int, S: int, dev):
    """The data pipeline's batch ``step`` (seed 0) on ``dev``."""
    from repro_torch.data import TokenPipeline

    pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=0, n_prefix=cfg.n_prefix,
                         d_model=cfg.d_model)
    out = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}
    out["tokens"] = out["tokens"].long()
    return out


def _loss_grads(cfg, model, batch, mesh=None):
    """(loss, {name: gradient}) of ``loss_fn`` with remat, by autograd."""
    from repro_torch.models import loss_fn

    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(cfg, model, batch, mesh=mesh, remat=True)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def _opt_to(opt, dev):
    """An optimizer state (``AdamWState`` or ``(AdamWState, residuals)``)
    copied to ``dev``."""
    if hasattr(opt, "_fields"):
        return type(opt)(*(_opt_to(f, dev) for f in opt))
    if isinstance(opt, tuple):
        return tuple(_opt_to(f, dev) for f in opt)
    if isinstance(opt, dict):
        return {k: v.to(dev, copy=True) for k, v in opt.items()}
    return opt.to(dev, copy=True)


def _steps_card_vs_cpu(torch, cfg, start, compress: bool) -> dict:
    """Three ``make_train_step`` steps from ``start`` (a CPU LM) on the CPU
    and on the card.  Free-running, each device trains on its own: the
    worst relative difference of the losses.  From the same state, before
    each step the card takes the CPU's parameters and optimizer state: the
    worst relative difference of that step's loss, the worst parameter
    leaf's relative L2 and all parameters' together."""
    import copy

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init, ef_init

    step = make_train_step(cfg, lr=1e-3, remat=True, compress_grads=compress)

    def fresh(dev):
        model = copy.deepcopy(start).to(dev)
        named = dict(model.named_parameters())
        opt = adamw_init(named)
        return model, (opt, ef_init(named)) if compress else opt

    out = dict(free=0.0, loss=0.0, leaf=0.0, all=0.0)
    (cpu, cpu_opt), (free, free_opt) = fresh("cpu"), fresh("cuda")
    for s in range(3):
        card, card_opt = copy.deepcopy(cpu).to("cuda"), _opt_to(cpu_opt, "cuda")
        cpu, cpu_opt, mc = step(cpu, cpu_opt, _pipeline_batch(torch, cfg, s, 2, 24, "cpu"))
        card, card_opt, mg = step(card, card_opt, _pipeline_batch(torch, cfg, s, 2, 24, "cuda"))
        free, free_opt, mf = step(free, free_opt, _pipeline_batch(torch, cfg, s, 2, 24, "cuda"))
        lc = float(mc["loss"])
        out["free"] = max(out["free"], abs(float(mf["loss"]) - lc) / abs(lc))
        out["loss"] = max(out["loss"], abs(float(mg["loss"]) - lc) / abs(lc))
        pc, pg = dict(cpu.named_parameters()), dict(card.named_parameters())
        out["leaf"] = max(out["leaf"], max(_rel_l2(pg[k], pc[k]) for k in pc))
        out["all"] = max(out["all"], _rel_l2(
            torch.cat([t.detach().flatten() for t in pg.values()]),
            torch.cat([t.detach().flatten() for t in pc.values()])))
    return out


def check_train_smoke(torch) -> None:
    """Phase 12a: every architecture at smoke width in float32, the same
    weights and batches on the card and the CPU: the loss and every
    gradient leaf of ``loss_fn`` with remat, and three ``make_train_step``
    steps with int8 compression off and on (``_steps_card_vs_cpu``); then mamba2 and jamba at the full-width
    chunk (256) and sequence 256, whose gradients must all be finite on the
    card.  Every line prints before a failure fails the phase."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        _fail("12a: float32 matmuls may use TF32")
    t0 = time.perf_counter()
    bad = []
    for arch in ARCHS:
        cfg = ARCHS[arch].smoke()
        chaotic = arch == "jamba-1.5-large-398b"
        tol = GRAD_REL_L2_JAMBA if chaotic else GRAD_REL_L2
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to("cuda")
        l0, g0 = _loss_grads(cfg, cpu, _pipeline_batch(torch, cfg, 0, 2, 24, "cpu"))
        l1, g1 = _loss_grads(cfg, card, _pipeline_batch(torch, cfg, 0, 2, 24, "cuda"))
        e_loss = abs(float(l1) - float(l0)) / abs(float(l0))
        e_grad = max(_rel_l2(g1[k], g0[k]) for k in g0)
        if not (e_loss <= TRAIN_LOSS_RTOL and e_grad <= tol):
            bad.append(f"{arch}: loss {e_loss:.3g}, worst gradient leaf {e_grad:.3g} (limit {tol})")
        steps = []
        for compress in (False, True):
            e = _steps_card_vs_cpu(torch, cfg, cpu, compress)
            lim = STEP_ALL_REL_L2_JAMBA if chaotic else STEP_ALL_REL_L2[compress]
            ok = (e["loss"] <= TRAIN_LOSS_RTOL and e["all"] <= lim
                  and (chaotic or (e["free"] <= TRAIN_LOSS_RTOL
                                   and e["leaf"] <= STEP_LEAF_REL_L2)))
            if not ok:
                bad.append(f"{arch} 3 steps, compress {compress}: {e}")
            steps.append(f"{'int8' if compress else 'plain'} step losses {e['loss']:.3g}, "
                         f"worst leaf {e['leaf']:.3g}, all {e['all']:.3g}, free-running "
                         f"losses {e['free']:.3g}")
        print(f"12a {arch}: loss_fn and its gradients, 3 train steps: card == cpu (loss "
              f"{e_loss:.3g}, worst gradient leaf {e_grad:.3g}; {'; '.join(steps)})", flush=True)
    for arch in ("mamba2-2.7b", "jamba-1.5-large-398b"):
        cfg = ARCHS[arch].smoke()
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=256))
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        loss, grads = _loss_grads(cfg, model, _pipeline_batch(torch, cfg, 0, 2, 256, "cuda"))
        nonfinite = sum(int((~torch.isfinite(g)).sum()) for g in grads.values())
        n = sum(g.numel() for g in grads.values())
        print(f"12a {arch} at chunk 256, sequence 256: loss {float(loss):.5f}, {nonfinite} of "
              f"{n} gradient entries non-finite", flush=True)
        if nonfinite or not bool(torch.isfinite(loss)):
            bad.append(f"{arch} at chunk 256: {nonfinite} non-finite gradient entries")
    print(f"12a: {time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        _fail("12a: " + "; ".join(bad))


def _train_main(torch, tag: str, arch: str, B: int, S: int, steps: int, extra=()) -> dict:
    """``repro_torch.launch.train.main`` at full width on the card (with
    ``extra`` arguments), its lines echoed under ``tag``: every loss and
    gnorm must be finite."""
    import contextlib
    import io
    import math

    from repro_torch.launch import train

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = train.main(["--arch", arch, "--steps", str(steps), "--batch", str(B),
                             "--seq", str(S), "--log-every", "1", "--seed", "0", *extra])
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"{tag} {line}", flush=True)
    gnorms = [float(line.split("gnorm")[1].split()[0]) for line in lines
              if line.startswith("step ")]
    if len(losses) != steps or len(gnorms) != steps or \
            not all(math.isfinite(x) for x in losses + gnorms):
        _fail(f"{tag} {arch}: main's losses {losses}, gnorms {gnorms}")
    return dict(main_s=round(secs, 3), main_peak_bytes=peak, main_losses=losses,
                main_gnorms=gnorms)


def _state_measured(torch, model, opt, before: int) -> dict:
    """The train state the card holds: the distinct storages of the
    model's parameters and buffers and of the optimizer's tensors (exact
    bytes), and ``memory_allocated`` since ``before`` (the allocator
    rounds each block up)."""
    tensors = [*model.parameters(), *model.buffers(), opt.step,
               *(t for d in (opt.mu, opt.nu, opt.master) for t in d.values())]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return dict(state_storage_bytes=sum(storages.values()),
                state_allocated_bytes=torch.cuda.memory_allocated() - before)


def _train_bound(cfg, model, B: int, S: int) -> dict:
    """The least time of one train step with remat: its matmul FLOPs (8 per
    weight of a matmul and token: forward, the recomputed forward and the
    backward's two products; the routed top-k experts of a MoE layer; the
    causal half of each attention layer's score and value products, four
    times) at the dense bf16 rate, and the optimizer's bytes (each
    gradient read and parameter written once, the float32 mu, nu and
    master read and written) at HBM bandwidth; the larger bounds it."""
    T = B * S
    n_mm = 0
    for name, p in model.named_parameters():
        if name == "embed" and not cfg.tie_embeddings:
            continue                                  # a lookup, no matmul
        if p.dim() < 2:
            continue                                  # norms, biases
        n = p.numel()
        if ".moe.w_" in name:
            n = n * cfg.moe.topk // cfg.moe.n_experts
        n_mm += n
    n_attn = sum(1 for mix, _ in cfg.layer_plan() if mix.startswith("attn"))
    attn = 4 * 4 * B * cfg.n_heads * cfg.d_head * S * (S + 1) // 2 * n_attn
    flops = 8 * n_mm * T + attn
    opt_bytes = sum(p.numel() * (2 * p.element_size() + 24) for p in model.parameters())
    flops_ms = flops / PEAK_BF16_FLOPS_PER_S * 1e3
    bytes_ms = opt_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(matmul_params=n_mm, flops=flops, flops_ms=round(flops_ms, 4),
                opt_bytes=opt_bytes, opt_bytes_ms=round(bytes_ms, 4),
                bound_ms=round(max(flops_ms, bytes_ms), 4),
                bound_by="operations" if flops_ms >= bytes_ms else "bytes",
                sum_ms=round(flops_ms + bytes_ms, 4))


def _adamw_yardstick(torch, tag: str, model, opt) -> dict:
    """``adamw_update`` alone on the run's state (CUDA events, one
    profiled call), then ``torch.optim.AdamW(fused=True)`` on the same
    float32 masters: a yardstick, never on the path.  Frees the model's
    parameters and the moments first, so the fused optimizer's states fit
    beside the masters; ``opt`` keeps its masters only."""
    from repro_torch.optim import adamw_update

    named = dict(model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen, device="cuda", dtype=p.dtype) * 1e-3
             for k, p in named.items()}

    def ours():
        adamw_update(grads, opt, named, lr=1e-3)

    ms = _time_ms(ours, torch, warmup=1, batches=3, reps=2)
    prof = _profile(torch, tag, "one adamw_update", ours, ms, top=3)
    n = sum(p.numel() for p in named.values())
    nbytes = sum(p.numel() * (2 * p.element_size() + 24) for p in named.values())
    del grads, named
    for p in model.parameters():
        p.data = torch.empty(0, device="cuda")
    opt.mu.clear()
    opt.nu.clear()
    torch.cuda.empty_cache()
    params = [torch.nn.Parameter(m) for m in opt.master.values()]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
    fused = torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                              weight_decay=0.1, fused=True)
    fused_ms = _time_ms(fused.step, torch, warmup=1, batches=3, reps=2)
    fprof = _profile(torch, tag, "one fused torch.optim.AdamW step", fused.step, fused_ms, top=3)
    fused_bytes = 28 * n
    row = dict(params=n, adamw_ms=round(ms, 4), adamw_launches=prof.get("launches"),
               adamw_bytes=nbytes, adamw_bound_ms=round(nbytes / PEAK_BYTES_PER_S * 1e3, 4),
               fused_adamw_ms=round(fused_ms, 4), fused_launches=fprof.get("launches"),
               fused_bound_ms=round(fused_bytes / PEAK_BYTES_PER_S * 1e3, 4))
    del params, fused
    torch.cuda.empty_cache()
    return row


def train_full(torch, card: str, arch: str, B: int, S: int, steps: int, profile: bool) -> dict:
    """Phase 12b/12c: full width in bf16, batch ``B`` x sequence ``S``.
    With ``profile`` (12b) first ``launch.train.main`` for ``steps`` steps;
    then the same seed's state and batches through ``make_train_step``,
    each step timed on the host clock to a synchronize: the median over
    steps 2 on, tokens/s, ``max_memory_allocated``, every loss and gnorm
    finite, the step's bound; with ``profile`` one step under
    torch.profiler and the optimizer yardstick."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_state
    from repro_torch.optim import adamw_init

    tag = "12b" if profile else "12c"
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    row = dict(arch=arch, card=card, batch=B, seq=S, steps=steps)
    if profile:
        row.update(_train_main(torch, tag, arch, B, S, steps))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = make_state(cfg, 0, dev)
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    row.update(_state_measured(torch, model, opt, before))
    step = make_train_step(cfg, lr=1e-3, remat=True)
    batches = [_pipeline_batch(torch, cfg, s, B, S, dev) for s in range(steps)]
    ms, losses, gnorms = [], [], []
    for b in batches:
        t = time.perf_counter()
        model, opt, m = step(model, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        _fail(f"{tag} {arch}: losses {losses}, gnorms {gnorms}")
    steady = sorted(ms[1:])
    step_ms = steady[len(steady) // 2]
    nparams = sum(p.numel() for p in model.parameters())
    state_bytes = sum(p.numel() * (2 * p.element_size() + 12) for p in model.parameters())
    bound = _train_bound(cfg, model, B, S)
    row.update(params=nparams, step_ms=[round(x, 3) for x in ms], median_step_ms=round(step_ms, 3),
               tok_s=round(B * S * 1e3 / step_ms, 1), max_memory_allocated=peak,
               state_bytes=state_bytes, losses=losses, gnorms=gnorms, **bound)
    print(f"{tag} {arch} at full width ({nparams / 1e9:.3f} G params, bf16 with a float32 "
          f"master), batch {B} x {S}: step {step_ms:.3f} ms (median of steps 2-{steps}; "
          f"{row['tok_s']} tok/s) against a bound of {bound['bound_ms']} ms "
          f"({bound['bound_by']}: {bound['flops'] / 1e12:.2f} TFLOP at 989 TFLOP/s = "
          f"{bound['flops_ms']} ms, optimizer {bound['opt_bytes'] / 1e9:.2f} GB at 3.35 TB/s = "
          f"{bound['opt_bytes_ms']} ms); max_memory_allocated {peak / 2**30:.3f} GiB, "
          f"training state {state_bytes / 2**30:.3f} GiB; losses "
          f"{[round(x, 4) for x in losses]}, gnorms {[round(x, 4) for x in gnorms]}; "
          f"[{card}]", flush=True)
    if profile:
        row["profile"] = _profile(torch, tag, "one train step",
                                  lambda: step(model, opt, batches[-1]), step_ms, top=3)
        row["adamw"] = _adamw_yardstick(torch, tag, model, opt)
        a = row["adamw"]
        print(f"{tag} adamw_update on {a['params'] / 1e9:.3f} G parameters: {a['adamw_ms']} ms, "
              f"{a['adamw_launches']} launches, against a bound of {a['adamw_bound_ms']} ms "
              f"({a['adamw_bytes'] / 1e9:.2f} GB); torch.optim.AdamW(fused=True) on the same "
              f"float32 masters: {a['fused_adamw_ms']} ms, {a['fused_launches']} launches "
              f"(bound {a['fused_bound_ms']} ms); [{card}]", flush=True)
    print(f"{tag} {json.dumps(row)}", flush=True)
    return row


def check_layer_grads_full(torch, arch: str) -> float:
    """The per-layer gate at full width: the first layer of ``arch`` (qwen:
    attention and dense FFN; granite: attention and MoE; mamba2: Mamba-2)
    in float32, the same weights, input and output cotangent on the card
    and the CPU, batch 1 x 256: the worst relative L2 of its input and
    parameter gradients must be at most ``LAYER_GRAD_REL_L2``."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Layer

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    mix, ffnk = cfg.layer_plan()[0]
    gen = torch.Generator().manual_seed(0)
    cpu = Layer(cfg, mix, ffnk, gen, "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.randn((1, 256, cfg.d_model), generator=gen)
    ct = torch.randn((1, 256, cfg.d_model), generator=gen)
    out = {}
    for dev, layer in (("cpu", cpu), ("cuda", card)):
        xd = x.to(dev, copy=True).requires_grad_(True)
        y, aux, _ = layer(xd, torch.arange(256, device=dev))
        ((y * ct.to(dev)).sum() + 0.01 * aux).backward()
        out[dev] = dict(x=xd.grad, **{k: p.grad for k, p in layer.named_parameters()})
    worst = max(_rel_l2(out["cuda"][k], out["cpu"][k]) for k in out["cpu"])
    print(f"12 gate {arch} layer 0 ({mix}, {ffnk}) at full width, float32, 1 x 256: input and "
          f"{len(out['cpu']) - 1} parameter gradients card == cpu, worst relative L2 "
          f"{worst:.3g} (limit {LAYER_GRAD_REL_L2})", flush=True)
    if not worst <= LAYER_GRAD_REL_L2:
        _fail(f"12 gate {arch}: layer gradients card vs cpu, relative L2 {worst} > "
              f"{LAYER_GRAD_REL_L2}")
    return worst


def check_train_resume(torch, workdir: str) -> None:
    """Phase 12d: qwen2.5-3b at smoke width on the card through
    ``launch.train.main``: 12 steps straight, and 6 steps then
    ``--resume`` to 12 from the step-5 checkpoint; the resumed losses must
    equal the uninterrupted run's within rtol 1e-5."""
    import contextlib
    import io

    from repro_torch.launch import train

    common = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--seq", "32",
              "--ckpt-every", "6"]
    a, b = str(Path(workdir) / "a"), str(Path(workdir) / "b")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        full = train.main(common + ["--steps", "12", "--ckpt-dir", a])
        train.main(common + ["--steps", "6", "--ckpt-dir", b])
        resumed = train.main(common + ["--steps", "12", "--ckpt-dir", b, "--resume"])
    if "[resume] restored step 5, continuing at 6" not in buf.getvalue():
        _fail(f"12d: no resume line in {buf.getvalue()[-500:]}")
    worst = max(abs(x - y) / abs(y) for x, y in zip(resumed, full[6:]))
    print(f"12d resume at step 6 of 12 on the card: resumed losses == uninterrupted (max "
          f"relative difference {worst:.3g}, limit 1e-05)", flush=True)
    if len(resumed) != 6 or not worst <= 1e-5:
        _fail(f"12d: resumed {resumed} vs uninterrupted {full[6:]}")


def check_lm_training(torch, card: str) -> dict:
    """Phase 12 (returns 12b/12c's rows by architecture): 12a every
    architecture at smoke width, card == CPU, with
    the ``train_lm`` twin (12d) in its own process beside it, waited for
    before the timed runs; 12b qwen2.5-3b at full width through
    ``launch.train.main`` with the numbers, the profile and the optimizer
    yardstick; 12c granite-moe-1b-a400m and mamba2-2.7b at full width; the
    per-layer float32 gradient gate; 12d resume on the card."""
    t0 = time.perf_counter()
    twin = _start_twins(("train_lm",))
    try:
        check_train_smoke(torch)
    except BaseException:
        for p in twin.values():
            p.kill()
            p.wait()
        raise
    _wait_twins(twin, "12d", t0)
    rows = {}
    for arch, B, S, steps, prof in TRAIN_FULL:
        rows[arch] = train_full(torch, card, arch, B, S, steps, prof)
        torch.cuda.empty_cache()
    for arch, *_ in TRAIN_FULL:
        check_layer_grads_full(torch, arch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        check_train_resume(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"12: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# --------------------------------------------------------------------------
# phase 13: the mesh and expert parallelism (repro_torch.models.moe.moe_ep,
# repro_torch.models.sharding, repro_torch.launch.steps and launch.train
# with a mesh, repro_torch.ckpt.elastic); every mesh coordinate sits on the
# one card, so the all-to-alls are copies within it
# --------------------------------------------------------------------------

#: 13a: moe_ep card against CPU (the CPU tests' limit against the
#: reference) and against moe_dense without drops (the reference's own)
MOE_EP_TOL = 1e-5
MOE_EP_DENSE_TOL = 2e-4
#: 13b: granite-moe-1b-a400m at full width, batch 4 x 512, 4 steps per
#: mesh; 1x1 is the dense MoE of phase 12c
MESH_ARCH = "granite-moe-1b-a400m"
MESH_TRAIN = ((1, 4), (2, 2), (1, 1))


def _card_mesh(shape, dev="cuda"):
    """A ("data", "model") mesh of ``shape`` with every coordinate on
    ``dev``."""
    from repro_torch.launch import make_mesh

    return make_mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))


def check_moe_ep_small(torch) -> None:
    """Phase 13a, first half: ``moe_ep`` at smoke width in float32 on a
    2x4 mesh of the card and of the CPU, the same weights, input and
    cotangent: at capacity 8.0 nothing drops and the card equals
    ``moe_dense`` within 2e-4; at 1.25 and 0.5 the drop sets are equal and
    the output, aux and gradients within 1e-5."""
    from repro_torch.models.moe import moe_dense, moe_ep

    gen = torch.Generator().manual_seed(0)
    E, D, F, K = 8, 32, 64, 2
    p = {"router": torch.randn(D, E, generator=gen) * D ** -0.5,
         "w_up": torch.randn(E, D, F, generator=gen) * D ** -0.5,
         "w_gate": torch.randn(E, D, F, generator=gen) * D ** -0.5,
         "w_down": torch.randn(E, F, D, generator=gen) * F ** -0.5}
    x = torch.randn(4, 16, D, generator=gen)
    ct = torch.randn(4, 16, D, generator=gen)
    for cf in (8.0, 1.25, 0.5):
        out = {}
        for dev in ("cpu", "cuda"):
            pd = {k: v.to(dev, copy=True).requires_grad_(True) for k, v in p.items()}
            xd = x.to(dev, copy=True).requires_grad_(True)
            stats = {}
            y, aux = moe_ep(pd, xd, mesh=_card_mesh((2, 4), dev), topk=K, n_experts=E,
                            capacity_factor=cf, stats=stats)
            ((y * ct.to(dev)).sum() + 0.37 * aux).backward()
            out[dev] = dict(y=y.detach().cpu(), aux=aux.detach().cpu(), x=xd.grad.cpu(),
                            keep=[k.cpu() for k in stats["keep"]], dropped=int(stats["dropped"]),
                            **{k: v.grad.cpu() for k, v in pd.items()})
        a, b = out["cpu"], out["cuda"]
        same = len(a["keep"]) == len(b["keep"]) and all(
            torch.equal(u, v) for u, v in zip(a["keep"], b["keep"]))
        errs = {k: float((b[k] - a[k]).abs().max()) for k in ("y", "aux", "x", *p)}
        line = (f"13a moe_ep 2x4, capacity {cf}: {b['dropped']} of {4 * 16 * K} assignments "
                f"dropped on the card, {a['dropped']} on the cpu, drop sets "
                f"{'equal' if same else 'DIFFER'}; max |card - cpu| " +
                ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        if cf == 8.0:
            dense, _ = moe_dense({k: v.cuda() for k, v in p.items()}, x.cuda(), topk=K)
            e_dense = float((b["y"] - dense.cpu()).abs().max())
            line += f"; card == moe_dense within {e_dense:.3g} (limit {MOE_EP_DENSE_TOL})"
            if b["dropped"] or not e_dense < MOE_EP_DENSE_TOL:
                _fail(f"13a moe_ep against moe_dense: {b['dropped']} dropped, {e_dense}")
        print(line, flush=True)
        if not same or not all(torch.allclose(b[k], a[k], rtol=MOE_EP_TOL, atol=MOE_EP_TOL)
                               for k in errs):
            _fail(f"13a moe_ep capacity {cf}: card != cpu ({errs}, drop sets equal {same})")


def check_mesh_model_small(torch) -> None:
    """Phase 13a, second half: granite, dbrx and jamba at smoke width in
    float32 at a 2x2 mesh (every MoE layer through ``moe_ep``), the same
    weights and batch on the card and the CPU: the loss and every gradient
    leaf within phase 12a's limits."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    for arch in ("granite-moe-1b-a400m", "dbrx-132b", "jamba-1.5-large-398b"):
        cfg = ARCHS[arch].smoke()
        tol = GRAD_REL_L2_JAMBA if arch.startswith("jamba") else GRAD_REL_L2
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = copy.deepcopy(cpu).to("cuda")
        l0, g0 = _loss_grads(cfg, cpu, _pipeline_batch(torch, cfg, 0, 2, 24, "cpu"),
                             _card_mesh((2, 2), "cpu"))
        l1, g1 = _loss_grads(cfg, card, _pipeline_batch(torch, cfg, 0, 2, 24, "cuda"),
                             _card_mesh((2, 2)))
        drops = [int(layer.moe.dispatch["dropped"]) for layer in card.layers
                 if hasattr(layer, "moe")]
        e_loss = abs(float(l1) - float(l0)) / abs(float(l0))
        e_grad = max(_rel_l2(g1[k], g0[k]) for k in g0)
        print(f"13a {arch} at mesh 2x2: loss_fn and its gradients card == cpu (loss "
              f"{e_loss:.3g}, worst gradient leaf {e_grad:.3g}, limit {tol}); assignments "
              f"dropped per MoE layer {drops}", flush=True)
        if not (e_loss <= TRAIN_LOSS_RTOL and e_grad <= tol):
            _fail(f"13a {arch} at mesh 2x2: loss {e_loss}, worst gradient leaf {e_grad}")


def _dropped_share(model) -> list:
    """Each MoE layer's dropped share of its assignments in its last
    ``moe_ep`` call."""
    return [round(float(m.dispatch["dropped"]) / m.dispatch["assignments"], 5)
            for m in (layer.moe for layer in model.layers if hasattr(layer, "moe"))
            if m.dispatch]


def _moe_ep_bound(cfg, kept: int, T: int) -> dict:
    """The least time of one ``moe_ep`` forward: the routed assignments'
    expert FLOPs (three (D, F) products of 2 FLOPs a weight per kept
    assignment) at the bf16 rate, or its bytes (the expert weights and the
    router read once, the tokens read and written once), the larger."""
    D, F, E = cfg.d_model, cfg.moe.d_ff, cfg.moe.n_experts
    flops = 2 * 3 * D * F * kept
    nbytes = 3 * E * D * F * 2 + D * E * 4 + 2 * T * D * 2
    f_ms, b_ms = flops / PEAK_BF16_FLOPS_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=round(max(f_ms, b_ms), 4),
                bound_by="operations" if f_ms >= b_ms else "bytes")


def time_moe_ep(torch, card: str, model, cfg, mesh, B: int, S: int) -> dict:
    """One ``moe_ep`` forward at the main path's shapes (layer 0's MoE, an
    input of ``B`` x ``S`` in its dtype) on ``mesh``: CUDA-event ms, one call under
    the profiler (its launches), forward plus backward ms, ``moe_dense``
    on the same input (the plain version), the bound of the kept
    assignments."""
    from repro_torch.models.moe import moe_dense

    moe = model.layers[0].moe
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda", dtype=moe["w_up"].dtype)
    with torch.no_grad():
        fwd = lambda: moe(x, mesh)
        ms = _time_ms(fwd, torch, warmup=2, batches=3, reps=5)
        prof = _profile(torch, "13b", "one moe_ep forward", fwd, ms, top=3)
        kept = moe.dispatch["assignments"] - int(moe.dispatch["dropped"])
        dense = lambda: moe_dense(moe, x, topk=moe.topk, glu=moe.glu, act=moe.act)
        dense_ms = _time_ms(dense, torch, warmup=2, batches=3, reps=5)
    xg = x.clone().requires_grad_(True)

    def fwd_bwd():
        y, aux = moe(xg, mesh)
        (y.float().square().mean() + aux).backward()

    fb_ms = _time_ms(fwd_bwd, torch, warmup=1, batches=3, reps=3)
    for p in moe.parameters():
        p.grad = None
    row = dict(mesh=list(mesh.shape.values()), ms=round(ms, 4), fwd_bwd_ms=round(fb_ms, 4),
               launches=prof.get("launches"), plain_dense_ms=round(dense_ms, 4), kept=kept,
               assignments=moe.dispatch["assignments"], **_moe_ep_bound(cfg, kept, B * S))
    print(f"13b moe_ep forward, layer 0, {B} x {S} on mesh {row['mesh']}: {ms:.4f} ms, "
          f"{row['launches']} launches (forward and backward {fb_ms:.4f} ms) against a bound "
          f"of {row['bound_ms']} ms ({row['bound_by']}: {kept} kept assignments, "
          f"{row['flops'] / 1e9:.2f} GFLOP, {row['bytes'] / 1e6:.1f} MB); moe_dense on the "
          f"same input {dense_ms:.4f} ms; [{card}]", flush=True)
    return row


def train_mesh(torch, card: str, shape, B: int = 4, S: int = 512, steps: int = 4):
    """Phase 13b: granite-moe-1b-a400m at full width in bf16 with a float32
    master on a ``shape`` mesh of the card (1x1: the dense MoE), seed 0,
    lr 1e-3, the pipeline's batches: each step timed on the host clock to
    a synchronize, the median over steps 2 on, tok/s,
    ``max_memory_allocated``, each MoE layer's dropped share, every loss
    and gnorm finite.  Returns (row, model, optimizer state)."""
    import math

    import repro_torch.models.moe as PMOE
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_state
    from repro_torch.optim import adamw_init

    cfg = get_config(MESH_ARCH)
    mesh = _card_mesh(shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = make_state(cfg, 0, torch.device("cuda", 0))
    opt = adamw_init(dict(model.named_parameters()))
    state = _state_measured(torch, model, opt, before)
    step = make_train_step(cfg, mesh, lr=1e-3, remat=True)
    batches = [_pipeline_batch(torch, cfg, s, B, S, "cuda") for s in range(steps)]
    ms, losses, gnorms, shares = [], [], [], []
    real, calls = PMOE.moe_ep, []
    PMOE.moe_ep = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        for b in batches:
            calls.clear()
            t = time.perf_counter()
            model, opt, m = step(model, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            shares.append(_dropped_share(model))
    finally:
        PMOE.moe_ep = real
    peak = torch.cuda.max_memory_allocated()
    tag = f"13b mesh {shape[0]}x{shape[1]}"
    if not all(math.isfinite(x) for x in losses + gnorms):
        _fail(f"{tag}: losses {losses}, gnorms {gnorms}")
    if shape[1] > 1 and len(shares[-1]) != cfg.n_layers:
        _fail(f"{tag}: {len(shares[-1])} MoE layers went through moe_ep")
    steady = sorted(ms[1:])
    step_ms = steady[len(steady) // 2]
    flat = [x for s_ in shares for x in s_]
    row = dict(arch=MESH_ARCH, card=card, mesh=list(shape), batch=B, seq=S, **state,
               step_ms=[round(x, 3) for x in ms], median_step_ms=round(step_ms, 3),
               tok_s=round(B * S * 1e3 / step_ms, 1), max_memory_allocated=peak,
               losses=losses, gnorms=gnorms, moe_ep_calls_per_step=len(calls),
               dropped_share_last_step=shares[-1],
               dropped_share_mean=round(sum(flat) / len(flat), 5) if flat else None)
    print(f"{tag}: step {step_ms:.3f} ms (median of steps 2-{steps}; {row['tok_s']} tok/s), "
          f"{len(calls)} moe_ep calls a step, max_memory_allocated {peak / 2**30:.3f} GiB; "
          f"losses {[round(x, 4) for x in losses]}, gnorms {[round(x, 4) for x in gnorms]}; "
          f"dropped share per layer (last step) {shares[-1]}, mean over steps and layers "
          f"{row['dropped_share_mean']}; [{card}]", flush=True)
    return row, model, opt


def serve_mesh(torch, card: str, model, B: int = 4, S: int = 256, new: int = 32) -> dict:
    """Phase 13b: prefill ``B`` x ``S`` and ``new`` greedy decode steps of
    the trained granite on a 1x4 mesh of the card through ``make_prefill``
    and ``make_decode_step`` (decode replicates its one token per row over
    the model axis); prefill s, decode ms a step (host clock to a
    synchronize), finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_caches
    from repro_torch.launch.steps import make_decode_step, make_prefill

    cfg = get_config(MESH_ARCH)
    mesh = _card_mesh((1, 4))
    batch = _pipeline_batch(torch, cfg, 0, B, S, "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    last, caches = make_prefill(cfg, mesh)(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    caches = pad_caches(cfg, caches, S, S + new)
    decode = make_decode_step(cfg, mesh)
    tok, ms, finite = last.argmax(-1), [], bool(torch.isfinite(last).all())
    for i in range(new):
        t = time.perf_counter()
        lg, caches = decode(model, tok, caches, S + i)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        finite = finite and bool(torch.isfinite(lg).all())
    dec_ms = sorted(ms[1:])[len(ms) // 2]
    drops = _dropped_share(model)
    print(f"13b serve at mesh 1x4 ({B} x {S}, {new} tokens): prefill {prefill_s:.4f} s, decode "
          f"{dec_ms:.3f} ms a step (median of steps 2-{new}), logits finite {finite}; the last "
          f"decode step's dropped share per layer {drops}; [{card}]", flush=True)
    if not finite:
        _fail("13b serve at mesh 1x4: non-finite logits")
    return dict(prefill_s=round(prefill_s, 4), decode_ms=round(dec_ms, 3))


def check_elastic(torch, card: str, model, opt, workdir: str) -> dict:
    """Phase 13c: the 2x2 run's train state (parameters and AdamW) saved
    once, then ``reshard_restore``d onto 1x4 and 4x1 meshes of the card:
    every shard equals its block of the saved tensor bit for bit and
    ``full()`` the saved tensor; seconds and peak memory of each."""
    from repro_torch.ckpt import reshard_restore, save
    from repro_torch.ckpt.checkpoint import _leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import state_specs
    from repro_torch.models.sharding import P
    from repro_torch.optim import AdamWState

    cfg = get_config(MESH_ARCH)
    named = dict(model.named_parameters())
    t = time.perf_counter()
    save(workdir, 0, (named, opt), {"step": 0})
    save_s = time.perf_counter() - t
    nbytes = sum((Path(workdir) / "step_00000000" / f).stat().st_size
                 for f in ("arrays.npz", "manifest.json"))
    # the saved tensors are the live ones on the card (the checkpoint holds
    # bf16 as float32, which is exact)
    saved = _leaves((named, opt))
    out = dict(save_s=round(save_s, 3), checkpoint_bytes=nbytes)
    for shape in ((1, 4), (4, 1)):
        mesh = _card_mesh(shape)
        ap, ao, psh, _ = state_specs(cfg, mesh, False)
        specs = {k: sh.spec for k, sh in psh.items()}
        like = (dict(ap.named_parameters()), ao)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        (params, st), _ = reshard_restore(
            workdir, 0, like, (specs, AdamWState(step=P(), mu=specs, nu=specs, master=specs)),
            mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        order = _leaves((params, st))            # the checkpoint's leaf order
        if len(order) != len(saved):
            _fail(f"13c: {len(order)} restored leaves, {len(saved)} saved")
        bad, n_shards = [], 0
        for want, x in zip(saved, order):
            if want.dtype != x.dtype:
                bad.append((tuple(x.shape), "dtype"))
            n_shards += len(x.shards)
            for c, shard in x.shards.items():
                if not torch.equal(shard, want[x.sharding.index(c, x.shape)]):
                    bad.append((tuple(x.shape), c))
            if not torch.equal(x.full(), want):
                bad.append((tuple(x.shape), "full"))
        del order, params, st
        torch.cuda.empty_cache()
        split = sum(1 for k, s_ in specs.items() if any(e is not None for e in s_))
        out[f"{shape[0]}x{shape[1]}"] = dict(restore_s=round(secs, 3), peak_bytes=peak,
                                             before_bytes=before, shards=n_shards, bad=len(bad))
        print(f"13c reshard_restore onto mesh {shape[0]}x{shape[1]}: {secs:.3f} s, peak "
              f"memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB of it the live train "
              f"state), {n_shards} shards of {len(saved)} tensors "
              f"({split} of {len(specs)} parameters split) == their blocks of the saved "
              f"tensors bit for bit, full() == saved: {not bad}; [{card}]", flush=True)
        if bad:
            _fail(f"13c {shape}: shards differ from the saved tensors: {bad[:5]}")
    print(f"13c saved the 2x2 run's state in {save_s:.3f} s ({nbytes / 1e9:.3f} GB)",
          flush=True)
    return out


def check_mesh(torch, card: str) -> dict:
    """Phase 13 (returns 13b's rows by mesh shape): 13a at smoke width,
    card == CPU; 13b granite at full width
    through ``launch.train.main --mesh 2x2`` (2 steps), then the timed
    runs at 1x4, 2x2 and 1x1 (the dense MoE), one ``moe_ep`` call's
    numbers and serving at 1x4; 13c the elastic restore of the 2x2
    state."""
    import repro_torch.models.moe as PMOE

    t0 = time.perf_counter()
    check_moe_ep_small(torch)
    check_mesh_model_small(torch)
    print(f"13a: {time.perf_counter() - t0:.1f} s", flush=True)
    calls = []
    real = PMOE.moe_ep
    PMOE.moe_ep = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        main = _train_main(torch, "13b main", MESH_ARCH, 4, 512, 2, ("--mesh", "2x2"))
    finally:
        PMOE.moe_ep = real
    print(f"13b launch.train.main --mesh 2x2: {len(calls)} moe_ep calls over 2 steps, "
          f"max_memory_allocated {main['main_peak_bytes'] / 2**30:.3f} GiB", flush=True)
    if not calls:
        _fail("13b: launch.train.main --mesh 2x2 never ran moe_ep")
    torch.cuda.empty_cache()
    rows = {}
    for shape in MESH_TRAIN:
        row, model, opt = train_mesh(torch, card, shape)
        rows[shape] = row
        if shape == (1, 4):
            from repro_torch.configs import get_config

            row["moe_ep"] = time_moe_ep(torch, card, model, get_config(MESH_ARCH),
                                        _card_mesh(shape), 4, 512)
            row["serve"] = serve_mesh(torch, card, model)
        if shape == (2, 2):
            workdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
            try:
                row["elastic"] = check_elastic(torch, card, model, opt, workdir)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
        del model, opt
        torch.cuda.empty_cache()
    dense = rows[(1, 1)]["median_step_ms"]
    print("13b steps (ms, median): " + ", ".join(
        f"{a}x{b} {r['median_step_ms']} ({r['median_step_ms'] / dense:.3f}x the dense 1x1)"
        for (a, b), r in rows.items()) + f"; [{card}]", flush=True)
    for (a, b), r in rows.items():
        print(f"13b {json.dumps(r)}", flush=True)
    print(f"13: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows



# --------------------------------------------------------------------------
# phase 14: the dry-run tooling (repro_torch.launch.hlo_analysis, roofline,
# dryrun_paper): the meta-device count of the cells 12b and 13b ran held
# against what the card measured, and one PE's refinement phase of the
# paper's sweep at uk-2007 shard shapes on the card
# --------------------------------------------------------------------------


def check_dryrun(torch, card: str, cells) -> dict:
    """Phase 14: for each (tag, arch, mesh shape, row) of ``cells`` (12b's
    and 13b's rows) the dry run's count of one train step of the row's
    batch on the ``meta`` device (``launch.dryrun.count_cell``): its state bytes
    must equal the card's state storage and its peak of live bytes be
    within ``obs.memory.FOOTPRINT_TOLERANCE`` of ``max_memory_allocated``
    (every coordinate shares the card as it shares ``meta``, so the global
    peak is the one to compare); the roofline terms under the port's
    ``HW`` beside the measured step.  Then one PE's refinement phase of
    ``dryrun_paper`` at uk-2007 shard shapes (256 PEs) on the card, from a
    seeded synthetic chunk: CUDA-event ms, the counted bytes on the card's
    tensors and on ``meta``, the bound."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.core.distributed_lp import block_weights, shard_phase
    from repro_torch.kernels.lp_score.threefry import fold_in, prng_key, split
    from repro_torch.launch import dryrun_paper as DP
    from repro_torch.launch import make_mesh
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.hlo_analysis import count_step
    from repro_torch.launch.roofline import roofline
    from repro_torch.obs.memory import FOOTPRINT_TOLERANCE

    out = {}
    for tag, arch, mesh_shape, row in cells:
        cfg = get_config(arch)
        shape = Shape("card", "train", row["seq"], row["batch"])
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         ["meta"] * (mesh_shape[0] * mesh_shape[1]))
        t = time.perf_counter()
        hc, _ = count_cell(cfg, shape, mesh, False, 1)      # global: every coordinate
        secs = time.perf_counter() - t
        rl = roofline(hc, 1, cfg, shape)
        err = hc.peak_bytes / row["max_memory_allocated"] - 1
        r = dict(arch=arch, mesh=list(mesh_shape), count_s=round(secs, 3),
                 counted_state_bytes=hc.state_bytes,
                 measured_state_bytes=row["state_storage_bytes"],
                 state_allocated_bytes=row["state_allocated_bytes"],
                 counted_peak_bytes=hc.peak_bytes,
                 measured_peak_bytes=row["max_memory_allocated"], peak_error=round(err, 4),
                 flops=hc.flops, hbm_bytes=hc.hbm_bytes, collectives=hc.collective_bytes,
                 compute_ms=round(rl["compute_s"] * 1e3, 4),
                 memory_ms=round(rl["memory_s"] * 1e3, 4),
                 collective_ms=round(rl["collective_s"] * 1e3, 4), dominant=rl["dominant"],
                 measured_step_ms=row["median_step_ms"])
        out[tag] = r
        print(f"14 {tag} {arch} at mesh {mesh_shape[0]}x{mesh_shape[1]}, {row['batch']} x "
              f"{row['seq']}, counted on meta in {secs:.3f} s: state {hc.state_bytes} bytes "
              f"counted, {row['state_storage_bytes']} on the card ({row['state_allocated_bytes']}"
              f" allocated); peak {hc.peak_bytes / 2**30:.3f} GiB counted, "
              f"{row['max_memory_allocated'] / 2**30:.3f} GiB max_memory_allocated "
              f"({err:+.4f}, limit {FOOTPRINT_TOLERANCE}); roofline under HW "
              f"(989 TFLOP/s, 3.35 TB/s, 450 GB/s): compute {r['compute_ms']} ms "
              f"({hc.flops / 1e12:.2f} TFLOP), memory {r['memory_ms']} ms (unfused "
              f"{hc.hbm_bytes / 1e9:.1f} GB), collective {r['collective_ms']} ms, "
              f"{rl['dominant']}; the card's step {row['median_step_ms']} ms; [{card}]",
              flush=True)
        if hc.state_bytes != row["state_storage_bytes"]:
            _fail(f"14 {tag}: counted state {hc.state_bytes} bytes, the card holds "
                  f"{row['state_storage_bytes']}")
        if not abs(err) <= FOOTPRINT_TOLERANCE:
            _fail(f"14 {tag}: counted peak {hc.peak_bytes} against max_memory_allocated "
                  f"{row['max_memory_allocated']} ({err:+.4f})")

    # one PE's refinement phase of the paper's sweep at uk-2007 shapes
    k = 16
    d = DP.shard_dims(105.8e6, 3.3e9, 256)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, ll, lg = DP.pe_tensors(d, "cuda", gen, k=k)
    args_bytes = torch.cuda.memory_allocated() - before
    table = block_weights(st, ll, k)
    table[k] = float("inf")
    _, sub = split(fold_in(prng_key(0), 0))
    fn = lambda: shard_phase(st, 0, ll, lg, sub, DP.U, table, k)
    ms = _time_ms(fn, torch, warmup=1, batches=3, reps=3)
    b = _io_bound(fn, _phase_inputs(st, 0, ll, lg, table))
    mst, mll, mlg = DP.pe_tensors(d, "meta", k=k)
    meta_bytes = count_step(shard_phase, mst, 0, mll, mlg, sub, DP.U,
                            torch.empty(k + 1, device="meta"), k).hbm_bytes
    peak = torch.cuda.max_memory_allocated() - before
    out["paper_refine_phase"] = dict(dims=d, ms=round(ms, 4), args_bytes=args_bytes,
                                     peak_bytes=peak, meta_counted_bytes=int(meta_bytes), **b)
    print(f"14 dryrun_paper: one PE's refinement phase (k={k}) at uk-2007 shard shapes, 256 "
          f"PEs (Nc={d['Nc']}, Ec={d['Ec']}, maxN={d['maxN']}, maxG={d['maxG']}), seeded "
          f"synthetic chunk, {args_bytes / 2**30:.3f} GiB of tensors: {ms:.4f} ms (CUDA "
          f"events) against a bound of {b['bound_ms']} ms ({b['io_bytes'] / 1e6:.1f} MB read "
          f"and written once at 3.35 TB/s); counted unfused {b['counted_bytes'] / 1e9:.3f} GB "
          f"on the card's tensors ({b['counted_ms']} ms at 3.35 TB/s), "
          f"{meta_bytes / 1e9:.3f} GB on meta; peak {peak / 2**30:.3f} GiB; [{card}]",
          flush=True)
    del st, ll, lg, table
    torch.cuda.empty_cache()
    print(f"14 {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--matching-scale", type=int, default=17,
                    help="rmat scale of phase 10b (at most --scale)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph import plan_ell_rows, pow2
    from repro_torch.kernels import build
    from repro_torch.kernels.balance import walk
    from repro_torch.kernels.lp_score import lp_score, lp_score_rows
    from repro_torch.kernels.lp_step import chunk_step

    t_start = time.perf_counter()
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 1: build every kernel from the checkout's sources
    sources = [lp_score.SOURCE, walk.SOURCE, chunk_step.SOURCE]
    t = time.perf_counter()
    for src in sources:
        build.load(src)
        log = (build.BUILD_DIR / f"{src.stem}.log").read_text().strip()
        print(f"built {src.name}: {log}", flush=True)
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 2: each kernel against its plain version, at the shapes the
    # main path gives it: the finest level's ELL pack of the input
    g = make_graph(args.scale, args.edge_factor)
    rows = plan_ell_rows(g.indptr, g.n)[0].shape[0]
    check_lp_score_rows(torch, dev, R=pow2(rows), W=128, k=16)
    check_dense_round_batched(torch, g, k=16)

    # ---- phase 3: card vs CPU on a small graph, host GA and batched GA
    check_small_parity(torch)

    # ---- phase 4: the main path with the batched GA (this slice's path),
    # then the host GA (the earlier path), launch counts read around each
    print(f"edge-weight sum {float(g.ew.sum())} (the batched GA needs < 2^24 = "
          f"{2**24}), node-weight sum {float(g.nw.sum())}", flush=True)
    runs = {evo: run_partition(torch, g, Path(args.out), evo) for evo in ("auto", "host")}
    finishes = runs["auto"].pop("finishes")
    sweeps = runs["auto"].pop("sweeps")
    del runs["host"]["finishes"], runs["host"]["sweeps"]
    print("device GA vs host GA: " + json.dumps({
        evo: dict(wall_s=round(r["wall"], 3), partition_s=round(r["rep"].seconds, 3),
                  cut=r["rep"].cut, evolve_s=round(r["evolve_s"], 4),
                  launches=r["launches"], walk_launches=r["walk_launches"],
                  step_launches=r["step_launches"], lp_steps=r["lp_steps"])
        for evo, r in runs.items()}), flush=True)
    rep = runs["auto"]["rep"]
    # the GA's generation step at full width, seeded with the run's result
    check_ga_generations(torch, g, rep.labels)

    # ---- phase 5: the kernels' numbers on the main path's own input
    m = path_lp_score_rows(torch, g, rep.labels, k=16)
    walk_m = path_repair_balance_walk(torch, g, finishes)
    del finishes
    step_m = path_lp_chunk_step(torch, sweeps)
    del sweeps

    # ---- phase 6: the dynamic serving subsystem
    t = time.perf_counter()
    check_dynamic_small(torch)
    dyn = check_dynamic_full(torch, g)
    check_dynamic_throughput(torch)
    check_dynamic_group(torch)
    print(f"phase 6: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 7: the deployment and fault-tolerance stack (this slice's
    # path), on 6b's session; its DR directories live in a temporary
    # directory removed at the end
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dr_")
    try:
        check_dr_small(torch, workdir)
        torch.cuda.synchronize()
        lp_score_rows.launches = 0
        dr = check_dr_full(torch, dyn.pop("sess"), g, workdir, runs["auto"]["wall"])
        torch.cuda.synchronize()
        dr_launches = lp_score_rows.launches
        print(f"7b lp_score_rows launches over the DR path: {dr_launches} (escalation "
              f"{dr['esc_launches']})", flush=True)
        if dr_launches <= 0:
            _fail("7b: the DR path never launched lp_score_rows")
        check_deploy_hot(torch)
        check_resilience_dr(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"phase 7: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 8: the distributed path (this slice's path) and the
    # island-sharded GA; the path runs no hand-written kernel
    t = time.perf_counter()
    check_dist_small(torch)
    check_sharded_ga_small(torch)
    check_dist_full(torch, g, rep.cut, Path(args.out))
    print(f"phase 8: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 9: memory accounting, the watchdog, will_fit and SLO export
    # on the main path (this slice's path)
    t = time.perf_counter()
    check_obs(torch, g, runs["auto"], Path(args.out))
    print(f"phase 9: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 10: the paper's quality comparison (this slice's path):
    # the Table II graphs, the matching baseline against our partition in
    # phase 4's config (on rmat(17, 16): at full width the host matching
    # alone took 160.6 and 172.8 s on the host of an NVIDIA H100 80GB HBM3,
    # 700.00 W machine), its device branch, and the example twins on the card
    t = time.perf_counter()
    g10 = g if args.matching_scale >= args.scale else make_graph(
        args.matching_scale, args.edge_factor)
    check_quality(torch, g10)
    print(f"phase 10: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 11: LM serving (this slice's path); it runs no hand-written
    # kernel
    t = time.perf_counter()
    check_lm_serving(torch, card)
    print(f"phase 11: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 12: LM training (this slice's path); it runs no
    # hand-written kernel
    t = time.perf_counter()
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    rows12 = check_lm_training(torch, card)
    torch.cuda.synchronize()
    print(f"phase 12: {time.perf_counter() - t:.1f} s; lp_score_rows launches "
          f"{lp_score_rows.launches} (the training path runs no hand-written kernel)",
          flush=True)

    # ---- phase 13: the mesh and expert parallelism (this slice's path); it
    # runs no hand-written kernel
    t = time.perf_counter()
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    rows13 = check_mesh(torch, card)
    torch.cuda.synchronize()
    print(f"phase 13: {time.perf_counter() - t:.1f} s; lp_score_rows launches "
          f"{lp_score_rows.launches} (the mesh path runs no hand-written kernel)", flush=True)

    # ---- phase 14: the dry-run tooling (this slice's path): the meta count
    # held against 12b and 13b's card runs; it runs no hand-written kernel
    t = time.perf_counter()
    lp_score_rows.launches = 0
    check_dryrun(torch, card, (("12b", "qwen2.5-3b", (1, 1), rows12["qwen2.5-3b"]),
                               ("13b", MESH_ARCH, (1, 4), rows13[(1, 4)])))
    torch.cuda.synchronize()
    print(f"phase 14: {time.perf_counter() - t:.1f} s; lp_score_rows launches "
          f"{lp_score_rows.launches} (the dry run runs no hand-written kernel)", flush=True)
    kernels = [dict(
        name="lp_score_rows",
        route="cuda",
        source="src/repro_torch/kernels/lp_score/lp_score_rows.cu",
        replaces="src/repro/kernels/lp_score/lp_score.py:61",
        launches=runs["auto"]["launches"],
        max_abs_err=m["max_abs_err"],
        ms=m["ms"],
        plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"],
        bound_by=m["bound_by"],
        library_ms=m["library_ms"],
    ), dict(
        name="repair_balance_walk",
        route="cuda",
        source="src/repro_torch/kernels/balance/repair_balance_walk.cu",
        replaces="src/repro/core/initial_partition.py:83 (a host loop)",
        launches=runs["auto"]["walk_launches"],
        max_abs_err=0,
        ms=walk_m["rows"][0]["ms"],
        plain_ms=walk_m["rows"][0]["plain_ms"],
        host_ms=walk_m["rows"][0]["host_ms"],
        bound_ms=walk_m["rows"][0]["bound_ms"],
        bound_by="latency",
        inputs=walk_m["rows"],
    ), dict(
        name="lp_chunk_step",
        route="cuda",
        source="src/repro_torch/kernels/lp_step/lp_chunk_step.cu",
        replaces="none (src/repro/core/label_propagation.py::_lp_sweep's jnp scan body)",
        launches=runs["auto"]["step_launches"],
        lp_steps=runs["auto"]["lp_steps"],
        max_abs_err=0,
        **step_m["timing"],
        bound_by="bytes",
        inputs=step_m["rows"],
    )]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
