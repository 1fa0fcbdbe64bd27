"""The port's dry-run tooling against the reference's on the CPU: the
roofline arithmetic and tables, the ``meta``-device inputs of every cell,
the step counter against ``analyze_hlo`` on compiled smoke cells, the
``dryrun``/``dryrun_paper``/``reanalyze`` entry points, and the elastic
restore's spec checks.

The reference's compiled cells (qwen2.5-3b and granite-moe-1b-a400m at
smoke width, 8 x 64 tokens, at 1x1 and 2x4) run in one background
subprocess with 8 host devices (``_torch_mesh.RefJobs``), and its
``dryrun_paper`` at a small graph (its own 512 host devices, 256 PEs) in
another; the port-only tests come first, so that they run while they do.

Tolerances: FLOPs exactly equal to ``analyze_hlo``'s at 1x1 on qwen and at
2x4 on both (per device x 8), within 0.1 % at 1x1 on granite (the
port's dense MoE and the reference's differ by one small product per
layer); state bytes per device exactly equal to the reference's shard
shapes.  Collective bytes at 2x4: the port models the reductions that the
shardings imply, the model axis's activation all-reduces and ``moe_ep``'s
all-to-alls (``dryrun.activation_collectives``), not XLA's
collective-permutes or its resharding of attention heads.  Its all-reduce
bytes are held within ``AR_FACTOR`` of the reference's (0.968x on qwen,
1.582x on granite, which routes some activations through all-gathers
instead), its all-to-all bytes at most the reference's and at least
``A2A_LOW`` of them (``moe_ep``'s exchanges are 503,808 of the
reference's 634,880 bytes on granite; the rest reshards attention heads),
and the total within ``TOTAL_FACTOR`` (0.836x and 0.928x).  HBM bytes are
unfused per-op counts, an upper bound at 1x1: at least the reference's
fusion-level count (ratios printed).  On a mesh the port divides the
global count evenly and so misses the work each coordinate repeats (the
weights it gathers, the model axis's replicated activations): at 2x4 it
is recorded, not held.  The paper sweep: the reference's argument bytes
exactly, the port's after its dtypes, the all-gather exactly after int32
-> int64, the all-reduce exactly but for the reference's 4-byte move
count, no FLOPs, and the unfused HBM bytes between 1x and
``PAPER_HBM_FACTOR`` of the reference's (3.96x clustering, 8.40x
refinement).
"""

import json

import jax
import pytest
import torch

import repro.ckpt.elastic as RE
import repro.configs as RC
import repro.launch.roofline as RR
import repro.launch.steps as RS
import repro.launch.summarize as RSUM
import repro_torch.configs as PC
import repro_torch.launch.roofline as PR
import repro_torch.launch.summarize as PSUM
from _torch_mesh import RefJobs, cpu_mesh
from repro.launch.hlo_analysis import HloCosts as RefHloCosts
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro_torch.ckpt import restore, save, shardings_for
from repro_torch.configs.base import Shape
from repro_torch.launch import dryrun, dryrun_paper, make_mesh, reanalyze
from repro_torch.launch.hlo_analysis import HloCosts
from repro_torch.launch.steps import input_specs, state_specs
from repro_torch.models.sharding import P

torch.set_num_threads(1)

#: the compiled cells: name -> (arch, mesh shape)
CELLS = {"qwen_1x1": ("qwen2.5-3b", (1, 1)),
         "granite_1x1": ("granite-moe-1b-a400m", (1, 1)),
         "qwen_2x4": ("qwen2.5-3b", (2, 4)),
         "granite_2x4": ("granite-moe-1b-a400m", (2, 4))}
SHAPE = Shape("t", "train", 64, 8)
AR_FACTOR = 2.0
A2A_LOW = 0.75
TOTAL_FACTOR = 1.25
#: the paper sweep's small graph (n nodes, m undirected edges) over 256 PEs
PAPER_N, PAPER_M = 2e5, 1e6
PAPER_HBM_FACTOR = 10.0

REF_CELLS = """
import repro.configs as RC
from repro.configs.base import Shape
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh
from repro.launch.steps import compile_train_step, state_specs

for name, (arch, shape) in CELLS.items():
    cfg = RC.ARCHS[arch].smoke()
    mesh = make_mesh(shape, ("data", "model"))
    compiled = compile_train_step(cfg, mesh, Shape("t", "train", 64, 8)).compile()
    hc = analyze_hlo(compiled.as_text())
    out[name + "_flops"], out[name + "_hbm"] = hc.flops, hc.hbm_bytes
    for kind, b in hc.collective_bytes.items():
        out[name + "_coll_" + kind] = b
    ap, ao, psh, osh = state_specs(cfg, mesh, False)
    out[name + "_state"] = sum(
        int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
        for l, s in zip(jax.tree.leaves((ap, ao)), jax.tree.leaves((psh, osh))))
"""


PAPER_REF = """
import sys
import repro.launch.dryrun_paper as D   # sets its 512 host devices before jax starts

real = jax.stages.Lowered.compile
seen = []


def compile(self, *a, **k):
    # the compiled sweep's argument bytes per PE, and its declared
    # arguments' bytes per PE by dtype (a leading axis of 256 is the PEs')
    c = real(self, *a, **k)
    decl = {}
    for info in jax.tree.leaves(self.args_info):
        shp = info.shape[1:] if info.shape and info.shape[0] == 256 else info.shape
        decl[str(info.dtype)] = decl.get(str(info.dtype), 0) + int(np.prod(shp)) \
            * info.dtype.itemsize
    seen.append((c.memory_analysis().argument_size_in_bytes, decl))
    return c


jax.stages.Lowered.compile = compile
sys.argv = ["dryrun_paper", "--n", str(PAPER_N), "--m", str(PAPER_M), "--out", DIR + "/paper"]
for (mode, r), (arg, decl) in zip(D.main().items(), seen):
    rl = r["roofline"]
    out[mode + "_arg"] = arg
    for dt, b in decl.items():
        out[mode + "_decl_" + dt] = b
    out[mode + "_flops"], out[mode + "_hbm"] = rl["hlo_flops_per_dev"], rl["hlo_bytes_per_dev"]
    for kind, b in rl["collectives"].items():
        out[mode + "_coll_" + kind] = b
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = RefJobs(tmp_path_factory.mktemp("dryrun_ref"), {},
                {"cells": REF_CELLS, "paper": PAPER_REF},
                dict(CELLS=CELLS, PAPER_N=PAPER_N, PAPER_M=PAPER_M))
    yield r
    r.close()


def _pair(arch):
    return RC.get_config(arch), PC.get_config(arch)


# ------------------------------------------------------------ roofline


@pytest.mark.parametrize("arch,shape", [(a, s) for a in PC.ARCHS for s in PC.SHAPES])
def test_param_counts_and_model_flops_bit_for_bit(arch, shape):
    rcfg, pcfg = _pair(arch)
    assert PR.param_counts(pcfg) == RR.param_counts(rcfg)
    assert PR.model_flops(pcfg, PC.SHAPES[shape]) == RR.model_flops(rcfg, RC.SHAPES[shape])


def test_roofline_equals_the_reference_under_its_hw():
    """The same cost record through both ``roofline``s: equal under the
    reference's hardware model; the port's default is the H100's."""
    coll = {"all-gather": 3.0e8, "all-to-all": 1.25e9, "reduce-scatter": 7.0e7}
    for arch in ("qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-2.7b"):
        rcfg, pcfg = _pair(arch)
        for sname in PC.SHAPES:
            want = RR.roofline(RefHloCosts(2.5e15, 4.0e12, coll, 0), 256, rcfg,
                               RC.SHAPES[sname])
            got = PR.roofline(HloCosts(2.5e15, 4.0e12, coll, 0), 256, pcfg, PC.SHAPES[sname],
                              hw=RR.HW)
            assert got == want
    h100 = PR.roofline(HloCosts(989e12, 3.35e12, {"all-reduce": 450e9}, 0), 1, pcfg,
                       PC.SHAPES["train_4k"])
    assert (h100["compute_s"], h100["memory_s"], h100["collective_s"]) == (1.0, 1.0, 1.0)
    assert PR.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}


def _records():
    """Reference-style records: two ok cells on each mesh, a skip and an
    error."""
    rows = []
    for i, (arch, shape) in enumerate((("qwen2.5-3b", "train_4k"), ("mamba2-2.7b", "decode_32k"))):
        for mesh in ("single", "multi"):
            rows.append({
                "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "gib_per_device": 12.5 + i, "t_lower_s": 3.2, "t_compile_s": 41.7 + i,
                "roofline": {"compute_s": 0.5 + i, "memory_s": 0.25, "collective_s": 0.125 * i,
                             "dominant": "compute_s" if i == 0 else "memory_s",
                             "collectives": {"all-gather": 2.0**31, "all-reduce": 2.0**29 * i,
                                             "all-to-all": 2.0**30, "collective-permute": 1e3},
                             "useful_ratio": 0.75 if i == 0 else None,
                             "roofline_fraction": 0.31}})
    rows.append({"arch": "qwen2.5-3b", "shape": "long_500k", "mesh": "single",
                 "status": "skip", "reason": "pure full-attention stack: no sub-quadratic "
                                             "mechanism"})
    rows.append({"arch": "jamba-1.5-large-398b", "shape": "train_4k", "mesh": "multi",
                 "status": "error", "error": "boom"})
    return rows


def test_summarize_tables_equal_the_reference(tmp_path):
    rows = _records()
    assert PSUM.fmt_dryrun(rows) == RSUM.fmt_dryrun(rows)
    for mesh in ("single", "multi"):
        assert PSUM.fmt_roofline(rows, mesh) == RSUM.fmt_roofline(rows, mesh)
    for i, r in enumerate(rows):
        with open(tmp_path / f"c{i}__base.json", "w") as f:
            json.dump(r, f)
    assert PSUM.load(str(tmp_path)) == RSUM.load(str(tmp_path))
    # the port's records have no compile time: "–"
    port = [dict(r, t_compile_s=None) if r["status"] == "ok" else r for r in rows]
    table = PSUM.fmt_dryrun(port)
    assert table.count("| – |") >= 4 and "| 3.2 | – |" in table


# ------------------------------------------------------------ input_specs


def _dtype(x):
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", [(a, s) for a in PC.ARCHS for s in PC.SHAPES])
def test_input_specs_equal_the_reference(arch, shape):
    """Every cell at full width: the same inputs, shapes and dtypes, the
    decode caches layer by layer (the reference stacks a scanned unit
    position's layers on a leading axis)."""
    rcfg, pcfg = _pair(arch)
    want = RS.input_specs(rcfg, RC.SHAPES[shape])
    got = input_specs(pcfg, PC.SHAPES[shape])
    assert set(got) == set(want)
    assert all(v.device.type == "meta" for k, v in got.items() if k != "caches")
    for k in set(want) - {"caches"}:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dtype(got[k]) == _dtype(want[k]), k
    if "caches" not in want:
        return
    caches, ref = got["caches"], want["caches"]
    n_units, unit, rem = rcfg.scan_split()
    U = len(unit)
    assert len(caches) == n_units * U + len(rem) == rcfg.n_layers
    pairs = [(caches[u * U + i], {n: (l.shape[1:], l.dtype) for n, l in c.items()})
             for i, c in enumerate(ref["scan"]) for u in range(n_units)]
    pairs += [(caches[n_units * U + j], {n: (l.shape, l.dtype) for n, l in c.items()})
              for j, c in enumerate(ref["rem"])]
    for mine, theirs in pairs:
        assert set(mine) == set(theirs)
        for n, (shp, dt) in theirs.items():
            assert tuple(mine[n].shape) == tuple(shp) and mine[n].device.type == "meta"
            assert _dtype(mine[n]) == str(dt)


# ------------------------------------------------------------ the counter


def _count(arch, mesh_shape):
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, ("data", "model"), ["meta"] * n)
    return dryrun.count_cell(PC.ARCHS[arch].smoke(), SHAPE, mesh, False, n)


@pytest.fixture(scope="module")
def counted():
    return {name: _count(*cell) for name, cell in CELLS.items()}


def test_count_step_tracks_live_bytes_and_moe_exchanges(counted):
    """The state is live from the start and the peak holds it; at 1x1
    every coordinate's state is the state; ``moe_ep``'s all-to-alls
    appear only on a mesh with a model axis, six (E, cap, D) buffers per
    layer and coordinate (forward, recompute, backward)."""
    for name, (hc, state_dev) in counted.items():
        assert hc.peak_bytes > hc.state_bytes > 0 and hc.unknown_trip_loops == 0
        if name.endswith("1x1"):
            assert state_dev == hc.state_bytes and "all-to-all" not in hc.collective_bytes
    cfg = PC.ARCHS["granite-moe-1b-a400m"].smoke()
    T = (SHAPE.batch // 2) * (SHAPE.seq // 4)
    cap = int(T * cfg.moe.topk / cfg.moe.n_experts * cfg.moe.capacity_factor) + 1
    buf = cfg.moe.n_experts * cap * cfg.d_model * 4
    assert counted["granite_2x4"][0].collective_bytes["all-to-all"] == 6 * buf * cfg.n_layers


def test_counted_flops_equal_analyze_hlo(ref, counted):
    out = ref.get()
    for name, (hc, _) in counted.items():
        n = CELLS[name][1][0] * CELLS[name][1][1]
        want = float(out[name + "_flops"])
        print(f"{name}: flops port {hc.flops * n:.0f} (global), reference {want * n:.0f}; "
              f"hbm bytes port/reference {hc.hbm_bytes / float(out[name + '_hbm']):.3f}")
        if name == "granite_1x1":
            assert abs(hc.flops / want - 1) <= 1e-3
        else:
            assert hc.flops == want
        if name.endswith("1x1"):
            assert hc.hbm_bytes >= float(out[name + "_hbm"])
    assert counted["qwen_1x1"][0].flops == 402_653_184
    assert counted["granite_2x4"][0].flops * 8 == 478_150_656


def test_state_bytes_per_device_equal_the_reference_shards(ref, counted):
    out = ref.get()
    for name, (_, state_dev) in counted.items():
        assert state_dev == int(out[name + "_state"]), name


@pytest.mark.parametrize("name", ["qwen_2x4", "granite_2x4"])
def test_collective_bytes_against_the_reference(ref, counted, name):
    """Positive in every kind the port models where the reference reports
    it; the all-reduce bytes within ``AR_FACTOR``, the all-to-all bytes
    between ``A2A_LOW`` of the reference's and all of them, and the total
    within ``TOTAL_FACTOR`` of the reference's."""
    out = ref.get()
    hc = counted[name][0]
    theirs = {k[len(name) + 6:]: float(v) for k, v in out.items()
              if k.startswith(name + "_coll_")}
    print(f"{name} collective bytes per device, port / reference: " + ", ".join(
        f"{k} {hc.collective_bytes.get(k, 0):.0f} / {theirs.get(k, 0):.0f}"
        for k in sorted(set(theirs) | set(hc.collective_bytes)))
        + f"; total {hc.collective_total / sum(theirs.values()):.3f}")
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        if theirs.get(kind) and (kind != "all-to-all" or name.startswith("granite")):
            assert hc.collective_bytes.get(kind, 0) > 0, kind
    ratio = hc.collective_bytes["all-reduce"] / theirs["all-reduce"]
    assert 1 / AR_FACTOR <= ratio <= AR_FACTOR
    a2a = hc.collective_bytes.get("all-to-all", 0.0)
    if name.startswith("granite"):
        assert A2A_LOW * theirs["all-to-all"] <= a2a <= theirs["all-to-all"]
    else:
        assert a2a == 0.0        # no MoE layer: XLA's are attention resharding
    total = hc.collective_total / sum(theirs.values())
    assert 1 / TOTAL_FACTOR <= total <= TOTAL_FACTOR
    for other in ("qwen_1x1", "granite_1x1"):
        assert not counted[other][0].collective_bytes
        assert not [k for k in out if k.startswith(other + "_coll_")]


@pytest.mark.parametrize("arch,units", [("qwen2.5-3b", 20), ("granite-moe-1b-a400m", 12),
                                        ("mamba2-2.7b", 10)])
def test_activation_all_reduces_count_each_tensor_parallel_product(arch, units):
    """At 2x4, training, two layers: per layer ``wo`` (and ``w_down``) in
    the forward pass and remat's recompute, and each column-parallel
    product that reads the hidden states (``wq``, ``wk``, ``wv``, ``w_up``,
    ``w_gate``; Mamba's ``wz``, ``wx``, not its depthwise ``conv_w``) in
    the backward; then the embedding lookup, and the head's backward
    (tied in granite and mamba2): ``units`` hidden-state all-reduces of
    (8 / 2, 64, 64) float32 on each of the 8 coordinates."""
    cfg = PC.ARCHS[arch].smoke()
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    ap, _, psh, _ = state_specs(cfg, mesh, False)
    got = dryrun.activation_collectives(cfg, SHAPE, dict(ap.named_parameters()), psh, mesh,
                                        False)
    assert got["all-reduce"] == units * (4 * 64 * 64 * 4) * 8
    assert ("all-to-all" in got) == (cfg.moe is not None)


# ------------------------------------------------------------ entry points


def test_dryrun_main_writes_cells_and_reanalyze_round_trips(tmp_path, capsys):
    """One smoke cell in-process, then the driver over a two-cell subset
    (one subprocess each); ``reanalyze`` re-derives each record's
    roofline from its counts, unchanged, and ``summarize`` renders them."""
    out = str(tmp_path)
    rec = dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape", "train_4k", "--mesh",
                       "2x2", "--smoke", "--out", out])
    path = dryrun.cell_path(out, "granite-moe-1b-a400m", "train_4k", "2x2")
    assert path.endswith("granite-moe-1b-a400m__train_4k__2x2__base.json")
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    ref_keys = {"arch", "shape", "mesh", "variant", "kind", "n_chips", "status", "t_lower_s",
                "t_compile_s", "bytes_per_device", "gib_per_device", "params_total",
                "params_active", "roofline"}
    assert ref_keys <= set(rec) and rec["counter"] == "meta" and rec["t_compile_s"] is None
    est = rec["bytes_per_device_estimate"]
    assert rec["bytes_per_device"] == int(est["state_bytes_per_device"]
                                          + est["transient_bytes_per_device"])
    assert rec["n_chips"] == 4 and rec["roofline"]["collectives"]["all-to-all"] > 0
    paths = dryrun.main(["--driver", "--smoke", "--arch", "qwen2.5-3b", "--shape",
                         "train_4k,decode_32k", "--mesh", "1x2", "--out", out])
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "qwen2_5-3b__train_4k__1x2__base.json", "qwen2_5-3b__decode_32k__1x2__base.json"]
    recs = [json.load(open(p)) for p in paths]
    assert [r["status"] for r in recs] == ["ok", "ok"] and recs[1]["kind"] == "decode"
    before = {p: json.load(open(p))["roofline"] for p in paths + [path]}
    reanalyze.main(out)
    for p, rl in before.items():
        assert json.load(open(p))["roofline"] == rl
    capsys.readouterr()
    PSUM.main(out)
    assert "granite-moe-1b-a400m | train_4k | 2x2 | ok" in capsys.readouterr().out


def test_dryrun_paper_small_on_meta(tmp_path):
    """One PE of the paper's sweep at a small graph over 256 PEs: both
    records, the port's int64 arguments beside the reference's int32 ones,
    one all-gather of the PE's send buffer a phase and one all-reduce of
    k + 1 block weights a refinement phase; reanalyze keeps the terms."""
    recs = dryrun_paper.main(["--n", "2e5", "--m", "1e6", "--out", str(tmp_path)])
    d = dryrun_paper.shard_dims(2e5, 1e6, 256)
    for mode, iters in dryrun_paper.MODES:
        k = 16 if mode == "refine" else 0
        r = recs[mode]
        assert (r["arch"], r["shape"], r["n_chips"], r["counter"]) == (
            "paper-sclap", f"uk2007_{mode}", 256, "meta")
        assert (tmp_path / f"paper-sclap__uk2007_{mode}__single__base.json").exists()
        phases = iters * d["C"]
        coll = r["roofline"]["collectives"]
        assert coll["all-gather"] == phases * d["maxI"] * 8
        assert coll.get("all-reduce", 0) == (phases * (k + 1) * 4 if k else 0)
        assert r["arg_bytes"]["port_dtypes"] > r["arg_bytes"]["reference_dtypes"] \
            == dryrun_paper.reference_arg_bytes(d)
        assert r["bytes_per_device"] >= r["arg_bytes"]["port_dtypes"]
        assert r["roofline"]["dominant"] == "memory_s" and r["roofline"]["hlo_flops_per_dev"] == 0
    before = json.load(open(tmp_path / "paper-sclap__uk2007_refine__single__base.json"))
    reanalyze.main(str(tmp_path))
    assert json.load(open(tmp_path / "paper-sclap__uk2007_refine__single__base.json")) == before
    # the reference's per-PE argument bytes at uk-2007 scale (0.318 GiB)
    uk = dryrun_paper.shard_dims(105.8e6, 3.3e9, 256)
    assert uk["Ec"] == 6_445_320
    assert round(dryrun_paper.reference_arg_bytes(uk) / 2**30, 3) == 0.318


def test_dryrun_paper_against_the_reference(ref, tmp_path):
    """The reference's ``dryrun_paper`` at the same small graph over 256
    PEs: its declared arguments per PE are ``reference_arg_bytes``, and
    its compiled program's too (refinement reads no ghost weight, and XLA
    drops that argument); the port's arguments are those with int32 at
    int64, the two per-PE counts and the PRNG key in place of the two
    bool masks; all-gather bytes twice the reference's (int64 labels);
    all-reduce bytes the reference's but for the 4-byte psum of its move
    count, which the port's sweep does not keep; no FLOPs on either side;
    unfused HBM bytes between 1x and ``PAPER_HBM_FACTOR`` of the
    reference's fusion-level count."""
    out = ref.get()
    recs = dryrun_paper.main(["--n", str(PAPER_N), "--m", str(PAPER_M), "--out", str(tmp_path)])
    d = dryrun_paper.shard_dims(PAPER_N, PAPER_M, 256)
    for mode, _ in dryrun_paper.MODES:
        r = recs[mode]
        decl = {k[len(mode) + 6:]: int(v) for k, v in out.items()
                if k.startswith(mode + "_decl_")}
        declared = sum(decl.values())
        assert declared == dryrun_paper.reference_arg_bytes(d) \
            == r["arg_bytes"]["reference_dtypes"]
        unused = d["maxG"] * 4 if mode == "refine" else 0        # ghost_nw
        assert int(out[mode + "_arg"]) == declared - unused
        assert r["arg_bytes"]["port_dtypes"] == \
            declared + decl["int32"] - 2 * 8 - decl["uint32"] + d["maxN"] + d["maxG"]
        theirs = {k[len(mode) + 6:]: float(v) for k, v in out.items()
                  if k.startswith(mode + "_coll_")}
        mine = r["roofline"]["collectives"]
        assert mine["all-gather"] == 2 * theirs["all-gather"]
        assert mine.get("all-reduce", 0.0) + 4 == theirs["all-reduce"]
        assert r["roofline"]["hlo_flops_per_dev"] == float(out[mode + "_flops"]) == 0.0
        hbm = r["roofline"]["hlo_bytes_per_dev"] / float(out[mode + "_hbm"])
        print(f"paper {mode}: arguments {r['arg_bytes']['port_dtypes']} bytes (port), "
              f"{declared} (reference); all-gather {mine['all-gather']:.0f} / "
              f"{theirs['all-gather']:.0f}; unfused HBM bytes / the reference's {hbm:.3f}")
        assert 1.0 <= hbm <= PAPER_HBM_FACTOR


# ------------------------------------------------------------ elastic restore


def test_shardings_for_and_restore_raise_where_the_reference_raises(tmp_path):
    """A spec tree shorter than the state, and a spec naming an axis past a
    leaf's rank, raise in both packages (ValueError, IndexError); a
    shardings tree shorter than the template raises ValueError in
    ``restore``."""
    rmesh = ref_make_mesh((1, 1), ("data", "model"))
    pmesh = cpu_mesh((1, 1))
    rt = [jax.numpy.zeros((4, 4)), jax.numpy.zeros((4,))]
    pt = [torch.zeros(4, 4), torch.zeros(4)]
    RP = jax.sharding.PartitionSpec
    with pytest.raises(ValueError):
        RE.shardings_for(rt, [RP("data", None)], rmesh)
    with pytest.raises(ValueError):
        shardings_for(pt, [P("data", None)], pmesh)
    with pytest.raises(IndexError):
        RE.shardings_for({"b": rt[1]}, {"b": RP(None, "model")}, rmesh)
    with pytest.raises(IndexError):
        shardings_for({"b": pt[1]}, {"b": P(None, "model")}, pmesh)
    with pytest.raises(ValueError):
        shardings_for({"a": pt[0]}, {"b": P("data")}, pmesh)
    good = shardings_for(pt, [P("data", None), P("model")], pmesh)
    save(str(tmp_path), 0, pt)
    with pytest.raises(ValueError, match="shardings tree has 1 leaves"):
        restore(str(tmp_path), 0, pt, shardings=good[:1])
    got, _ = restore(str(tmp_path), 0, pt, shardings=good)
    assert [torch.equal(g.full(), t) for g, t in zip(got, pt)] == [True, True]
