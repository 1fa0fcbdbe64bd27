"""The reference's cut, balance, scores and CSR rebuild against brute force."""

import itertools
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _perfbench_tiny import SEED  # noqa: E402,F401

from perfbench.reference import lp_score, partition, stream  # noqa: E402


@pytest.fixture
def graph():
    rng = np.random.default_rng(5)
    pairs = sorted({tuple(sorted(p)) for p in rng.integers(0, 40, (150, 2)).tolist()
                    if p[0] != p[1]})
    lo = np.array([p[0] for p in pairs])
    hi = np.array([p[1] for p in pairs])
    return 40, lo, hi


def test_cut_and_overload_by_brute_force(graph):
    n, lo, hi = graph
    lab = np.random.default_rng(1).integers(0, 4, n)
    assert partition.cut(lab, lo, hi) == sum(lab[a] != lab[b] for a, b in zip(lo, hi))
    bw = Counter(lab.tolist())
    L = 1.03 * np.ceil(n / 4)
    assert partition.overload(lab, 4, 0.03) == pytest.approx(max(0.0, max(bw.values()) - L))
    assert partition.overload(np.arange(n) % 4, 4, 0.03) == 0.0


def test_judge_renaming_and_bad_labels(graph):
    n, lo, hi = graph
    perm = np.random.default_rng(2).permutation(n)
    lab_orig = np.arange(n) % 4
    lab_prog = np.empty(n, np.int64)
    lab_prog[perm] = lab_orig            # the program saw node x as perm[x]
    cut = partition.cut(lab_orig, lo, hi)
    got = partition.judge(lab_prog, cut, n, lo, hi, 4, 0.03, perm=perm)
    assert got == dict(bad_labels=0, overload=0.0, cut_gap=0.0)
    bad = lab_prog.copy()
    bad[:3] = [4, -1, 7]
    assert partition.judge(bad, cut, n, lo, hi, 4, 0.03, perm=perm)["bad_labels"] == 3
    assert partition.judge(lab_prog[:-1], cut, n, lo, hi, 4, 0.03)["bad_labels"] == n


def test_row_scores_by_loop():
    rng = np.random.default_rng(3)
    lbl = rng.integers(-1, 7, (9, 13))
    w = rng.integers(0, 5, (9, 13)).astype(np.float32)
    want = np.zeros((9, 5))
    for r, j in itertools.product(range(9), range(13)):
        if 0 <= lbl[r, j] < 5:
            want[r, lbl[r, j]] += w[r, j]
    assert np.array_equal(lp_score.row_scores(lbl, w, 5), want)
    assert lp_score.score_gap([(lbl, w, want, 5)]) == 0.0
    assert lp_score.score_gap([(lbl, w, want + 0.5, 5)]) == 0.5


def test_stream_cut_and_csr_by_multiset(graph):
    n, lo, hi = graph
    rng = np.random.default_rng(4)
    st = stream.EdgeStream(n, lo, hi)
    order = rng.permutation(len(lo))
    for t in range(3):
        au = rng.integers(0, n, 6)
        av = (au + 1 + rng.integers(0, n - 1, 6)) % n
        st.push(au, av, order[6 * t: 6 * t + 6])
    lab = rng.integers(0, 3, n)
    for t in range(3):
        ms = Counter(zip(lo.tolist(), hi.tolist()))
        for b in range(t + 1):
            for a, c in zip(st.add_u[b], st.add_v[b]):
                ms[(min(a, c), max(a, c))] += 1
            for e in st.removed[b]:
                ms[(int(lo[e]), int(hi[e]))] -= 1
        assert st.cut_after(t, lab) == sum(w for (a, c), w in ms.items() if lab[a] != lab[c])
        csr = st.csr_after(t)
        arcs = Counter()
        for (a, c), w in ms.items():
            if w > 0:
                arcs[(a, c)] = arcs[(c, a)] = w
        src = np.repeat(np.arange(n), np.diff(csr["indptr"]))
        assert list(zip(src.tolist(), csr["indices"].tolist())) == sorted(arcs)
        assert csr["ew"].tolist() == [arcs[a] for a in sorted(arcs)]
        assert stream.array_gap(csr, csr) == 0
        other = dict(csr, ew=csr["ew"] + (np.arange(csr["ew"].size) == 0))
        assert stream.array_gap(other, csr) == 1
        assert stream.array_gap(dict(csr, indices=csr["indices"][:-1]), csr) == csr["indices"].size
