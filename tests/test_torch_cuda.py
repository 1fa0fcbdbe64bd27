"""repro_torch cases that need an NVIDIA GPU: each hand-written CUDA kernel
against its plain PyTorch version on the card, and the dense round's card
path against its CPU path.  Marked ``cuda``; they skip without a device.
This file imports neither jax nor the reference package, so it runs on a
GPU machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.graph import ell_pack, rmat
from repro_torch.kernels.lp_score import (
    dense_round_device,
    lp_score_rows,
    lp_score_rows_ref,
)

torch.set_num_threads(1)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: exact on
    integral weights, rtol=1e-5 on float weights (atomics reorder sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for (r, w, k, integral) in ((4096, 128, 16, True), (1003, 37, 5, False),
                                (512, 128, 300, False)):
        lbl = torch.randint(-1, k + 2, (r, w), generator=gen, device="cuda",
                            dtype=torch.int32)
        wt = (torch.randint(0, 4, (r, w), generator=gen, device="cuda").float()
              if integral else torch.rand((r, w), generator=gen, device="cuda"))
        before = lp_score_rows.launches
        got = lp_score_rows(lbl, wt, k)
        torch.cuda.synchronize()
        assert lp_score_rows.launches == before + 1
        want = lp_score_rows_ref(lbl, wt, k)
        if integral:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        lp_score_rows(lbl, wt.cpu(), k)
    with pytest.raises(TypeError):
        lp_score_rows(lbl.long(), wt, k)


@pytest.mark.cuda
def test_dense_round_card_matches_cpu():
    """A dense round on the card (kernel, atomics, threefry on the device)
    returns the CPU path's labels on integral weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = rmat(10, 8, seed=7)
    k = 4
    ell = ell_pack(g)
    rng = np.random.default_rng(1)
    nb = 1 << g.n.bit_length()
    lab = np.full(nb, k, np.int32)
    lab[: g.n] = rng.integers(0, k, g.n)
    nw = np.zeros(nb, np.float32)
    nw[: g.n] = g.nw
    U = float(np.ceil(g.n / k) * 1.05)
    args = (ell.dst.astype(np.int64), ell.w, ell.row_node.astype(np.int64), lab, nw)
    before = lp_score_rows.launches
    on_card = dense_round_device(
        *(torch.from_numpy(a).cuda() for a in args), U, 11, 0.5, g.n, k=k
    ).cpu()
    assert lp_score_rows.launches == before + 1
    on_cpu = dense_round_device(*(torch.from_numpy(a) for a in args), U, 11, 0.5,
                                g.n, k=k)
    assert torch.equal(on_card, on_cpu)
    assert int((on_cpu[: g.n] != torch.from_numpy(lab[: g.n])).sum()) > 0
