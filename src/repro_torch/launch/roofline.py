"""Roofline terms of a dry-run cell (the torch twin of
``repro.launch.roofline``).

Hardware model (``HW``, one NVIDIA H100 SXM, from NVIDIA's H100 data sheet;
the rates assume the card's full 700 W power limit):

  compute term    = FLOPs_per_device / 989e12   (bf16, dense)       [s]
  memory term     = bytes_per_device / 3.35e12  (HBM3)              [s]
  collective term = collective_bytes_per_device / 450e9             [s]
                    (NVLink 4: 900 GB/s per card, 450 GB/s each way)

The FLOPs, bytes and collective bytes come from
``launch.hlo_analysis.count_step``, which runs the cell's step once on
the ``meta`` device; its collective tally takes the place of the
reference's ``collective_bytes(hlo_text)``, which parses XLA's HLO.

MODEL_FLOPS uses the 6·N·D convention (6·N_active·D for MoE; attention
flops excluded), so MODEL_FLOPS / counted FLOPs is the "useful compute"
fraction — remat recompute, dense-MoE waste and padding all push it down.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["HW", "roofline", "roofline_terms", "model_flops", "param_counts"]

HW = {
    "peak_flops": 989e12,   # bf16 dense FLOP/s per card
    "hbm_bw": 3.35e12,      # HBM3 B/s per card
    "link_bw": 450e9,       # NVLink 4 B/s per card, each way
}


def param_counts(cfg) -> Dict[str, float]:
    """(total params, active params) from the config analytically."""
    D, V = cfg.d_model, cfg.vocab
    n_total = 0.0
    n_active = 0.0
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    n_total += emb
    n_active += emb
    for mix, ffnk in cfg.layer_plan():
        if mix in ("attn", "attn_local"):
            h = cfg.n_heads * cfg.d_head
            kvh = cfg.n_kv_heads * cfg.d_head
            a = D * h + 2 * D * kvh + h * D
            n_total += a
            n_active += a
        else:
            s = cfg.ssm
            d_in = s.expand * D
            H = d_in // s.headdim
            a = 2 * D * d_in + 2 * D * s.d_state + D * H + d_in * D
            n_total += a
            n_active += a
        if ffnk == "dense":
            f = D * cfg.d_ff * (3 if cfg.glu else 2)
            n_total += f
            n_active += f
        elif ffnk == "moe":
            per = D * cfg.moe.d_ff * (3 if cfg.glu else 2)
            n_total += per * cfg.moe.n_experts + D * cfg.moe.n_experts
            n_active += per * cfg.moe.topk + D * cfg.moe.n_experts
    return {"total": n_total, "active": n_active}


def model_flops(cfg, shape) -> float:
    """Global MODEL_FLOPS for this cell (6ND train / 2ND inference)."""
    pc = param_counts(cfg)
    n_act = pc["active"]
    if shape.kind == "train":
        return 6.0 * n_act * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.batch * shape.seq
    return 2.0 * n_act * shape.batch  # decode: one token per sequence


def roofline_terms(hc, *, hw: Optional[dict] = None) -> dict:
    """The three terms of ``hc`` (``launch.hlo_analysis.HloCosts``, per
    device) under ``hw`` (default ``HW``), the dominant one and the counts
    they come from."""
    hw = HW if hw is None else hw
    flops_dev = float(hc.flops)
    bytes_dev = float(hc.hbm_bytes)
    coll_dev = float(hc.collective_total)
    terms = {"compute_s": flops_dev / hw["peak_flops"], "memory_s": bytes_dev / hw["hbm_bw"],
             "collective_s": coll_dev / hw["link_bw"]}
    return {
        **terms,
        "dominant": max(terms, key=terms.get),
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": coll_dev,
        "collectives": dict(hc.collective_bytes),
    }


def roofline(hc, n_chips: int, cfg, shape, *, hw: Optional[dict] = None) -> dict:
    """hc: ``launch.hlo_analysis.HloCosts`` (per device); ``hw`` the
    hardware model (default ``HW``)."""
    hw = HW if hw is None else hw
    rl = roofline_terms(hc, hw=hw)
    flops_dev = rl["hlo_flops_per_dev"]
    mf = model_flops(cfg, shape)
    mf_dev = mf / n_chips
    t_bound = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    return {
        **rl,
        "model_flops_global": mf,
        "useful_ratio": (mf_dev / flops_dev) if flops_dev else 0.0,
        # fraction of the compute roofline achieved if the step ran at the
        # bound of its dominant term:
        "roofline_fraction": (mf_dev / hw["peak_flops"]) / t_bound if t_bound else 0.0,
    }
