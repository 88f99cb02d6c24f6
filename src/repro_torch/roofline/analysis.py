"""Roofline terms from dry-run records, with an NVIDIA H100 SXM's
constants in place of the reference's TPU v5e ones
(``src/repro/roofline/analysis.py``):

  compute    = FLOPs / (cards × 989e12 FLOP/s bf16, dense)
  memory     = bytes accessed / (cards × 3.35e12 B/s HBM3)
  collective = collective bytes / (cards × 450e9 B/s NVLink 4, a direction)

plus MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) and the useful-compute
ratio MODEL_FLOPS / counted FLOPs (catches remat and redundant work).
``param_counts`` and ``model_flops`` are the reference's, unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 SXM5 80GB datasheet (nvidia.com/en-us/data-center/h100,
# "H100 SXM" column): BF16 Tensor Core 1,979 TFLOPS with sparsity, so
# 989 TFLOP/s dense; GPU memory bandwidth 3.35 TB/s (HBM3); NVLink 900
# GB/s bidirectional (NVLink 4, 18 links), so 450 GB/s a direction
PEAK_FLOPS = 989e12        # bf16 dense / card
HBM_BW = 3.35e12           # B/s / card
NVLINK_BW = 450e9          # B/s / card, one direction


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic total / active parameter counts."""
    d = cfg.d_model
    V = cfg.vocab
    L = cfg.n_layers
    dh = cfg.resolved_head_dim
    total = V * d * (1 if cfg.tie_embeddings else 2)
    active = total

    def attn_params():
        if cfg.mla:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = 0
            if m.q_lora_rank:
                p += d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
            else:
                p += d * cfg.n_heads * qk
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim
                                                 + m.v_head_dim)
            p += cfg.n_heads * m.v_head_dim * d
            return p
        return d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * dh * d

    def mlp_params(ff):
        return 3 * d * ff

    def ssm_params():
        s = cfg.ssm
        di = s.expand * d
        if s.version == 2:
            nh = di // s.head_dim
            proj = d * (2 * di + 2 * s.n_groups * s.state_dim + nh)
            return proj + di * d
        r = max(1, -(-d // 16))
        return d * 2 * di + di * (r + 2 * s.state_dim) + r * di \
            + di * s.state_dim + di * d

    if cfg.family == "ssm":
        total += L * ssm_params()
        active = total
    elif cfg.family == "hybrid":
        total += L * ssm_params()
        total += attn_params() + mlp_params(cfg.d_ff)   # one shared block
        active = total
    elif cfg.family == "moe":
        m = cfg.moe
        fk = m.first_k_dense
        per_dense = attn_params() + mlp_params(cfg.d_ff)
        per_moe_shared = attn_params() + d * m.n_experts \
            + mlp_params(m.expert_d_ff) * m.n_shared_experts
        per_expert = mlp_params(m.expert_d_ff)
        total += fk * per_dense
        total += (L - fk) * (per_moe_shared + m.n_experts * per_expert)
        active = (V * d * (1 if cfg.tie_embeddings else 2)
                  + fk * per_dense
                  + (L - fk) * (per_moe_shared + m.top_k * per_expert))
        if cfg.mtp_depth:
            total += cfg.mtp_depth * per_dense
            active += cfg.mtp_depth * per_dense
    else:
        per = attn_params() + mlp_params(cfg.d_ff)
        total += L * per
        active = total
        if cfg.mtp_depth:
            total += cfg.mtp_depth * per
    return {"total": float(total), "active": float(active)}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D for train; 2·N_active·D per generated token for decode
    (forward only), per the standard convention."""
    counts = param_counts(cfg)
    n_active = counts["active"]
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def roofline_terms(rec: Dict, cfg: Optional[ModelConfig] = None,
                   shape: Optional[ShapeConfig] = None) -> Dict:
    """rec: one dry-run JSON record, whose flops, bytes_accessed and
    collective_bytes are one card's (``per_device_costs``): each term
    divides by one card's rate, and the step's FLOPs over all cards are
    the record's times ``devices``, as in the reference."""
    chips = rec["devices"]
    compute_s = rec["flops"] / PEAK_FLOPS
    memory_s = rec["bytes_accessed"] / HBM_BW
    collective_s = rec["collective_bytes"] / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    out = dict(terms, dominant=dominant.replace("_s", ""))
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)           # global
        out["model_flops"] = mf
        counted = rec["flops"] * chips
        out["useful_compute_ratio"] = (mf / counted if counted else 0.0)
    return out
