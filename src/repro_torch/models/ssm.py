"""Selective state-space layers: Mamba1 (falcon-mamba) and Mamba2's SSD
(zamba2), the reference's ``models/ssm.py`` off a mesh.

The reference has no Pallas kernel here, so this module is plain PyTorch:
  - Mamba1: the scan h_t = a_t h_{t-1} + bx_t, y_t = <h_t, C_t> runs over
    chunks of ``CHUNK`` steps carrying the (B, Di, N) state; inside a chunk
    the discretized (a, bx) are formed for the chunk only and the
    recurrence is a loop over its steps, so nothing (B, S, Di, N)-shaped is
    ever live (the reference's chunked ``associative_scan``). h_t is never
    formed from exp(cumsum(log a)), which underflows over a chunk at
    falcon-mamba's A.
  - Mamba2: the SSD block decomposition: within a chunk, causal products of
    C·Bᵀ weighted by the decay between positions; each chunk's end state;
    the recurrence over chunk states; their contribution to later chunks.

Decode carries (the conv window, the SSM state) and costs O(1) a token.
The shapes, split orders and inits are the reference's; its sharding hints
do nothing off a mesh and have no counterpart. Every op runs on its
inputs' device, with no host sync.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

CHUNK = 256


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K)) + b


def _conv_step(window: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Single-token depthwise conv. window: (B, K, C); w: (K, C)."""
    return torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()


def _conv_state(feed: torch.Tensor, K: int) -> torch.Tensor:
    """The last K - 1 inputs of the conv (zeros before the first), (B, K -
    1, C): the decode window a prefill leaves."""
    return F.pad(feed, (0, 0, K - 1, 0))[:, feed.shape[1]:].contiguous()


# ------------------------------------------------------------------- mamba1

def _conv_init(gen: torch.Generator, k: int, channels: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    """The depthwise conv's (K, C) weights, N(0, 0.1²), drawn in fp32."""
    w = torch.randn((k, channels), generator=gen, device=device)
    return (w * 0.1).to(dtype)


def mamba1_init(gen: torch.Generator, cfg: ModelConfig, device,
                dtype: torch.dtype = torch.float32) -> Dict:
    """``w_in`` (D, 2 Di) to x and z; ``conv`` (K, Di) N(0, 0.1²);
    ``w_x`` to [dt (R), B (N), C (N)]; ``w_dt`` (R, Di); ``A_log`` =
    log(1..N) for every channel; ``D`` ones; ``w_out`` (Di, D). Drawn in
    fp32 and cast to ``dtype``, except ``dt_bias``, ``A_log`` and ``D``,
    which stay fp32 as the reference's do."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    r = _dt_rank(cfg)
    A = torch.arange(1, s.state_dim + 1, dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, d, 2 * di, device, dtype),
        "conv": _conv_init(gen, s.conv_dim, di, device, dtype),
        "conv_b": torch.zeros((di,), device=device, dtype=dtype),
        "w_x": dense_init(gen, di, r + 2 * s.state_dim, device, dtype),
        "w_dt": dense_init(gen, r, di, device, dtype),
        "dt_bias": torch.zeros((di,), device=device),
        "A_log": torch.log(A).expand(di, s.state_dim).contiguous(),
        "D": torch.ones((di,), device=device),
        "w_out": dense_init(gen, di, d, device, dtype),
    }


def _mamba1_ssm_inputs(params: Dict, cfg: ModelConfig, xc: torch.Tensor):
    """xc: the conv'ed and silu'ed (B, S, Di) -> (dt (B, S, Di), B (B, S,
    N), C (B, S, N)), fp32; dt = softplus(dt_raw · w_dt + dt_bias)."""
    s = cfg.ssm
    r = _dt_rank(cfg)
    proj = xc @ params["w_x"]
    dt_raw, Bmat, Cmat = torch.split(proj, [r, s.state_dim, s.state_dim],
                                     dim=-1)
    dt = F.softplus((dt_raw @ params["w_dt"]).float() + params["dt_bias"])
    return dt, Bmat.float(), Cmat.float()


def _discretize(params: Dict, dt: torch.Tensor, Bmat: torch.Tensor,
                xc: torch.Tensor):
    """(a, bx), each (B, C, Di, N), for dt, xc (B, C, Di) and B (B, C,
    N): a = exp(dt·A), bx = dt·x·B."""
    A = -torch.exp(params["A_log"])
    a = (dt[..., None] * A).exp_()
    bx = (dt * xc.float())[..., None] * Bmat[:, :, None, :]
    return a, bx


def _linear_recurrence_chunked(params: Dict, dt: torch.Tensor,
                               Bmat: torch.Tensor, xc: torch.Tensor,
                               h0: torch.Tensor, Cmat: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + bx_t; y_t = <h_t, C_t>. dt, xc: (B, S, Di);
    Bmat, Cmat: (B, S, N); h0: (B, Di, N). Returns (y (B, S, Di), the last
    state). Each chunk of ``CHUNK`` steps forms its (a, bx), walks its
    steps and contracts its states with C at once. The steps are read
    through one ``unbind`` of a and bx each: indexing a[:, t] would give
    every step's backward a zero-filled gradient of the whole chunk to add
    up (2 × 256 of 1.07 GB a layer at falcon-mamba-7b's B 8 × S 256)."""
    ys, h = [], h0
    for c0 in range(0, dt.shape[1], CHUNK):
        part = slice(c0, c0 + CHUNK)
        a, bx = _discretize(params, dt[:, part], Bmat[:, part], xc[:, part])
        states = []
        for a_t, bx_t in zip(torch.unbind(a, 1), torch.unbind(bx, 1)):
            h = torch.addcmul(bx_t, a_t, h)
            states.append(h)
        ys.append(torch.einsum("bcdn,bcn->bcd", torch.stack(states, 1),
                               Cmat[:, part]))
    return torch.cat(ys, 1), h


def _mamba1_out(params: Dict, xc: torch.Tensor, z: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    y = y + params["D"] * xc.float()
    y = (y * F.silu(z.float())).to(z.dtype)
    return y @ params["w_out"]


def mamba1_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), {"h" (B, Di, N), "conv" (B, K − 1,
    Di)})."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    B = x.shape[0]
    x_in, z = torch.split(x @ params["w_in"], [di, di], dim=-1)
    xc = F.silu(_causal_conv(x_in, params["conv"], params["conv_b"]))
    dt, Bmat, Cmat = _mamba1_ssm_inputs(params, cfg, xc)
    h0 = torch.zeros((B, di, s.state_dim), dtype=torch.float32,
                     device=x.device)
    y_scan, h_last = _linear_recurrence_chunked(params, dt, Bmat, xc.float(),
                                                h0, Cmat)
    y = _mamba1_out(params, xc, z, y_scan)
    return y, {"h": h_last, "conv": _conv_state(x_in, s.conv_dim)}


def mamba1_apply(params: Dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return mamba1_prefill(params, cfg, x)[0]


def mamba1_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]):
    """x: (B, 1, D); cache h (B, Di, N), conv (B, K − 1, Di). O(1) a token.
    The new states are written into the cache tensors in place; the same
    tensors are returned."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    x_in, z = torch.split(x @ params["w_in"], [di, di], dim=-1)
    window = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)
    xc = F.silu(_conv_step(window[:, -s.conv_dim:], params["conv"],
                           params["conv_b"]))[:, None].to(x_in.dtype)
    dt, Bmat, Cmat = _mamba1_ssm_inputs(params, cfg, xc)
    a, bx = _discretize(params, dt, Bmat, xc)
    h = cache["h"]
    h.copy_(a[:, 0] * h + bx[:, 0])
    y = torch.einsum("bdn,bn->bd", h, Cmat[:, 0])[:, None]
    cache["conv"].copy_(window[:, 1:])
    return _mamba1_out(params, xc, z, y), cache


# ------------------------------------------------------------------- mamba2

def _mamba2_dims(cfg: ModelConfig):
    """(Di, SSD heads, G·N)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, s.n_groups * s.state_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, device,
                dtype: torch.dtype = torch.float32) -> Dict:
    """``w_in`` (D, 2 Di + 2 G·N + H) to [x, z, B, C, dt]; ``conv`` (K, Di
    + 2 G·N) N(0, 0.1²); ``A_log``, ``dt_bias`` zeros and ``D`` ones, each
    (H,); ``norm_scale`` (Di,) ones; ``w_out`` (Di, D). Drawn in fp32 and
    cast to ``dtype``, except ``A_log``, ``dt_bias`` and ``D``, which stay
    fp32 as the reference's do."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, gn = _mamba2_dims(cfg)
    conv_ch = di + 2 * gn
    return {
        "w_in": dense_init(gen, d, 2 * di + 2 * gn + nh, device, dtype),
        "conv": _conv_init(gen, s.conv_dim, conv_ch, device, dtype),
        "conv_b": torch.zeros((conv_ch,), device=device, dtype=dtype),
        "A_log": torch.zeros((nh,), device=device),
        "dt_bias": torch.zeros((nh,), device=device),
        "D": torch.ones((nh,), device=device),
        "norm_scale": torch.ones((di,), device=device, dtype=dtype),
        "w_out": dense_init(gen, di, d, device, dtype),
    }


def _by_head(t: torch.Tensor, H: int) -> torch.Tensor:
    """(..., G, C, N) -> (..., H, C, N): head h reads group h // (H / G)."""
    G = t.shape[-3]
    shape = t.shape[:-3] + (G, H // G) + t.shape[-2:]
    return t.unsqueeze(-3).expand(shape).reshape(
        t.shape[:-3] + (H,) + t.shape[-2:])


def _segment_sums(a: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (..., C, C): entry (q, k) is the sum of a over (k, q],
    −inf above the diagonal. Each is summed from its own terms, not as a
    difference of two running sums, which over a chunk reach about −200
    at zamba2's decays and would leave an fp32 rounding of ~1e-5 in the
    small differences that matter."""
    C = a.shape[-1]
    ones = torch.ones((C, C), dtype=torch.bool, device=a.device)
    terms = a[..., :, None].expand(a.shape + (C,)).masked_fill(
        ~ones.tril(-1), 0.0)                     # (q', k): a_q' for k < q'
    return torch.cumsum(terms, dim=-2).masked_fill_(~ones.tril(), -math.inf)


def _ssd_chunked(xh: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD (Mamba2) in chunked form. xh: (B, S, H, P) dt-scaled inputs;
    a_log: (B, S, H) log decay (<= 0); b, c: (B, S, G, N); h0: (B, H, P,
    N), which feeds chunk 0 through the off-diagonal term. Returns (y (B,
    S, H, P), the last state).

    Chunks are ``CHUNK`` long (one chunk of S when S is shorter; the last
    is zero-padded, which adds nothing). Work runs head-major, (B, chunk,
    H, position, ·), so that each product is one batched matmul. The
    decays within a chunk are segment sums (:func:`_segment_sums`) where
    the reference takes differences of running sums: the same values,
    closer to exact arithmetic; above the diagonal they are −inf before
    the exponential, so nothing overflows there."""
    Bsz, S, H, P = xh.shape
    n_chunks = -(-S // CHUNK)
    C_ = CHUNK if n_chunks > 1 else S
    pad = n_chunks * C_ - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    x = xh.reshape(Bsz, n_chunks, C_, H, P).transpose(2, 3)   # (B,u,H,C,P)
    a = a_log.reshape(Bsz, n_chunks, C_, H).transpose(2, 3)   # (B,u,H,C)
    cum = torch.cumsum(a, dim=-1)
    bg = b.reshape(Bsz, n_chunks, C_, -1, b.shape[-1]).transpose(2, 3)
    cg = c.reshape(Bsz, n_chunks, C_, -1, c.shape[-1]).transpose(2, 3)

    # intra-chunk (diagonal blocks): y_q = sum_{k<=q} (c_q.b_k)
    # exp(seg_qk) x_k, seg_qk = sum_{k<j<=q} a_j (= cum_q - cum_k)
    decay = _segment_sums(a).exp_()                            # (B,u,H,Cq,Ck)
    s_qk = cg @ bg.transpose(-1, -2)                           # (B,u,G,Cq,Ck)
    G = s_qk.shape[2]
    w = (decay.reshape(Bsz, n_chunks, G, H // G, C_, C_)
         * s_qk.unsqueeze(3)).reshape(Bsz, n_chunks, H, C_, C_)
    y = w @ x                                                  # (B,u,H,C,P)

    # chunk end states: sum_k exp(cum_end - cum_k) x_k (x) b_k
    to_end = decay[..., -1, :]                                 # (B,u,H,C)
    states = (x * to_end[..., None]).transpose(-1, -2) @ _by_head(bg, H)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(cum[..., -1])                      # (B,u,H)
    h, before = h0, []
    for u in range(n_chunks):
        before.append(h)
        h = h * chunk_decay[:, u, :, None, None] + states[:, u]
    h_prev = torch.stack(before, 1)                            # (B,u,H,P,N)

    # off-diagonal: y_q += (c_q exp(cum_q)) . h_prev
    from_start = _by_head(cg, H) * torch.exp(cum)[..., None]   # (B,u,H,C,N)
    y = y + from_start @ h_prev.transpose(-1, -2)
    y = y.transpose(2, 3).reshape(Bsz, n_chunks * C_, H, P)
    return y[:, :S], h


def _mamba2_split(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    """(x, z, B, C, dt_raw) from ``w_in``."""
    di, nh, gn = _mamba2_dims(cfg)
    return torch.split(x @ params["w_in"], [di, di, gn, gn, nh], dim=-1)


def _mamba2_prep(params: Dict, cfg: ModelConfig, xin_c: torch.Tensor,
                 dt_raw: torch.Tensor):
    """(xh (B, S, H, P) = x · dt, a_log (B, S, H) = dt · A), fp32, with dt
    = softplus(dt_raw + dt_bias) and A = −exp(A_log)."""
    s = cfg.ssm
    _, nh, _ = _mamba2_dims(cfg)
    B, S = xin_c.shape[:2]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a_log = dt * -torch.exp(params["A_log"])
    xh = xin_c.reshape(B, S, nh, s.head_dim).float() * dt[..., None]
    return xh, a_log


def _mamba2_out(params: Dict, cfg: ModelConfig, y: torch.Tensor,
                xin_c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """+ D·x, then the gated RMSNorm (eps 1e-5), then ``w_out``."""
    s = cfg.ssm
    di, nh, _ = _mamba2_dims(cfg)
    B, S = z.shape[:2]
    y = y + params["D"][:, None] * xin_c.reshape(B, S, nh,
                                                 s.head_dim).float()
    y = y.reshape(B, S, di) * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5) * params["norm_scale"].float()
    return y.to(z.dtype) @ params["w_out"]


def _mamba2_bc(cfg: ModelConfig, bc: torch.Tensor):
    """The conv'ed [B, C] (..., 2 G·N) as two fp32 (..., G, N)."""
    s = cfg.ssm
    b, c = bc.float().chunk(2, dim=-1)
    shape = bc.shape[:-1] + (s.n_groups, s.state_dim)
    return b.reshape(shape), c.reshape(shape)


def mamba2_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), {"h" (B, H, P, N), "conv" (B, K − 1,
    Di + 2 G·N)})."""
    s = cfg.ssm
    di, nh, _ = _mamba2_dims(cfg)
    B = x.shape[0]
    xin, z, b, c, dt = _mamba2_split(params, cfg, x)
    conv_feed = torch.cat([xin, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_feed, params["conv"],
                                   params["conv_b"]))
    xin_c, bc = conv_out[..., :di], conv_out[..., di:]
    xh, a_log = _mamba2_prep(params, cfg, xin_c, dt)
    bmat, cmat = _mamba2_bc(cfg, bc)
    h0 = torch.zeros((B, nh, s.head_dim, s.state_dim), dtype=torch.float32,
                     device=x.device)
    y, h_last = _ssd_chunked(xh, a_log, bmat, cmat, h0)
    out = _mamba2_out(params, cfg, y, xin_c, z)
    return out, {"h": h_last, "conv": _conv_state(conv_feed, s.conv_dim)}


def mamba2_apply(params: Dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return mamba2_prefill(params, cfg, x)[0]


def mamba2_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]):
    """x: (B, 1, D); cache h (B, H, P, N), conv (B, K − 1, Di + 2 G·N).
    One step of the SSD recurrence, O(1) a token. The new states are
    written into the cache tensors in place; the same tensors are
    returned."""
    s = cfg.ssm
    di, nh, _ = _mamba2_dims(cfg)
    xin, z, b, c, dt = _mamba2_split(params, cfg, x)
    window = torch.cat([cache["conv"].to(x.dtype),
                        torch.cat([xin, b, c], dim=-1)], dim=1)
    conv_out = F.silu(_conv_step(window[:, -s.conv_dim:], params["conv"],
                                 params["conv_b"]))[:, None].to(x.dtype)
    xin_c, bc = conv_out[..., :di], conv_out[..., di:]
    xh, a_log = _mamba2_prep(params, cfg, xin_c, dt)         # (B,1,H,P)
    bmat, cmat = _mamba2_bc(cfg, bc[:, 0])                   # (B,G,N)
    b_h = _by_head(bmat[..., None, :], nh)[..., 0, :]        # (B,H,N)
    c_h = _by_head(cmat[..., None, :], nh)[..., 0, :]
    h = cache["h"]
    h.copy_(h * torch.exp(a_log[:, 0])[..., None, None]
            + xh[:, 0, :, :, None] * b_h[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, c_h)[:, None]        # (B,1,H,P)
    cache["conv"].copy_(window[:, 1:])
    return _mamba2_out(params, cfg, y, xin_c, z), cache
