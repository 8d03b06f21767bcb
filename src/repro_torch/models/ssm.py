"""The Mamba-2 SSD (state-space duality) layer and the Mamba-2 LM as
``nn.Module``s (counterpart of ``repro.models.ssm``).

Per head, with a (P x N) state:
    H_t = exp(dA_t) * H_{t-1} + dt_t * (x_t ⊗ B_t) ;  y_t = H_t · C_t

Without a state (training, ``api.prefill``) the layer runs the chunked
dual form (Dao & Gu 2024): an attention-like product inside each chunk,
a recurrence over the chunks' summary states from a zero state. With a
state (decode) it runs the recurrence itself, one step per token. The
reference computes both in ``jnp``/``lax``, not in a Pallas kernel, so
here they are PyTorch operations.

Numerics follow ``src/repro/models/ssm.py`` line by line, each with a
test in ``tests/test_torch_ssm.py``: the causal conv's taps summed in
the activations' dtype from tap 0, silu in float32; ``dt`` and ``dA`` in
float32; the decode recurrence and the chunked form in float32, whatever
the config's dtype; the D skip in float32, then the gated RMSNorm. The
decode states are written in place (the reference returns new arrays;
its ``serve_lm`` donates them), and the layers are a Python loop over
:class:`SSMBlock` modules in place of ``lax.scan``. On a mesh the SSD
layer runs whole on every 'model' rank, on the rank's batch rows
(``runtime.tp.whole``): its ``in_proj`` columns are the z / x / B / C /
dt segments, which a column shard over 'model' does not align with, and
the gated RMSNorm reduces over every head (``ROADMAP.md`` queue 3).
Nothing here reads ``cfg.hd``, which divides by mamba2's zero heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.runtime import partition as PT
from repro_torch.runtime import tp
from repro_torch.runtime.partition import current_mesh

F32 = torch.float32
State = Tuple[torch.Tensor, torch.Tensor]     # (conv state, ssm state)


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, conv channels, d_state)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim, s.d_state


def ssm_init(gen: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One layer's parameters with the reference's distributions, drawn on
    the generator's device. ``A_log``, ``Dp`` and ``dt_bias`` are float32
    whatever ``dtype`` is."""
    s = cfg.ssm
    dI, H, convd, N = dims(cfg)
    d_in_proj = 2 * dI + 2 * s.n_groups * N + H
    scale = (2.0 / (cfg.d_model + d_in_proj)) ** 0.5
    dev = gen.device
    return {
        "in_proj": L._normal(gen, (cfg.d_model, d_in_proj), scale, dtype),
        "conv_w": L._normal(gen, (s.d_conv, convd), 0.2, dtype),
        "conv_b": torch.zeros(convd, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                          device=dev)),
        "Dp": torch.ones(H, dtype=F32, device=dev),
        "dt_bias": torch.zeros(H, dtype=F32, device=dev),
        "norm_g": torch.ones(dI, dtype=dtype, device=dev),
        "out_proj": L._normal(gen, (dI, cfg.d_model), scale, dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """(z, xBC, dt) of the input projection."""
    dI, _, _, N = dims(cfg)
    G = cfg.ssm.n_groups
    return torch.tensor_split(zxbcdt, [dI, 2 * dI + 2 * G * N], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d over the sequence. xBC (B, S, C), w (K, C).
    The taps are summed left to right from tap 0 in xBC's dtype, the bias
    added in it, silu taken in float32 and cast back. Returns (out, new
    state): the last K-1 raw inputs, before the silu."""
    K = w.shape[0]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = state
    full = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(full[:, i:i + S] * w[i] for i in range(K))
    new_state = full[:, -(K - 1):]
    return F.silu((out + b).to(F32)).to(xBC.dtype), new_state


def _dt_and_decay(p, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softplus(dt + dt_bias)`` and ``dA = -exp(A_log) * dt``, float32.
    ``jax.nn.softplus`` has no threshold; ``F.softplus`` returns x above
    20, where log1p(exp(x)) rounds to x in float32 all the same."""
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])[None, None, :] * dt


def _decode_scan(h: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                 xs: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence, one step per position, in float32: h (B, H, P, N),
    dt/dA (B, S, H), xs (B, S, H, P), Bh/Ch (B, S, H, N). Returns y (B, S,
    H, P) and the last state. ``torch.einsum`` does not promote mixed
    dtypes as ``jnp.einsum`` does, so C is cast first."""
    a = torch.exp(dA)[..., None, None]                  # (B, S, H, 1, 1)
    ys = []
    for t in range(xs.shape[1]):
        h = a[:, t] * h + (dt[:, t, :, None, None] * xs[:, t, :, :, None]
                           * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t].to(F32)))
    return torch.stack(ys, 1), h


def _chunked_ssd(xs: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor,
                 dt: torch.Tensor, dA: torch.Tensor, Q: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked dual form from a zero state. xs (B, S, H, P), Bh/Ch (B, S,
    H, N), dt/dA (B, S, H). Returns y (B, S, H, P) and the final state
    (B, H, P, N), both float32. S must be a multiple of Q (the reference
    asserts; this raises ``ValueError``)."""
    Bsz, S, H, Phd = xs.shape
    N = Bh.shape[-1]
    if S % Q:
        raise ValueError(f"chunked SSD: the sequence length {S} is not a "
                         f"multiple of the chunk {Q}")
    nC = S // Q

    def r(t):
        return t.reshape(Bsz, nC, Q, *t.shape[2:])
    xc, Bc, Cc = r(xs.to(F32)), r(Bh.to(F32)), r(Ch.to(F32))
    dtc, dAc = r(dt), r(dA)
    Lc = torch.cumsum(dAc, dim=2)                       # (B, nC, Q, H)
    # intra-chunk term: the log decay is clamped above the diagonal
    # *before* exp, so no exp(+big) = inf meets a zero there (0 * inf is
    # NaN in the backward pass), then those slots are set to 0
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]  # (B, nC, Q, Q, H)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xs.device))
    mask = mask[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, -1e30))
    decay = torch.where(mask, decay, 0.0)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc) * decay
    y_diag = torch.einsum("bcqkh,bckh,bckhp->bcqhp", scores, dtc, xc)
    # each chunk's summary state, then the recurrence over chunks
    tail = torch.exp(Lc[:, :, -1:, :] - Lc)             # (B, nC, Q, H)
    S_c = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn", tail, dtc, Bc, xc)
    chunk_decay = torch.exp(Lc[:, :, -1, :])            # (B, nC, H)
    h = xs.new_zeros((Bsz, H, Phd, N), dtype=F32)
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(Lc), Cc,
                           torch.stack(h_prevs, 1))
    return (y_diag + y_inter).reshape(Bsz, S, H, Phd), h


def _skip_and_gate(p, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The D skip in float32, cast to ``dtype``, times silu(z) (float32,
    cast), then RMSNorm (eps 1e-5, float32, cast) and *then* ``norm_g``.
    y (B, S, H, P) float32, xs (B, S, H, P), z (B, S, d_inner)."""
    B, S = y.shape[:2]
    y = y + p["Dp"][None, None, :, None] * xs.to(F32)
    y = y.reshape(B, S, -1).to(dtype)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    yf = y.to(F32)
    return (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-5)
            ).to(dtype) * p["norm_g"]


def ssm_forward(p, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, State]:
    """x (B, S, D). ``state`` None: the chunked form from a zero state.
    ``state`` (conv (B, K-1, convd), ssm (B, H, P, N) float32): the
    recurrence, and both tensors are overwritten with the new state and
    returned. Returns (out, new state)."""
    s = cfg.ssm
    dI, H, _, N = dims(cfg)
    B, S, _ = x.shape
    p = {k: tp.whole(v) for k, v in p.items()}
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    # on a mesh the layer runs whole: a placed state is gathered, and
    # each rank writes back its shard
    whole = None if state is None else tuple(map(tp.state_whole, state))
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   None if state is None else whole[0])
    xs, Bc, Cc = torch.tensor_split(xBC, [dI, dI + s.n_groups * N], dim=-1)
    xs = xs.reshape(B, S, H, s.head_dim)
    # groups broadcast to heads as jnp.repeat does: each group rep times
    # in a row
    rep = H // s.n_groups
    Bh = torch.repeat_interleave(Bc.reshape(B, S, s.n_groups, N), rep, 2)
    Ch = torch.repeat_interleave(Cc.reshape(B, S, s.n_groups, N), rep, 2)
    dt, dA = _dt_and_decay(p, dt)
    if state is None:
        y, h = _chunked_ssd(xs, Bh, Ch, dt, dA, s.chunk)
        new_state = (conv_state, h)
    else:
        y, h = _decode_scan(whole[1], dt, dA, xs, Bh, Ch)
        tp.state_write(state[0], conv_state)
        tp.state_write(state[1], h)
        new_state = state
    y = _skip_and_gate(p, y, xs, z, x.dtype)
    return y @ p["out_proj"], new_state


def init_state(cfg: ArchConfig, batch: int, device="cuda") -> State:
    """One layer's zeroed decode state: the conv state in the config's
    dtype, the SSM state in float32."""
    dI, H, convd, N = dims(cfg)
    return (torch.zeros(batch, cfg.ssm.d_conv - 1, convd,
                        dtype=cfg.torch_dtype, device=device),
            torch.zeros(batch, H, cfg.ssm.head_dim, N, dtype=F32,
                        device=device))


def init_lm_states(cfg: ArchConfig, batch: int, device="cuda") -> State:
    """The stacked decode states: (L, B, K-1, convd) in the config's dtype
    and (L, B, H, P, N) in float32, zeroed; on a mesh (``batch`` this
    rank's rows) DTensors placed by ``partition.ssm_state_specs``."""
    if current_mesh() is not None:
        dI, H, convd, N = dims(cfg)
        conv_spec, ssm_spec = PT.ssm_state_specs(tp.single_request(batch))
        Lc, K = cfg.n_layers, cfg.ssm.d_conv
        return (tp.state_zeros((Lc, batch, K - 1, convd), cfg.torch_dtype,
                               device, conv_spec),
                tp.state_zeros((Lc, batch, H, cfg.ssm.head_dim, N), F32,
                               device, ssm_spec))
    conv, h = init_state(cfg, batch, device)
    Lc = cfg.n_layers
    return (conv[None].repeat(Lc, 1, 1, 1), h[None].repeat(Lc, 1, 1, 1, 1))


# ---------------------------------------------------------------------------
# the Mamba-2 language model (embed, SSD blocks, tied logits)
# ---------------------------------------------------------------------------

class SSMBlock(nn.Module):
    """One pre-norm SSD layer on a residual: ``x + ssm(rmsnorm(x))``.
    ``tree`` is the reference's layer subtree (``norm``, ``ssm``)."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.norm = nn.Parameter(tree["norm"])
        self.ssm = nn.ParameterDict(tree["ssm"])

    def forward(self, x: torch.Tensor, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, State]:
        h, new_state = ssm_forward(self.ssm, self.cfg,
                                   L.rmsnorm(x, tp.whole(self.norm)), state)
        return x + h, new_state


class Mamba2LM(nn.Module):
    """Token embedding, ``n_layers`` :class:`SSMBlock`s, the final norm and
    logits tied to the embedding. ``tree`` holds the reference's parameter
    tree with the layer stack as a list."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{cfg.arch_id}: {len(tree['layers'])} layers "
                             f"given, the config has {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(SSMBlock(cfg, t) for t in tree["layers"])

    def forward(self, tokens: torch.Tensor, states: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State], torch.Tensor]:
        """Returns (logits, states, aux = 0). ``states`` are the stacked
        per-layer decode states, updated in place; None runs the chunked
        form."""
        embed = tp.whole(self.embed)
        x = tp.activations(embed[tokens.long()])
        for i, block in enumerate(self.layers):
            x, _ = block(tp.local(x), None if states is None
                         else (states[0][i], states[1][i]))
            x = tp.activations(x)
        x = L.rmsnorm(tp.local(x), tp.whole(self.final_norm))
        return (x @ embed.T, states,
                torch.zeros((), dtype=F32, device=x.device))


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Mamba2LM:
    """Random parameters with the reference's distributions, drawn on the
    generator's device (the values differ from the reference's)."""
    dt = cfg.torch_dtype
    ones = lambda: torch.ones(cfg.d_model, dtype=dt,     # noqa: E731
                              device=gen.device)
    layers = [{"norm": ones(), "ssm": ssm_init(gen, cfg, dt)}
              for _ in range(cfg.n_layers)]
    return Mamba2LM(cfg, {"embed": L.embed_init(gen, cfg.vocab_padded,
                                                cfg.d_model, dt),
                          "final_norm": ones(), "layers": layers})


def lm_forward(params: Mamba2LM, cfg: ArchConfig, tokens: torch.Tensor,
               states: Optional[State] = None
               ) -> Tuple[torch.Tensor, Optional[State], torch.Tensor]:
    """The reference's ``lm_forward(params, cfg, tokens, states)``."""
    if params.cfg != cfg:
        raise ValueError(f"lm_forward: the parameters were built for "
                         f"{params.cfg.arch_id}, not this config")
    return params(tokens, states)
