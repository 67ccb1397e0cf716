"""Plain PyTorch reference of the SSM family's prefill: a pre-norm stack
of Mamba-1 mixers (Gu and Dao, arXiv:2312.00752, Algorithm 2: in-projection
to x and a gate z, a depthwise causal conv and SiLU on x, the selective
scan with dt = softplus(x W_dt + b_dt), A = -exp(A_log), a skip D x, the
output gated by SiLU(z)), RMSNorm before each mixer and at the end, over a
prompt from zero conv and scan states.  It reads the configuration file's
own keys and the weights the benchmark draws, imports nothing of the
program, and computes in float32 with TF32 off; ``precision="float8"``
rounds every matmul's operands to float8 e4m3 (per-tensor scale), the
control below the configuration's bf16.

FalconMamba's RMS norms on B, C and dt (its ``mixer_rms_eps``) are not in
the port, and so not here: the configuration file says so under
``assumed``.

Besides the reference: the weights (``make_weights``, in the layout the
port's ``models.transformer.Model`` takes), the sizes and the model FLOPs
a request (``model_flops``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.dense import _exact_float32, operand_rounding, rms_norm

#: cache entries that are recurrent state, reset before each request
STATE_ENTRIES = ("conv", "ssm")


def sizes(config: dict) -> Dict[str, int]:
    d = config["hidden_size"]
    return {"layers": config["num_hidden_layers"], "d": d,
            "d_inner": config["intermediate_size"],
            "state": config["state_size"], "conv": config["conv_kernel"],
            "dt_rank": config["time_step_rank"], "vocab": config["vocab_size"]}


def model_flops(config: dict, B: int, S: int) -> float:
    """2 x matmul parameters x tokens (in-projection, x -> dt / B / C, dt
    projection, out-projection) and the last-token unembedding."""
    z = sizes(config)
    d, din, n, r = z["d"], z["d_inner"], z["state"], z["dt_rank"]
    per_layer = d * 2 * din + din * (r + 2 * n) + r * din + din * d
    return float(2 * z["layers"] * per_layer * B * S + 2 * B * d * z["vocab"])


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """Random weights in the configuration's ``torch_dtype``, drawn from
    ``seed`` on ``device`` in one call a kind of leaf (all layers at once),
    at the port's initial scales (dt's bias from dt uniform in [0.001,
    0.1], A_log = log(1..N)); the norm scales, the conv bias and D are
    drawn too, so that the comparison covers them."""
    z = sizes(config)
    L, d, din, n, w, r, V = (z[k] for k in ("layers", "d", "d_inner", "state",
                                            "conv", "dt_rank", "vocab"))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    dtype = getattr(torch, config["torch_dtype"])

    def draw(shape, scale, shift=0.0):
        return torch.randn(shape, generator=g, device=device, dtype=dtype
                           ).mul_(scale).add_(shift)

    dt = torch.rand((L, din), generator=g, device=device).mul_(0.099).add_(0.001)
    stacked = {
        ("mamba", "w_in"): draw((L, d, 2 * din), d ** -0.5),
        ("mamba", "conv_w"): draw((L, w, din), 0.5),
        ("mamba", "conv_b"): draw((L, din), 0.1),
        ("mamba", "w_xdbc"): draw((L, din, r + 2 * n), din ** -0.5),
        ("mamba", "w_dt"): draw((L, r, din), r ** -0.5),
        ("mamba", "dt_bias"): dt.expm1_().log_().to(dtype),
        ("mamba", "A_log"): torch.arange(1, n + 1, device=device, dtype=torch.float32
                                         ).log_().expand(L, din, n).to(dtype),
        ("mamba", "D"): draw((L, din), 0.1, 1.0),
        ("mamba", "w_out"): draw((L, din, d), din ** -0.5),
        ("ln", "scale"): draw((L, d), 0.1, 1.0),
    }
    layers = []
    for i in range(L):
        layer: dict = {}
        for (part, leaf), t in stacked.items():
            layer.setdefault(part, {})[leaf] = t[i]
        layers.append(layer)
    return {"embed": {"tok": draw((V, d), 1.0), "unembed": draw((d, V), d ** -0.5)},
            "final_norm": {"scale": draw((d,), 0.1, 1.0)},
            "layers": layers}


def softplus(x):
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan(u, dt, Bm, Cm, A, chunk):
    """h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t from h_0 = 0, y_t = h_t C_t,
    step by step in float32, the discretised terms made a chunk of steps at
    a time.  u, dt (B, S, Din), Bm, Cm (B, S, N), A (Din, N) -> (y (B, S,
    Din), h_S (B, Din, N))."""
    Bsz, S, Din = u.shape
    h = torch.zeros((Bsz, Din, A.shape[1]), device=u.device)
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        dtc = dt[:, c0:c1].transpose(0, 1)[..., None]              # (c, B, Din, 1)
        dA = torch.exp(dtc * A)
        dBu = (dtc * u[:, c0:c1].transpose(0, 1)[..., None]) \
            * Bm[:, c0:c1].transpose(0, 1)[:, :, None, :]
        hs = torch.empty_like(dA)
        for t in range(c1 - c0):
            h = torch.addcmul(dBu[t], dA[t], h, out=hs[t])
        ys.append(torch.einsum("tbdn,tbn->btd", hs, Cm[:, c0:c1].transpose(0, 1)))
    return torch.cat(ys, dim=1), h.clone()


@torch.no_grad()
def prefill(weights: dict, config: dict, tokens: torch.Tensor, *,
            precision: str = "float32",
            on_layer: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
            chunk: int = 256) -> torch.Tensor:
    """The last-token logits (B, V) float32 of ``tokens`` (B, S); each
    layer's cache entries -- the conv state (the last conv_width - 1 inputs
    of the conv, (B, W - 1, Din)) and the scan state h_S (B, Din, N) -- go
    to ``on_layer(i, {"conv": ..., "ssm": ...})`` as they are computed."""
    z = sizes(config)
    eps = config["layer_norm_epsilon"]
    din, n, r, W = z["d_inner"], z["state"], z["dt_rank"], z["conv"]
    rnd = operand_rounding(precision)

    def mm(a, w):
        return torch.matmul(rnd(a), rnd(w.float()))

    B, S = tokens.shape
    with _exact_float32():
        x = weights["embed"]["tok"][tokens].float()
        for i, lw in enumerate(weights["layers"]):
            m = lw["mamba"]
            h = rms_norm(x, lw["ln"]["scale"].float(), eps)
            xz = mm(h, m["w_in"])
            u, gate = xz[..., :din], xz[..., din:]
            padded = torch.cat([u.new_zeros((B, W - 1, din)), u], dim=1)
            conv = m["conv_b"].float().expand(B, S, din).clone()
            for j in range(W):
                conv += padded[:, j:j + S] * m["conv_w"][j].float()
            conv_state = padded[:, S:]
            u = F.silu(conv)
            del conv, padded
            dbc = mm(u, m["w_xdbc"])
            dt = softplus(mm(dbc[..., :r], m["w_dt"]) + m["dt_bias"].float())
            Bm, Cm = dbc[..., r:r + n], dbc[..., r + n:]
            y, h_last = selective_scan(u, dt, Bm, Cm, -torch.exp(m["A_log"].float()), chunk)
            if on_layer is not None:
                on_layer(i, {"conv": conv_state, "ssm": h_last})
            y = (y + m["D"].float() * u) * F.silu(gate)
            x = x + mm(y, m["w_out"])
            del xz, u, gate, dbc, dt, y
        last = rms_norm(x[:, -1], weights["final_norm"]["scale"].float(), eps)
        return mm(last, weights["embed"]["unembed"])
