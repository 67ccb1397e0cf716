"""Plain PyTorch reference of the dense family's prefill: a pre-norm
decoder of RMSNorm, rotary (NeoX pairing) multi-head attention with
grouped KV heads and optional QKV bias, and a SwiGLU MLP (the Qwen1.5 /
Qwen2 decoder, Hugging Face ``Qwen2ForCausalLM``), over a prompt from an
empty cache.  It reads the configuration file's own keys and the weights
the benchmark draws, imports nothing of the program, and computes in
float32 with TF32 off; ``precision="float8"`` rounds every matmul's
operands to float8 e4m3 (per-tensor scale), the control below the
configuration's bf16.

Besides the reference: the weights (``make_weights``, in the layout the
port's ``models.transformer.Model`` takes), the sizes and the model FLOPs
a request (``model_flops``)."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.kernels.k5 import attention_work

#: cache entries that are recurrent state, reset before each request
STATE_ENTRIES = ()


def sizes(config: dict) -> Dict[str, int]:
    d, H = config["hidden_size"], config["num_attention_heads"]
    return {"layers": config["num_hidden_layers"], "d": d, "heads": H,
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config.get("head_dim") or d // H,
            "d_ff": config["intermediate_size"], "vocab": config["vocab_size"]}


def model_flops(config: dict, B: int, S: int) -> float:
    """2 x matmul parameters x tokens, causal attention (4 D a live pair,
    the frozen ``attention_work``) and the last-token unembedding."""
    z = sizes(config)
    d, hd, H, K = z["d"], z["head_dim"], z["heads"], z["kv_heads"]
    per_layer = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * z["d_ff"]
    _, attn = attention_work(B, H, K, S, S, hd, True, None, 2)
    return float(z["layers"] * (2 * per_layer * B * S + attn) + 2 * B * d * z["vocab"])


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """Random weights in the configuration's ``torch_dtype``, drawn from
    ``seed`` on ``device`` in one call a kind of leaf (all layers at once),
    at the port's initial scales; the norm scales and biases are drawn too
    (about 1 and 0), so that the comparison covers them."""
    z = sizes(config)
    L, d, H, K, hd, f, V = (z[k] for k in ("layers", "d", "heads", "kv_heads",
                                           "head_dim", "d_ff", "vocab"))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    dtype = getattr(torch, config["torch_dtype"])

    def draw(shape, scale, shift=0.0):
        return torch.randn(shape, generator=g, device=device, dtype=dtype
                           ).mul_(scale).add_(shift)

    stacked = {
        ("attn", "wq"): draw((L, d, H, hd), d ** -0.5),
        ("attn", "wk"): draw((L, d, K, hd), d ** -0.5),
        ("attn", "wv"): draw((L, d, K, hd), d ** -0.5),
        ("attn", "wo"): draw((L, H, hd, d), (H * hd) ** -0.5),
        ("mlp", "w_gate"): draw((L, d, f), d ** -0.5),
        ("mlp", "w_up"): draw((L, d, f), d ** -0.5),
        ("mlp", "w_down"): draw((L, f, d), f ** -0.5),
        ("ln1", "scale"): draw((L, d), 0.1, 1.0),
        ("ln2", "scale"): draw((L, d), 0.1, 1.0),
    }
    if config.get("qkv_bias"):
        stacked[("attn", "bq")] = draw((L, H, hd), 0.1)
        stacked[("attn", "bk")] = draw((L, K, hd), 0.1)
        stacked[("attn", "bv")] = draw((L, K, hd), 0.1)
    layers = []
    for i in range(L):
        layer: dict = {}
        for (part, leaf), t in stacked.items():
            layer.setdefault(part, {})[leaf] = t[i]
        layers.append(layer)
    return {"embed": {"tok": draw((V, d), 1.0), "unembed": draw((d, V), d ** -0.5)},
            "final_norm": {"scale": draw((d,), 0.1, 1.0)},
            "layers": layers}


@contextlib.contextmanager
def _exact_float32():
    """float32 matmuls in float32, not TF32, for as long as it is open."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def to_float8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude onto e4m3's 448), back in float32."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def operand_rounding(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "float32":
        return lambda t: t
    if precision == "float8":
        return to_float8
    raise ValueError(f"unknown precision {precision!r}")


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, cos, sin):
    """NeoX pairing: the first half of each head with the second."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, r, q_block):
    """softmax(q k^T / sqrt(D)) v under a causal mask, in blocks of
    ``q_block`` query rows, each against the keys up to its last row.
    q (B, S, H, D), k, v (B, S, K, D) -> (B, S, H, D)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kh = r(k).repeat_interleave(G, dim=2).transpose(1, 2)     # (B, H, S, D)
    vh = r(v).repeat_interleave(G, dim=2).transpose(1, 2)
    qh = r(q).transpose(1, 2)
    out = torch.empty_like(qh)
    scale = 1.0 / math.sqrt(D)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        scores = torch.matmul(qh[:, :, s0:s1], kh[:, :, :s1].transpose(-1, -2)) * scale
        rows = torch.arange(s0, s1, device=q.device)[:, None]
        cols = torch.arange(s1, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[:, :, s0:s1] = torch.matmul(r(probs), vh[:, :, :s1])
    return out.transpose(1, 2)


@torch.no_grad()
def prefill(weights: dict, config: dict, tokens: torch.Tensor, *,
            precision: str = "float32",
            on_layer: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
            q_block: int = 1024) -> torch.Tensor:
    """The last-token logits (B, V) float32 of ``tokens`` (B, S); each
    layer's cache entries -- k after rotary, v, (B, S, K, D) -- go to
    ``on_layer(i, {"k": k, "v": v})`` as they are computed."""
    z = sizes(config)
    eps = config["rms_norm_eps"]
    theta = float(config["rope_theta"])
    H, K, hd = z["heads"], z["kv_heads"], z["head_dim"]
    r = operand_rounding(precision)

    def mm(a, w):
        return torch.matmul(r(a), r(w.reshape(w.shape[0], -1).float()))

    B, S = tokens.shape
    with _exact_float32():
        pos = torch.arange(S, device=tokens.device, dtype=torch.float32)
        inv = theta ** (-torch.arange(hd // 2, device=tokens.device,
                                      dtype=torch.float32) / (hd // 2))
        ang = pos[:, None] * inv[None, :]
        cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
        x = weights["embed"]["tok"][tokens].float()
        for i, lw in enumerate(weights["layers"]):
            a = lw["attn"]
            h = rms_norm(x, lw["ln1"]["scale"].float(), eps)
            q = mm(h, a["wq"]).reshape(B, S, H, hd)
            k = mm(h, a["wk"]).reshape(B, S, K, hd)
            v = mm(h, a["wv"]).reshape(B, S, K, hd)
            if "bq" in a:
                q, k, v = q + a["bq"].float(), k + a["bk"].float(), v + a["bv"].float()
            q, k = rope(q, cos, sin), rope(k, cos, sin)
            if on_layer is not None:
                on_layer(i, {"k": k, "v": v})
            ctx = causal_attention(q, k, v, r, q_block)
            x = x + mm(ctx.reshape(B, S, H * hd), a["wo"].reshape(H * hd, -1))
            del q, k, v, ctx
            h = rms_norm(x, lw["ln2"]["scale"].float(), eps)
            m = lw["mlp"]
            x = x + mm(F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"]), m["w_down"])
        last = rms_norm(x[:, -1], weights["final_norm"]["scale"].float(), eps)
        return mm(last, weights["embed"]["unembed"])
