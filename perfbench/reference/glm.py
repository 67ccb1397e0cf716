"""Plain PyTorch reference of the GLM family's prefill: ChatGLM2 / ChatGLM3
(``ChatGLMModel``, ``modeling_chatglm.py``), a pre-norm decoder of RMSNorm,
multi-query attention over ``multi_query_group_num`` KV groups with a bias
on the QKV projection only, ChatGLM's rotary on the first half of each
head in interleaved pairs, and a SwiGLU MLP, over a prompt from an empty
cache.  It reads ChatGLM's own configuration keys and the weights the
benchmark draws, imports nothing of the program, and computes in float32
with TF32 off; ``precision="float8"`` rounds every matmul's operands to
float8 e4m3 (per-tensor scale), the control below the configuration's
bf16.

Departures from the published model, none of which changes the
mathematics:

- the weights are in the port's split layout (``wq``, ``wk``, ``wv`` and
  their biases in place of ChatGLM's fused ``query_key_value``;
  ``w_gate`` and ``w_up`` in place of its fused ``dense_h_to_4h``, whose
  first half is the gate); the MLP's input projection is that fused
  matrix, put back together here;
- the weights are drawn in the configuration's ``torch_dtype`` (bf16; the
  published checkpoint is float16), and ChatGLM's rotary cache, which it
  rounds to the model's dtype, stays float32 here;
- only the flags ChatGLM3-6B sets are implemented; ``sizes`` refuses the
  others.

Besides the reference: the weights (``make_weights``, in the layout the
port's ``models.transformer.Model`` takes) and the model FLOPs a request
(``model_flops``), both the dense family's under ChatGLM's keys, and the
sizes."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import dense
from perfbench.reference.dense import _exact_float32, operand_rounding, rms_norm

#: cache entries that are recurrent state, reset before each request
STATE_ENTRIES = ()

#: the flags the reference implements, at the value it implements
FLAGS = {"rmsnorm": True, "original_rope": True, "post_layer_norm": True,
         "add_qkv_bias": True, "add_bias_linear": False,
         "apply_residual_connection_post_layernorm": False,
         "multi_query_attention": True, "tie_word_embeddings": False}


def sizes(config: dict) -> Dict[str, int]:
    for flag, want in FLAGS.items():
        if bool(config.get(flag, want)) != want:
            raise ValueError(f"the GLM reference implements {flag}={want} only, "
                             f"not {config[flag]!r}")
    return {"layers": config["num_layers"], "d": config["hidden_size"],
            "heads": config["num_attention_heads"],
            "kv_heads": config["multi_query_group_num"], "head_dim": config["kv_channels"],
            "d_ff": config["ffn_hidden_size"], "vocab": config["padded_vocab_size"]}


def _as_dense(config: dict) -> dict:
    """The configuration under the dense family's keys."""
    z = sizes(config)
    return {"num_hidden_layers": z["layers"], "hidden_size": z["d"],
            "num_attention_heads": z["heads"], "num_key_value_heads": z["kv_heads"],
            "head_dim": z["head_dim"], "intermediate_size": z["d_ff"],
            "vocab_size": z["vocab"], "torch_dtype": config["torch_dtype"],
            "qkv_bias": True}


def model_flops(config: dict, B: int, S: int) -> float:
    """The dense family's count: 2 x matmul parameters x tokens, causal
    attention and the last-token unembedding."""
    return dense.model_flops(_as_dense(config), B, S)


def make_weights(config: dict, seed: int, device) -> dict:
    """The dense family's weights (the port's layout) at ChatGLM's sizes."""
    return dense.make_weights(_as_dense(config), seed, device)


def glm_rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """ChatGLM's rotary embedding of x (B, S, heads, kv_channels) at
    positions 0..S-1.  ``RotaryEmbedding(kv_channels // 2)`` makes
    n = kv_channels // 2 rotated dims, with frequencies base^(-2j / n) for
    j < n / 2; ``apply_rotary_pos_emb`` treats dims (2j, 2j + 1) as the
    complex number x_2j + i x_2j+1 and turns it by the angle p base^(-2j / n)
    (its cache "mimics complex32"); dims n and on pass through."""
    n = x.shape[-1] // 2
    S = x.shape[1]
    freqs = 1.0 / base ** (torch.arange(0, n, 2, device=x.device, dtype=torch.float32) / n)
    angles = torch.outer(torch.arange(S, device=x.device, dtype=torch.float32), freqs)
    turn = torch.polar(torch.ones_like(angles), angles)[None, :, None, :]
    pairs = torch.view_as_complex(x[..., :n].float().reshape(*x.shape[:-1], n // 2, 2)
                                  .contiguous())
    turned = torch.view_as_real(pairs * turn).flatten(-2)
    return torch.cat([turned, x[..., n:].float()], dim=-1)


@torch.no_grad()
def prefill(weights: dict, config: dict, tokens: torch.Tensor, *,
            precision: str = "float32",
            on_layer: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
            q_block: int = 1024) -> torch.Tensor:
    """The last-token logits (B, V) float32 of ``tokens`` (B, S); each
    layer's cache entries -- k after the rotary, v, (B, S, K, D) -- go to
    ``on_layer(i, {"k": k, "v": v})`` as they are computed."""
    z = sizes(config)
    eps = config["layernorm_epsilon"]
    base = 10000.0 * float(config.get("rope_ratio", 1))
    H, K, hd = z["heads"], z["kv_heads"], z["head_dim"]
    r = operand_rounding(precision)

    def mm(a, w):
        return torch.matmul(r(a), r(w.reshape(w.shape[0], -1).float()))

    B, S = tokens.shape
    with _exact_float32():
        x = weights["embed"]["tok"][tokens].float()
        for i, lw in enumerate(weights["layers"]):
            a, m = lw["attn"], lw["mlp"]
            h = rms_norm(x, lw["ln1"]["scale"].float(), eps)
            q = mm(h, a["wq"]).reshape(B, S, H, hd) + a["bq"].float()
            k = mm(h, a["wk"]).reshape(B, S, K, hd) + a["bk"].float()
            v = mm(h, a["wv"]).reshape(B, S, K, hd) + a["bv"].float()
            q, k = glm_rotary(q, base), glm_rotary(k, base)
            if on_layer is not None:
                on_layer(i, {"k": k, "v": v})
            ctx = dense.causal_attention(q, k, v, r, q_block)
            x = x + mm(ctx.reshape(B, S, H * hd), a["wo"].reshape(H * hd, -1))
            del q, k, v, ctx
            h = rms_norm(x, lw["ln2"]["scale"].float(), eps)
            gate, up = mm(h, torch.cat([m["w_gate"], m["w_up"]], dim=-1)).chunk(2, dim=-1)
            x = x + mm(F.silu(gate) * up, m["w_down"])
            del h, gate, up
        last = rms_norm(x[:, -1], weights["final_norm"]["scale"].float(), eps)
        return mm(last, weights["embed"]["unembed"])
