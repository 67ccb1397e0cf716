"""A checkout-shaped tree for the CPU tests: this ``BENCHMARK.json`` and
``perfbench/`` data, with every configuration cut to its port's smoke size
and every traffic mix to a few tokens, so that a whole run fits the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: per family: the port's smoke sizes, as (configuration key, value)
SMOKE = {
    "dense": {"hidden_size": 64, "intermediate_size": 160, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 4, "vocab_size": 256},
    "ssm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
            "vocab_size": 256, "state_size": 4, "time_step_rank": 4},
}
#: the port's field for each key above
PORT_FIELD = {"hidden_size": "d_model", "intermediate_size": "d_ff",
              "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
              "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab_size"}
LENGTHS = {"prefill_32k": [24], "prefill_8k": [16], "prefill_chat": [4, 8]}
#: limits at the smoke sizes, set as the cells' are (PERF.md): between the
#: port's bf16 readings (at most 0.032 logits, 0.0057 k / v over 12 seeds
#: dense; 0.022 logits, 0.0039 conv, 0.015 ssm) and the float8 control's
#: (at least 0.22, 0.058; 0.12, 0.040, 0.080 over 6 seeds)
SMOKE_LIMITS = {
    "dense": {"logits_err": 0.08, "k_err": 0.02, "v_err": 0.02},
    "ssm": {"logits_err": 0.06, "conv_err": 0.012, "ssm_err": 0.035},
}


def smoke_tree(dst: Path, lengths=LENGTHS) -> Path:
    """Copy the benchmark into ``dst`` at smoke size; -> ``dst``."""
    dst = Path(dst)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    for path in (dst / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        small = SMOKE[cfg["family"]]
        cfg.update(small)
        repl = cfg["port"]["replace"]
        repl.update({PORT_FIELD[k]: v for k, v in small.items() if k in PORT_FIELD})
        if cfg["family"] == "ssm":
            repl["d_ff"] = 0
            repl["ssm"] = {"state_dim": small["state_size"], "conv_width": cfg["conv_kernel"],
                           "expand": cfg["expand"]}
        path.write_text(json.dumps(cfg))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    family = {c["name"]: json.loads((dst / c["file"]).read_text())["family"]
              for c in bench["configs"]}
    for w in bench["workloads"]:
        (dst / "perfbench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps({"limits": SMOKE_LIMITS[family[w["config"]]]}))
    for path in (dst / "perfbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["lengths"] = lengths[path.stem]
        if "batch_tokens" in mix:
            mix["batch_tokens"] = 2 * max(mix["lengths"])
        mix["trace_slice"] = {"skip": 1, "requests": 2}
        path.write_text(json.dumps(mix))
    return dst
