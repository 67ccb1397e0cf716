"""Print the port's counts of the zoo-smoke cells beside the JAX package's.

    PYTHONPATH=src python tests/torch_zoo_counts.py

For each smoke cell: the port's extraction on ``meta`` (the op counter over
the eager step) and the JAX package's -- calibrated (``extract_profile(cell,
calibrate=True)``: depth probes, every layer counted) and its checked-in
golden (``calibrate=False``: the scanned two-layer stack counted once,
ROADMAP R11) -- for ``dot_flops``, ``flops``, ``transcendentals``,
``bytes_accessed`` and ``hbm_bytes``, with the port's ratio to the
calibrated count.  About 30 s on a CPU (the JAX package's compiles).
"""

import json
import os

from repro.core import model_zoo as RZ
from repro_torch.core import model_zoo as PZ

FIELDS = ("dot_flops", "flops", "transcendentals", "bytes_accessed", "hbm_bytes")


def main() -> int:
    print("| cell | field | port (meta) | JAX calibrated | JAX golden | port / calibrated |")
    print("|---|---|---|---|---|---|")
    for rc, pc in zip(RZ.zoo_cells(smoke=True), PZ.zoo_cells(smoke=True)):
        port = PZ.extract_profile(pc, device="meta")
        cal = RZ.extract_profile(rc, calibrate=True)
        with open(os.path.join(RZ.SMOKE_CACHE_DIR, rc.cache_key + ".json")) as f:
            gold = json.load(f)
        for field in FIELDS:
            p, c = getattr(port, field), getattr(cal, field)
            print(f"| {pc.cache_key} | {field} | {p:.0f} | {c:.0f} | {gold[field]:.0f} "
                  f"| {p / c:.6f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
