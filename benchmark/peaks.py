"""The card's peaks, and what nvidia-smi says of the card.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity).  The memory rate and the float32 and int32 rates copy
``skybox_rt_tpu_torch/runtime/perf.py``'s ``H100_PEAKS``; the tensor-core
rates are there for later cells, since no change may move the yardstick.
The rates assume the full 700 W power limit; every run records the card's
own limit beside them.
"""
from __future__ import annotations

import subprocess

H100_PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flop_per_s": 67e12,
    "int32_op_per_s": 33.5e12,
    "tf32_flop_per_s": 495e12,
    "bf16_flop_per_s": 989e12,
    "fp16_flop_per_s": 989e12,
    "fp8_flop_per_s": 1979e12,
    "int8_op_per_s": 1979e12,
}


def smi() -> dict:
    """The card's name and power limit as nvidia-smi reads them (empty where
    nvidia-smi is absent or fails)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    first = res.stdout.strip().splitlines()[0].split(",")
    out = {"smi_name": first[0].strip()}
    try:
        out["power_limit_w"] = float(first[1])
    except (IndexError, ValueError):
        pass
    return out
