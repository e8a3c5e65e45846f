"""The accelerator a run measures on: JAX's view of it and the card's own."""
from __future__ import annotations

import subprocess
from typing import Optional, Tuple

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def parse_card_line(line: str) -> Tuple[str, Optional[float]]:
    """One line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` -> (name, power limit in W or None when the card
    does not report one)."""
    name, _, limit = line.rpartition(",")
    if not name:
        raise ValueError(f"not a name,power.limit line: {line!r}")
    limit = limit.strip()
    try:
        watts = float(limit.split()[0])
    except (IndexError, ValueError):
        watts = None
    return name.strip(), watts


def card_line() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints it."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu():
    """JAX's first device; raises RuntimeError unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"needs an NVIDIA GPU; JAX's first device is "
                           f"{dev.platform} ({dev.device_kind})")
    return dev


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
