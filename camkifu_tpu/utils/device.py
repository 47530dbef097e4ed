"""Which device the program runs on, and the guards that keep a run from
silently falling back to the CPU.

JAX carries on on the CPU, with only a warning, when its CUDA plugin fails
to load. The entry points therefore say which backend they run on and stop
unless it is the GPU or the user asked for the CPU (``JAX_PLATFORMS=cpu``).
Measurement paths (bench.py, chip_smoke.py) accept the GPU only.
"""

from __future__ import annotations

import os
import subprocess
import sys

#: Published peaks of one card, keyed by ``jax.devices()[0].device_kind``.
#: Source: NVIDIA H100 data sheet, SXM part, dense rates without sparsity,
#: at the full 700 W power limit. A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops_per_s": 67e12,      # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


def describe() -> dict:
    """{"platform", "kind", "count"} of JAX's default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peaks(kind: str) -> dict:
    """Peak rates of the card ``kind``; raises for a card not in PEAKS."""
    if kind not in PEAKS:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def require_gpu() -> dict:
    """describe(), or raise unless JAX's backend is the GPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev['platform']!r} "
                           f"({dev['kind']}); this path measures the GPU only")
    return dev


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def cpu_requested() -> bool:
    """True when the user pinned JAX to the CPU (JAX_PLATFORMS=cpu)."""
    import jax

    wanted = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return wanted.strip().lower() == "cpu"


def check_entry(prog: str) -> dict:
    """Entry-point guard: report the backend on stderr; stop with an error
    when there is no GPU and the CPU was not asked for."""
    dev = describe()
    print(f"{prog}: JAX backend {dev['platform']} ({dev['kind']}, "
          f"{dev['count']} device(s))", file=sys.stderr)
    if dev["platform"] != "gpu" and not cpu_requested():
        raise SystemExit(
            f"{prog}: no GPU found (JAX backend is {dev['platform']!r}). "
            "Set JAX_PLATFORMS=cpu to run on the CPU on purpose.")
    return dev
