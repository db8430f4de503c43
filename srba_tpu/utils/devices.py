"""What a measurement ran on: the JAX device and, on an NVIDIA card, its
name and power limit as ``nvidia-smi`` reports them (a card set below its
maximum power runs slower under load, so every number carries both)."""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of each visible card, one per line, or a note
    saying why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as ex:
        return f"nvidia-smi unavailable ({type(ex).__name__})"
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, kind and count of JAX's default devices plus the
    ``nvidia-smi`` line — stamped on every benchmark record."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi_name_power()}
