"""Roofline peak table and trace reduction (``benchmarks/roofline.py``):
peaks are looked up by ``device_kind`` and never assumed."""

import jax
import jax.numpy as jnp
import pytest

from benchmarks.roofline import PEAKS, device_kernel_times, peaks_for


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA H100 PCIe"])
def test_h100_kinds_resolve(kind):
    p = peaks_for(kind)
    assert set(p) == {"fp32_flops", "hbm_bps"}
    # Data-sheet scale: tens of TFLOP/s on the FP32 units, TB/s of HBM.
    assert 50e12 <= p["fp32_flops"] <= 70e12
    assert p["hbm_bps"] >= 2e12


def test_sxm_and_pcie_differ():
    sxm, pcie = (PEAKS["NVIDIA H100 80GB HBM3"], PEAKS["NVIDIA H100 PCIe"])
    assert sxm["fp32_flops"] > pcie["fp32_flops"]
    assert sxm["hbm_bps"] > pcie["hbm_bps"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB",
                                  ""])
def test_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        peaks_for(kind)


def test_device_kernel_times_reads_a_trace(tmp_path):
    f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    totals = device_kernel_times(str(tmp_path), plane_prefix="/host:CPU")
    assert totals and all(ns >= 0 for ns in totals.values())
    # No GPU plane in a CPU trace: nothing is attributed to a device.
    assert device_kernel_times(str(tmp_path)) == {}
    with pytest.raises(FileNotFoundError):
        device_kernel_times(str(tmp_path / "empty"))
