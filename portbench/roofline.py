"""The card's peaks and the roofline bound of a ring_hemm product.

A frozen copy of ``chase_tpu_torch.perf.MATMUL_PEAKS`` and of the bound
arithmetic of ``chip_smoke.py`` (``bound``, ``hemm_bound``,
``bf16_hemm_bound``), kept here so that a change to the program cannot
move the yardstick.

Peaks are NVIDIA's H100 data-sheet dense rates (no sparsity) at the card's
full power limit (700 W for the SXM part, 350 W for PCIe); a card set
below it runs slower under load, so every result carries the card's power
limit beside its roofline shares.  "3xtf32" is the ring kernel's
f32-accuracy route (f32 and c64 products): three TF32 products per f32
product, so a third of the TF32 rate.
"""

from __future__ import annotations

from typing import Optional

PEAKS = (
    # (name substring of torch.cuda.get_device_name(), card and source,
    #  {rung: FLOP/s}, device memory bytes/s)
    ("H100 80GB HBM3", "H100 SXM5, 700 W, NVIDIA H100 data sheet, dense",
     {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "f64": 67e12}, 3.35e12),
    ("H100 PCIe", "H100 PCIe, 350 W, NVIDIA H100 data sheet, dense",
     {"bf16": 756e12, "tf32": 378e12, "f32": 51e12, "f64": 51e12}, 2.0e12),
)

# the route ring_hemm takes for an H of each dtype: (rung, bytes of an H
# element, bytes of a V or W element, FLOPs per multiply-add)
ROUTES = {
    "torch.float32": ("3xtf32", 4, 4, 2),
    "torch.complex64": ("3xtf32", 8, 8, 8),
    "torch.bfloat16": ("bf16", 2, 4, 2),
}


def card_peaks(device_name: str) -> Optional[tuple]:
    """({rung: FLOP/s} with "3xtf32" added, bytes/s) of the card named
    ``device_name``, or None for a card the table does not name."""
    for key, _, rates, bandwidth in PEAKS:
        if key in device_name:
            rates = dict(rates, **{"3xtf32": rates["tf32"] / 3.0})
            return rates, bandwidth
    return None


def bound_s(flop: float, nbytes: float, peak: float, bandwidth: float
            ) -> tuple:
    """(seconds, "operations" | "bytes"): the least time the card could
    take, the larger of the operations over the peak and the bytes over
    the memory rate."""
    t_ops, t_mem = flop / peak, nbytes / bandwidth
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def hemm_work(m: int, b: int, k: int, dtype: str) -> tuple:
    """(FLOPs, bytes, rung) of one ring_hemm product W (m × k) = H (m × b)
    · V (b × k): H and V read once, W written once; 2·m·b·k FLOPs, 8·m·b·k
    for complex.  ``dtype`` is H's, as ``str(tensor.dtype)``."""
    rung, h_bytes, v_bytes, per_mac = ROUTES[dtype]
    flop = float(per_mac) * m * b * k
    nbytes = float(h_bytes) * m * b + float(v_bytes) * (b * k + m * k)
    return flop, nbytes, rung


def hemm_bound_s(m: int, b: int, k: int, dtype: str,
                 device_name: str) -> Optional[float]:
    """The least seconds of one ring_hemm product on the card named
    ``device_name``, or None (a card the table does not name, or an H
    dtype the kernel does not take)."""
    peaks = card_peaks(device_name)
    if peaks is None or dtype not in ROUTES:
        return None
    rates, bandwidth = peaks
    flop, nbytes, rung = hemm_work(m, b, k, dtype)
    return bound_s(flop, nbytes, rates[rung], bandwidth)[0]
