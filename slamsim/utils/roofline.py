"""Published peak rates of the cards this program is measured on.

A roofline share needs a hardware denominator: the least time the card
could take for a call is the larger of its operations over the peak
operation rate and its bytes over the peak memory bandwidth.  The peaks
are keyed by ``jax.Device.device_kind``; a device that is not in the
table is an error, never a default.  Rates are dense (no sparsity) and
assume the part's full power limit, so state a share beside the card's
actual limit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Dense peak rates of one card (no sparsity)."""

    source: str
    flops_f32: float  # float32 outside the tensor cores
    flops_tf32: float
    flops_bf16: float
    hbm_bytes: float  # device-memory bandwidth, bytes/s


#: NVIDIA H100 SXM5 data sheet; rates assume the full 700 W power limit.
_H100_SXM = Peaks(
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense",
    flops_f32=67e12, flops_tf32=495e12, flops_bf16=989e12,
    hbm_bytes=3.35e12)

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks(device_kind: str) -> Peaks:
    """Peak table entry for ``device_kind``; raises ``KeyError`` for a
    device that has none."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None

