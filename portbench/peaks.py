"""Published peaks of the devices the benchmark runs on (NVIDIA's data
sheets, dense rates, at the card's full power limit).

The port's configurations state float32 with TF32 off, so the compute
peak that bounds them is the float32 rate outside the tensor cores.
"""

from __future__ import annotations

from typing import Optional

#: substring of ``torch.cuda.get_device_name()`` → peaks
PEAKS = {
    # H100 SXM5: 67 TFLOP/s float32, 3.35 TB/s HBM3, 700 W
    "H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
                       "power_w": 700.0},
    # H100 PCIe: 51 TFLOP/s float32, 2.0 TB/s HBM2e, 350 W
    "H100 PCIe": {"f32_flops": 51e12, "hbm_bytes_per_s": 2.0e12,
                  "power_w": 350.0},
}


def for_device(name: str) -> Optional[dict]:
    for key, peak in PEAKS.items():
        if key in name:
            return peak
    return None
