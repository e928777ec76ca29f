"""Every Hopper kernel of the port, by name: K1-K7 of the routed path,
K15, the ring step of its row-sharded overlapped expand (K1's kernel),
and K16 flat middle, K17 brute middle (K5's kernel on the middle
layout) and K18 unfused reduce of the route
library's device API (route_kernels), K8 DIA (dia_kernels), K9 BELL
(bell_kernels) and K10 SELL-W (window_kernels) of the SpMV; K11 DIA
(dia_kernels), K12 BSR (bsr_kernels), K13 lane (lane_kernels) and K14
PMM (pmm_kernels) of the SpMM."""

from __future__ import annotations

from cvr_tpu_torch.ops import (
    bell_kernels,
    bsr_kernels,
    dia_kernels,
    lane_kernels,
    pmm_kernels,
    route_kernels,
    window_kernels,
)

_MODULES = (route_kernels, dia_kernels, bell_kernels, window_kernels,
            bsr_kernels, lane_kernels, pmm_kernels)

# name -> (wrapper, plain version, TPU kernels it replaces)
KERNELS = {name: entry for m in _MODULES for name, entry in m.KERNELS.items()}
# name -> the CUDA source of its kernel
SOURCES = {name: m.SOURCE for m in _MODULES for name in m.KERNELS}


def reset_launches() -> None:
    for wrapper, _plain, _src in KERNELS.values():
        wrapper.launches = 0


def launches() -> dict[str, int]:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}
