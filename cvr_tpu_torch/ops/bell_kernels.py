"""The BELL SpMV's device pass: K9 ``bell_gather_mac`` and its plain
version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/bell_kernels.cu for CUDA tensors and counts
the launch in ``bell_gather_mac.launches``; given CPU tensors it runs the
plain version, and only then.
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops.route_kernels import _check_dtype, _launch, _on_card, _p

SOURCE = "cvr_tpu_torch/csrc/bell_kernels.cu"


def bell_gather_mac_plain(li, vals, x, d: int, pre: int, n_keep: int):
    """y (R_sub, 128): y[q, l] = sum_p vals[p, q, l] * x[c] with
    c = (8*(q >> 3) + d + (li >> 7) - pre)*128 + (li & 127) for
    li = li[p, q, l], x read as 0 outside [0, n_keep).  The JAX package's
    flat form (``_bell_gather_mac_jnp``), x indexed in place of its table."""
    R_sub = li.shape[1]
    idx = li.long()
    q = torch.arange(R_sub, device=x.device).view(1, R_sub, 1)
    col = (8 * (q >> 3) + d + (idx >> 7) - pre) * 128 + (idx & 127)
    valid = (col >= 0) & (col < n_keep)
    gath = torch.where(valid, x[col.clamp(0, max(n_keep - 1, 0))], 0.0)
    return (vals * gath).sum(dim=0)


def bell_gather_mac(li, vals, x, d: int, pre: int, n_keep: int):
    """K9: the BELL planes' products, y (R_sub, 128) row-major (row r at
    [r >> 7, r & 127]), from li (k, R_sub, 128) int16, vals (k, R_sub,
    128) f32 and x (ncols,) f32; the window phase d, the x table's zero
    rows pre and the x prefix n_keep <= ncols it reads.  See
    bell_gather_mac_plain."""
    if not _on_card("bell_gather_mac", li, vals, x):
        return bell_gather_mac_plain(li, vals, x, d, pre, n_keep)
    for t, dt in ((li, torch.int16), (vals, torch.float32),
                  (x, torch.float32)):
        _check_dtype("bell_gather_mac", t, dt)
    k, R_sub, _ = li.shape
    if li.shape != (k, R_sub, 128) or vals.shape != li.shape or not (
        0 <= n_keep <= x.shape[0]
    ):
        raise ValueError("bell_gather_mac: planes (k, R_sub, 128), "
                         "n_keep <= ncols")
    y = torch.empty((R_sub, 128), dtype=torch.float32, device=x.device)
    if R_sub:
        _launch("cvr_bell_gather_mac", x.device, _p(li), _p(vals), _p(x),
                _p(y), k, R_sub, d, pre, n_keep)
        bell_gather_mac.launches += 1
    return y


bell_gather_mac.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "bell_gather_mac": (
        bell_gather_mac, bell_gather_mac_plain,
        "cvr_tpu/ops/pallas_bell.py:72",
    ),
}
