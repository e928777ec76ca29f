"""Graph neural-network layers driven by the port's SpMMs.

Each layer is one SpMM against a dense feature block, composed over a
caller-supplied ``spmm`` closure, so any packed format (BSR, lane, PMM,
DIA, the routed SpMV per column) slots in unchanged:

  * feature transforms are ordered ``A @ (X @ W)`` when W shrinks the
    feature width and ``(A @ X) @ W`` otherwise: the SpMM is the
    expensive factor, so it always runs at the narrower width;
  * the symmetric normalization D^-1/2 A D^-1/2 is folded into the packed
    values once, on the host (``gcn_normalize``), not applied per step;
  * the dense feature matmuls run in full float32 whatever
    ``torch.set_float32_matmul_precision`` says (TF32 keeps 10 mantissa
    bits of each operand, ~1e-3 relative).
"""

from __future__ import annotations

import numpy as np
import torch

from cvr_tpu_torch.models.solvers import full_f32

__all__ = ["gcn_normalize", "gcn_layer", "gcn_forward", "graphsage_layer",
           "params_from_reference"]


def gcn_normalize(rows, cols, vals, nrows: int, add_self_loops: bool = True):
    """Fold GCN symmetric normalization into COO values (host-side).

    Returns (rows, cols, vals) for Â = D^-1/2 (A + I) D^-1/2, the
    Kipf-Welling propagation operator, ready for any packer.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if add_self_loops:
        rows = np.concatenate([rows, np.arange(nrows, dtype=np.int64)])
        cols = np.concatenate([cols, np.arange(nrows, dtype=np.int64)])
        vals = np.concatenate([vals, np.ones(nrows)])
    # degree from |weights|: the standard D = sum(A) on nonnegative
    # adjacency, and D^-1/2 stays bounded (<= 1 with self loops) on signed
    # inputs instead of overflowing float32 downstream
    deg = np.zeros(nrows, dtype=np.float64)
    np.add.at(deg, rows, np.abs(vals))
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-30))
    return (
        rows.astype(np.int32),
        cols.astype(np.int32),
        (vals * dinv[rows] * dinv[cols]).astype(np.float32),
    )


def params_from_reference(weights, biases=None, device="cuda"):
    """The JAX package's layer weights (and biases), numpy arrays or
    anything ``np.asarray`` takes, as float32 tensors on ``device``:
    (weights, biases), biases None where none are given."""
    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ([put(W) for W in weights],
            None if biases is None else [put(b) for b in biases])


def gcn_layer(spmm, X, W, b=None, activation=torch.relu, device="cuda"):
    """One GCN layer: activation(Â @ X @ W + b).

    spmm: closure Y = Â @ M for dense M [n, k] over the packed Â.  X and W
    (numpy or torch) are cast to float32 on ``device``.
    """
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    W = torch.as_tensor(W, dtype=torch.float32, device=device)
    fin, fout = W.shape
    with full_f32():
        if fout <= fin:
            H = spmm(X @ W)
        else:
            H = spmm(X) @ W
    if b is not None:
        H = H + torch.as_tensor(b, dtype=torch.float32, device=device)
    return activation(H) if activation is not None else H


def gcn_forward(spmm, X, weights, biases=None, device="cuda"):
    """Multi-layer GCN forward: ReLU between layers, linear last layer."""
    H = torch.as_tensor(X, dtype=torch.float32, device=device)
    nl = len(weights)
    for i, W in enumerate(weights):
        b = biases[i] if biases is not None else None
        act = torch.relu if i < nl - 1 else None
        H = gcn_layer(spmm, H, W, b=b, activation=act, device=device)
    return H


def graphsage_layer(spmm_mean, X, W_self, W_neigh, activation=torch.relu,
                    device="cuda"):
    """GraphSAGE-mean layer: act(X @ W_self + (D^-1 A @ X) @ W_neigh).

    spmm_mean: closure over the row-normalized adjacency (D^-1 folded into
    the packed values, as gcn_normalize folds its scaling).
    """
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    W_self = torch.as_tensor(W_self, dtype=torch.float32, device=device)
    W_neigh = torch.as_tensor(W_neigh, dtype=torch.float32, device=device)
    with full_f32():
        H = X @ W_self + spmm_mean(X) @ W_neigh
    return activation(H) if activation is not None else H
