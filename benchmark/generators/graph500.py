"""The Graph500 specification's graph (``rmat.graph500``): the Kronecker
edge list on 2**scale vertices with initiator A, B, C, 1-A-B-C and
edgefactor * 2**scale edges, a weight uniform in [0, 1) an edge, the
labels permuted, each edge stored both ways, parallel edges summed."""

from benchmark import rmat

PARAMS = ("scale", "edgefactor", "A", "B", "C", "seed")
TINY = {"scale": 10, "edgefactor": 6}


def make(scale, edgefactor, A, B, C, seed):
    rows, cols, vals = rmat.graph500(scale, edgefactor, A, B, C, seed)
    return rows, cols, vals, 1 << scale
