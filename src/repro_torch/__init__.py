"""repro_torch: the PyTorch / NVIDIA H100 port of the GVEL loader.

The JAX package ``repro`` is the reference; this package reimplements its
main path -- a graph file (text, MatrixMarket or a ``.gvel`` snapshot; raw,
gzip or framed) -> CSR -- and the CSR's consumers (row gathers, point
reads, random walks and the walk corpus) in PyTorch with hand-written CUDA
kernels for Hopper (``repro_torch/csrc``).  Entry points run on CUDA unless
the caller passes ``device="cpu"``.

    import repro_torch
    csr = repro_torch.open_graph("graph.el").csr()
    csr = repro_torch.load_csr("graph.el.gz", method="binned")
    snap = repro_torch.open_graph("graph.el").save("graph.gvel")
    csr = snap.csr()                  # the embedded CSR, no parse
    nbrs, deg = repro_torch.kernels.neighbor_gather(ids, csr.offsets,
                                                    csr.targets)
    from repro_torch.data.corpus import CorpusConfig, WalkCorpus
"""
from .core import CSR, EdgeList, load_csr, load_edgelist, open_graph

__all__ = ["open_graph", "load_csr", "load_edgelist", "EdgeList", "CSR"]
