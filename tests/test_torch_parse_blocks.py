"""``repro_torch.core.parse.parse_blocks`` held bitwise against the JAX
package's ``parse_edges_kernel`` (its Pallas per-byte parse in interpret
mode plus the per-block XLA compaction ``_compact_block``), on the CPU.

The port computes that function as the ported ``parse_bytes`` kernel plus
a torch compaction (``parse._compact_blocks``).  Inputs are made with
numpy from a seed; ints compare by value, float weights by bit pattern.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.parse_edges.kernel import parse_edges_kernel
from repro_torch.core import parse

BUF_LEN = 512


def _rows(rng, nb, weighted):
    out = np.full((nb, BUF_LEN), 10, np.uint8)
    for r in range(nb):
        lines = []
        for _ in range(45):
            u, v = rng.integers(0, 10**int(rng.integers(1, 10)), 2)
            kind = rng.integers(0, 8)
            if kind == 0:
                lines.append(b"# comment 1 2")
            elif kind == 1:
                lines.append(f"{u} {v}\r".encode())
            elif weighted:
                lines.append(f"{u} {v} {rng.normal() * 100:.3f}".encode())
            else:
                lines.append(f"{u}\t{v}".encode())
        b = np.frombuffer(b"\n".join(lines) + b"\n", np.uint8)[:BUF_LEN]
        out[r, :len(b)] = b
    return out


@pytest.mark.parametrize("weighted,base,owned,edge_cap", [
    (False, 1, (0, BUF_LEN), BUF_LEN // 4 + 2),   # the loader's edge_cap
    (True, 0, (64, BUF_LEN), BUF_LEN // 4 + 2),
    (False, 0, (17, 400), 9),                      # rows overflow the cap
])
def test_parse_blocks_matches_parse_edges_kernel(weighted, base, owned,
                                                 edge_cap):
    rng = np.random.default_rng(edge_cap + base)
    rows = _rows(rng, 3, weighted)
    want = parse_edges_kernel(jnp.asarray(rows),
                              jnp.asarray(owned, jnp.int32),
                              weighted=weighted, base=base,
                              edge_cap=edge_cap, interpret=True)
    got = parse.parse_blocks(torch.from_numpy(rows), *owned,
                             weighted=weighted, base=base, edge_cap=edge_cap)
    assert got[0].shape == (3, edge_cap) and got[3].shape == (3,)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert np.array_equal(g.numpy().view(np.int32),
                                  np.asarray(w).view(np.int32))
