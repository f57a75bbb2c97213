"""Quickstart: load a graph into EdgeList and CSR with GVEL; the twin of
the reference's ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Everything goes through the GraphSource front door -- ``open_graph``
returns a lazy handle that resolves format/codec/engine once, probes
metadata for free (``info()``), and memoizes its products.  The port has
no host parser: ``edgelist()`` parses on the device too.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time


def run(device=None, workdir=None, scale: int = 14) -> dict:
    """The reference's steps in ``workdir`` (a fresh temporary directory
    by default, removed at the end): returns the graph's ``path``
    (under ``workdir`` only), ``v``, ``e`` and the ``csr`` (moved to the
    host) that ``csr(method="staged", rho=4)`` built."""
    from ..core import available_engines, make_graph_file, open_graph
    from ..core.env import resolve_device

    dev = resolve_device(device)
    own = workdir is None
    tmp = tempfile.mkdtemp() if own else workdir
    try:
        path = os.path.join(tmp, "web.el")
        print("generating an RMAT web-like graph ...")
        v, e = make_graph_file(path, "rmat", scale=scale, edge_factor=16)
        size = os.path.getsize(path)
        print(f"  |V|={v:,} |E|={e:,}  ({size/1e6:.1f} MB text)")
        print(f"loader engines: {available_engines()}")

        # open_graph is cheap: it sniffs format + codec, nothing more.
        src = open_graph(path, num_vertices=v, device=dev)
        print(f"opened {src!r}")
        print(f"  info: {src.info().to_dict()}")

        t0 = time.perf_counter()
        el = src.edgelist()                      # device parse
        t_el = time.perf_counter() - t0
        print(f"edgelist(): {int(el.num_edges):,} edges in "
              f"{t_el*1e3:.0f} ms ({int(el.num_edges)/t_el/1e6:.2f} M "
              f"edges/s)")

        t0 = time.perf_counter()
        csr = src.csr(method="staged", rho=4)    # fused streaming build
        t_c = time.perf_counter() - t0
        assert int(csr.offsets[-1]) == e
        print(f"csr() end-to-end (streaming device engine): "
              f"{t_c*1e3:.0f} ms; offsets[-1]={int(csr.offsets[-1]):,}")
        assert src.csr() is src.csr()            # products are memoized

        deg = csr.degrees()
        print(f"degree stats: max={int(deg.max())}, "
              f"mean={float(deg.float().mean()):.1f} "
              f"(power law => staged build wins, per the paper)")

        # write once, load many: snapshot the parsed edgelist + prebuilt
        # CSR, then reload with zero parsing and zero building
        gvel = os.path.join(tmp, "web.gvel")
        snap_src = src.save(gvel)                # a handle on the output
        print(f"saved {snap_src!r}")
        t0 = time.perf_counter()
        csr3 = open_graph(gvel, device=dev).csr()
        t_s = time.perf_counter() - t0
        assert int(csr3.offsets[-1]) == e
        print(f"csr() from .gvel snapshot (embedded CSR, no parse/build): "
              f"{t_s*1e3:.1f} ms ({t_c/max(t_s, 1e-9):.0f}x vs streaming "
              f"parse)")

        # compressed snapshot: .csr() lazily decodes ONLY the CSR sections
        zgvel = os.path.join(tmp, "web.z.gvel")
        src.save(zgvel, compress="zlib")
        zsrc = open_graph(zgvel, device=dev)
        print(f"compressed snapshot: {zsrc.info().size_bytes/1e6:.2f} MB "
              f"(codec={zsrc.info().codec})")
        t0 = time.perf_counter()
        csr4 = zsrc.csr()                        # edgelist frames untouched
        t_z = time.perf_counter() - t0
        assert int(csr4.offsets[-1]) == e
        print(f"csr() from compressed snapshot (lazy, CSR sections only): "
              f"{t_z*1e3:.1f} ms")
        return {"path": None if own else path, "v": v, "e": e,
                "csr": csr.numpy()}
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--workdir", default=None,
                   help="where the graph files go (default: a temporary "
                   "directory, removed at the end)")
    args = p.parse_args(argv)
    run(args.device, args.workdir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
