"""The CSR's consumers in the port: random walks (``walks``), the
step-indexed walk corpus (``corpus``), the prefetch pipeline
(``pipeline``) and the threefry PRNG the walks are keyed with (``prng``).

The counterparts of ``repro/data/{walks,corpus,pipeline}.py``; like that
package this one exports nothing at its top level.
"""
