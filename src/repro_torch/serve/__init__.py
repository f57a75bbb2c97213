"""The walk-LM serving path in PyTorch: the port of ``repro/serve``.

``step`` (prefill and decode steps), ``engine`` (the continuous-batching
:class:`~.engine.ServeEngine`) and ``runtime`` (:class:`~.runtime.
ServeRuntime`: graph resolution through the hot-graph cache, walk prompts,
the fault-tolerance coordinator).  Like the reference package, this one
exports nothing at its top level.
"""
