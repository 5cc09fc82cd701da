"""graphcheck: static analysis of the port's map/reduce programs.

Counterpart of :mod:`mapreduce_tpu.analysis`, with the JAX module names
and pass ids.  A job is certified before a streamed run: its hooks and
the Engine's step/finish are recorded as op traces (:mod:`.trace`), and a
pass pipeline checks reducer algebra, accumulator lanes against corpus
scale, host syncs, device-memory cost against baselines, the kernels'
shared-memory and register budgets, each kernel's cross-block protocol,
fusion leads, and the collectives of a fleet's finish (their process
groups and their cost over the link levels, :mod:`.meshcost`, recorded
over an in-process fake world).  :mod:`.geometry` certifies, prices and
ranks kernel geometries.  CLI: ``python -m mapreduce_tpu_torch.analysis``.
"""

from mapreduce_tpu_torch.analysis.core import (AnalysisContext, Finding,
                                               Report, ERROR, WARNING, INFO,
                                               analyze_job, default_pipeline,
                                               pass_ids, register_pass,
                                               run_pipeline)
# Importing the package registers the built-in pipeline.
from mapreduce_tpu_torch.analysis import passes as _passes  # noqa: F401

__all__ = ["AnalysisContext", "Finding", "Report", "ERROR", "WARNING",
           "INFO", "analyze_job", "default_pipeline", "pass_ids",
           "register_pass", "run_pipeline"]
