"""Feedback-driven config autotuner: a run ledger's own ``bottleneck`` and
``data_health`` verdicts -> the next values of the tuned knobs, through a
deterministic rule engine (the port's copy of the JAX package's).

Entry points: :func:`propose` (one run's records -> one proposal, the
online-hint path) and :func:`search` (the walk over measured passes).
See :mod:`mapreduce_tpu_torch.tuning.engine`.
"""

from mapreduce_tpu_torch.tuning.engine import (KNOBS, TUNER_VERSION,
                                               default_knobs, derive_signals,
                                               propose, search,
                                               validate_knobs)

__all__ = ["KNOBS", "TUNER_VERSION", "default_knobs", "derive_signals",
           "propose", "search", "validate_knobs"]
