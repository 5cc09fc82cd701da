"""Built-in model registry.

Counterpart of :mod:`mapreduce_tpu.models`: one place that names every
shipped model family and builds a representative job for it, under the
JAX package's names.  Factories take a :class:`~...config.Config` and a
device and return a constructed job; jobs that are config-free by
construction (grep: the pattern is the job) accept and ignore the config.
The pinned ``wordcount_*`` configurations are the JAX package's analysis
configurations, which the port's ``Config`` accepts as they are; the
port's static analysis (:mod:`...analysis`, ``python -m
mapreduce_tpu_torch.analysis --all-models``) traces every model here.
The ``wordcount_fleet*`` names are the JAX package's fleet twins: a word
count at the pinned analysis configuration marked with the fleet it is
certified over (``analysis_fleet``: hosts and ranks a host) and the merge
its finish builds (``analysis_merge_strategy``); the port runs them over a
two-level mesh (``parallel/mesh.py:two_level_mesh``) through
``run_job_global``.
"""

from __future__ import annotations

from typing import Callable, Dict

from mapreduce_tpu_torch.config import Config

# Small shapes, as in the JAX package (see its module for each).
ANALYSIS_CONFIG = Config(chunk_bytes=1 << 10, table_capacity=512,
                         backend="xla")
RADIX_ANALYSIS_CONFIG = Config(chunk_bytes=128 * 66, table_capacity=512,
                               backend="pallas",
                               sort_impl="radix_partition")
PALLAS_ANALYSIS_CONFIG = Config(chunk_bytes=128 * 384, table_capacity=512,
                                backend="pallas")
FUSED_ANALYSIS_CONFIG = Config(chunk_bytes=128 * 384, table_capacity=512,
                               backend="pallas", map_impl="fused")
COMBINER_ANALYSIS_CONFIG = Config(chunk_bytes=128 * 512, table_capacity=512,
                                  backend="pallas", map_impl="fused",
                                  combiner="hot-cache")
NOCOMBINER_ANALYSIS_CONFIG = Config(chunk_bytes=128 * 512,
                                    table_capacity=512,
                                    backend="pallas", map_impl="fused")


def _wordcount_with(pinned: Config | None = None,
                    data_stats: bool = False):
    """A word-count factory; ``pinned`` replaces the caller's config (the
    model exists to put that program in front of the analysis passes).
    The ``*_telemetry`` twins differ from theirs only in the mark the
    analysis reads (``analysis_data_stats``: trace the stats-mode step)."""
    def build(config: Config, device):
        from mapreduce_tpu_torch.models.wordcount import WordCountJob

        job = WordCountJob(pinned or config, device)
        if data_stats:
            job.analysis_data_stats = True
        return job

    return build


def _grep(config: Config, device):
    from mapreduce_tpu_torch.models.grep import GrepJob

    del config  # config-free: the pattern is the whole job
    return GrepJob(b"the", device=device)


def _sample(config: Config, device):
    from mapreduce_tpu_torch.models.sample import ReservoirSampleJob

    return ReservoirSampleJob(16, config, device)


def _ngram(config: Config, device):
    from mapreduce_tpu_torch.models.wordcount import NGramCountJob

    return NGramCountJob(2, config, device)


def _sketch(config: Config, device):
    from mapreduce_tpu_torch.models.wordcount import (SketchedWordCountJob,
                                                      WordCountJob)

    return SketchedWordCountJob(WordCountJob(config, device))


def _fleet(processes: int, local_devices: int, merge: str = "tree"):
    """A fleet twin's factory: the word count at ``ANALYSIS_CONFIG`` (the
    caller's config is ignored, as in the JAX registry), marked with its
    topology and merge strategy."""
    def build(config: Config, device):
        from mapreduce_tpu_torch.models.wordcount import WordCountJob

        del config
        job = WordCountJob(ANALYSIS_CONFIG, device)
        job.analysis_fleet = {"processes": processes,
                              "local_devices": local_devices}
        job.analysis_merge_strategy = merge
        return job

    return build


_REGISTRY: Dict[str, Callable] = {
    "wordcount": _wordcount_with(),
    "grep": _grep,
    "sample": _sample,
    "ngram": _ngram,
    "sketch": _sketch,
    "wordcount_radix": _wordcount_with(RADIX_ANALYSIS_CONFIG),
    "wordcount_pallas": _wordcount_with(PALLAS_ANALYSIS_CONFIG),
    "wordcount_fused": _wordcount_with(FUSED_ANALYSIS_CONFIG),
    "wordcount_combiner": _wordcount_with(COMBINER_ANALYSIS_CONFIG),
    "wordcount_nocombiner": _wordcount_with(NOCOMBINER_ANALYSIS_CONFIG),
    "wordcount_telemetry": _wordcount_with(PALLAS_ANALYSIS_CONFIG, True),
    "wordcount_fused_telemetry": _wordcount_with(FUSED_ANALYSIS_CONFIG,
                                                 True),
    # 2 hosts x 4 ranks on the per-level tree, the same fleet on the
    # placed hier-kr-tree, and 8 hosts x 1 rank on keyrange.
    "wordcount_fleet2": _fleet(2, 4),
    "wordcount_fleet2x4": _fleet(2, 4, "hier-kr-tree"),
    "wordcount_fleet8": _fleet(8, 1, "keyrange"),
}


def model_names() -> list[str]:
    return list(_REGISTRY)


def build_model(name: str, config: Config = ANALYSIS_CONFIG, device=None):
    """Construct the named built-in model's job on ``device`` (default:
    the card)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; "
                         f"known: {', '.join(_REGISTRY)}") from None
    return factory(config, device)


__all__ = ["ANALYSIS_CONFIG", "COMBINER_ANALYSIS_CONFIG",
           "FUSED_ANALYSIS_CONFIG", "NOCOMBINER_ANALYSIS_CONFIG",
           "PALLAS_ANALYSIS_CONFIG", "RADIX_ANALYSIS_CONFIG",
           "build_model", "model_names"]
