"""Built-in model registry.

Counterpart of :mod:`mapreduce_tpu.models`: one place that names every
shipped model family and builds a representative job for it, under the
JAX package's names.  Factories take a :class:`~...config.Config` and a
device and return a constructed job; jobs that are config-free by
construction (grep: the pattern is the job) accept and ignore the config.
The pinned ``wordcount_*`` configurations are the JAX package's analysis
configurations, which the port's ``Config`` accepts as they are; the
analysis passes that read them are not ported yet (ROADMAP.md item A13).
The ``wordcount_fleet*`` names describe simulated multi-host fleets on
two-level meshes and raise until the port runs them (ROADMAP.md item
A9 (ii)); one axis of many ranks runs through the streamed executor.
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


def _wordcount_with(pinned: Config | None = None):
    """A word-count factory; ``pinned`` replaces the caller's config (the
    model exists to put that program in front of the analysis passes).
    The JAX registry's ``*_telemetry`` twins differ from theirs only in a
    mark its analysis reads, so here they build the same job."""
    def build(config: Config, device):
        from mapreduce_tpu_torch.models.wordcount import WordCountJob

        return WordCountJob(pinned or config, device)

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


def _fleet(config: Config, device):
    raise ValueError("the wordcount_fleet* models run a simulated "
                     "multi-host fleet on a two-level mesh, which is not "
                     "ported to the PyTorch package yet (ROADMAP.md item "
                     "A9 (ii))")


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
    "wordcount_telemetry": _wordcount_with(PALLAS_ANALYSIS_CONFIG),
    "wordcount_fused_telemetry": _wordcount_with(FUSED_ANALYSIS_CONFIG),
    "wordcount_fleet2": _fleet,
    "wordcount_fleet2x4": _fleet,
    "wordcount_fleet8": _fleet,
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
