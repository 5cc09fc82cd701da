"""mapreduce_tpu_torch: the word-count MapReduce system on PyTorch and CUDA.

The port of :mod:`mapreduce_tpu` (JAX on a TPU) to an NVIDIA H100.  Module
paths mirror the JAX package's.  Every public entry point runs on the card
unless the caller asks for the CPU (``device="cpu"``, or ``--platform cpu``
on the command line); without a card and without that request it raises.
The tokenize + hash kernel is hand-written CUDA
(``mapreduce_tpu_torch/csrc/tokenize.cu``), built at first use.
"""

from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.models.wordcount import (WordCountResult,
                                                  count_table, count_words)
from mapreduce_tpu_torch.parallel.mapreduce import Engine
from mapreduce_tpu_torch.runtime.executor import count_file

__all__ = ["Config", "DEFAULT_CONFIG", "Engine", "WordCountResult",
           "count_file", "count_table", "count_words"]
