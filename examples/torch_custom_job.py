"""The Engine is a general MapReduce framework, not just word count: define a
custom job by subclassing ``MapReduceJob`` and implementing its hooks
(init_state / map_chunk / combine / merge / finalize) with torch ops, and the
same machinery (steps over the ranks' chunks, the collective merge) runs it.

This example: a byte-class histogram (letters / digits / whitespace / other)
over a corpus, an *additive* accumulator (contrast the count table's sorted
monoid and the sketch's max monoid).

    python examples/torch_custom_job.py [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mapreduce_tpu_torch import Engine, MapReduceJob


class ByteClassHistogramJob(MapReduceJob):
    CLASSES = ("letter", "digit", "whitespace", "other")

    def __init__(self, device):
        self.device = device

    def init_state(self):
        return torch.zeros((4,), dtype=torch.int64, device=self.device)

    def map_chunk(self, chunk, chunk_id):
        letter = ((chunk | 0x20) >= ord("a")) & ((chunk | 0x20) <= ord("z"))
        digit = (chunk >= ord("0")) & (chunk <= ord("9"))
        space = (chunk == 0x20) | ((chunk >= 0x09) & (chunk <= 0x0D))
        pad = chunk == 0  # don't count the chunk padding as data
        other = ~(letter | digit | space | pad)
        return torch.stack([c.sum() for c in (letter, digit, space, other)])

    def combine(self, state, update):
        return state + update

    def merge(self, a, b):  # additive
        return a + b


p = argparse.ArgumentParser()
p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
device = "cpu" if p.parse_args().platform == "cpu" else None

corpus = b"Call me Ishmael. Some years ago - never mind how long precisely - " \
         b"having little or no money in my purse... " * 400

engine = Engine(ByteClassHistogramJob(device), device=device)
n = engine.n_devices

# One row of the corpus per rank (pad the tail with zeros).
chunk = -(-len(corpus) // n)
chunk += -chunk % 128
buf = np.zeros((n, chunk), np.uint8)
flat = np.frombuffer(corpus, np.uint8)
for i in range(n):
    row = flat[i * chunk:(i + 1) * chunk]
    buf[i, : row.shape[0]] = row

state = engine.init_states()
state = engine.step(state, buf[engine.rank], 0)
hist = engine.finish(state).cpu().numpy()

for name, count in zip(ByteClassHistogramJob.CLASSES, hist):
    print(f"{name}\t{int(count)}")
assert hist.sum() == len(corpus)
