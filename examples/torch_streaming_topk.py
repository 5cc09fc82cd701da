"""Streaming pipeline of the PyTorch port over a file: chunked ingest, top-k,
checkpointing, and a distinct-count sketch that stays accurate past table
capacity.

    python examples/torch_streaming_topk.py [path] [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.runtime import executor

p = argparse.ArgumentParser()
p.add_argument("path", nargs="?")
p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
args = p.parse_args()
device = "cpu" if args.platform == "cpu" else None

if args.path:
    path = args.path
else:  # demo corpus
    f = tempfile.NamedTemporaryFile(suffix=".txt", delete=False)
    f.write(b"the quick brown fox jumps over the lazy dog " * 5000)
    f.close()
    path = f.name

config = Config(chunk_bytes=1 << 20, table_capacity=1 << 16)
result = executor.count_file(
    path, config=config, device=device,
    top_k=5,                        # top-k selection in finalize
    distinct_sketch=True,           # HyperLogLog rides the same merges
    checkpoint_path=path + ".ck.npz",
    checkpoint_every=50,            # snapshot every 50 streaming steps
)

for word, count in zip(result.words, result.counts):
    print(f"{word.decode()}\t{count}")
print(f"total={result.total} distinct~={result.distinct_estimate:.0f} "
      f"(exact-table distinct={result.distinct})")
