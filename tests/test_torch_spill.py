"""Batch-capacity spill: the one field where the port's word count parts
from the JAX package's default, pinned.

Under spill ``dropped_uniques`` is an upper bound that each build order
computes its own way.  The JAX split map (its default kernel path) builds
a seam table beside the column table and merges the two, which adds a
bound of its own; its fused map and the port's kernel emit one stream, so
the port's bound is the JAX fused path's.  Every other field (the kept
words, their counts and order, the total, ``distinct`` and
``dropped_count``) equals the JAX default's, which on the CPU is its
plain backend.  Held here for a streamed ``count_file`` and for the
command line's ``--stream --format json``, on a Zipf corpus over 2,000
words.
"""

import contextlib
import dataclasses
import io
import json
import pathlib

import numpy as np
import pytest

import torch_world
from mapreduce_tpu import cli as jcli
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import cli, convert
from mapreduce_tpu_torch.runtime import executor

FIELDS = ("words", "counts", "total", "distinct", "dropped_count")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> pathlib.Path:
    """~20 KB (3 chunks of 8.5 KB), 1,335 distinct words."""
    rng = np.random.default_rng(41)
    p = tmp_path_factory.mktemp("spill") / "zipf.txt"
    p.write_bytes(b" ".join(b"v%x" % (int(k) % 2000)
                            for k in rng.zipf(1.15, 5000)))
    return p


CHUNK = 8704  # the smallest multiple of 128 the kernel path takes at W=32
DEFAULT = JConfig(chunk_bytes=CHUNK, table_capacity=128)


@pytest.fixture(scope="module")
def jax_runs(corpus):
    """The JAX default (its plain backend on the CPU) and its fused kernel
    path over the corpus, with batch tables of 128 keys: every chunk
    spills, and so does the running table.  The command line's run below
    shares the default's step program."""
    with torch_world.shared_jax_engines():
        yield {"default": jexecutor.count_file(str(corpus), DEFAULT,
                                               mesh=data_mesh(1)),
               "fused": jexecutor.count_file(
                   str(corpus), dataclasses.replace(
                       DEFAULT, backend="pallas", map_impl="fused"),
                   mesh=data_mesh(1))}


def test_streamed_count_file_under_batch_spill(corpus, jax_runs):
    got = executor.count_file(
        str(corpus), convert.config_from_dict(dataclasses.asdict(DEFAULT)),
        device="cpu")
    want, fused = jax_runs["default"], jax_runs["fused"]
    assert got.dropped_uniques == fused.dropped_uniques > 0
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
        assert getattr(got, f) == getattr(fused, f), f


def _jax_json(argv) -> dict:
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out):
        assert jcli.main(list(argv)) == 0
    return json.loads(out.buffer.getvalue())


def test_cli_json_under_batch_spill(corpus, jax_runs, capsys):
    """``--format json`` of a streamed run: the JAX CLI's at its defaults,
    but for ``dropped_uniques``, which is the JAX fused path's."""
    argv = [str(corpus), "--stream", "--format", "json", "--chunk-bytes",
            str(CHUNK), "--table-capacity", "128"]
    with torch_world.shared_jax_engines():
        want = _jax_json(argv)
    assert cli.main(argv + ["--platform", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["dropped_uniques"] == jax_runs["fused"].dropped_uniques > 0
    assert want["dropped_uniques"] == jax_runs["default"].dropped_uniques
    del got["dropped_uniques"], want["dropped_uniques"]
    assert got == want
