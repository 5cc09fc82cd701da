"""The map's remaining knobs against the JAX package, on the CPU.

``combiner='salt'``, ``sort_mode='segmin'``, ``merge_every`` > 1 and the
kernel geometries: each run through the port and through the JAX package
(its Pallas kernels in interpret mode) on the same seeded inputs, every
field compared exactly as uint32.

- Config: the JAX validation messages for bad geometries and for segmin
  with the radix seam, with salt and with an explicit rescue; presets,
  ``Geometry`` instances and dicts mapped across by
  ``convert.config_from_dict`` with the same resolved values; the
  autotuner's 'auto' values still refused.
- The packed build (``ops/table.py:from_packed_rows``) on position-ordered
  rows with poison and filler rows: salted and not, stable2 and sort3,
  the torch sort and both radix seams, with and without batch spill and
  with the rescue slice, against the JAX build; segmin against the JAX
  segmin build and against stable2; the refusals; ``merge_batched``.
- ``count_table`` end to end: salted runs (the poison rows stay unsalted,
  the rescue runs), segmin (overlong tokens land in ``dropped_*``), salt
  under batch spill (JAX's salted table: its fused path, the port's one
  stream), bigrams with salt, and ``combiner16``, ``tall512`` and radix
  geometry dicts, each held to the JAX table.
- ``merge_every = 3`` over 5 chunks, so the run ends mid-buffer: the
  staging cursor and fold, streamed plain, top-k and distinct-sketch
  runs (window-boundary merges and replay too), mid-buffer snapshots
  equal to the JAX ones leaf for leaf and resumed JAX -> port and
  port -> JAX.
- The ``run_start`` geometry stamp and the ladder's walk from a
  ``tall512`` config, equal to the JAX package's, and a storm whose first
  rung is ``revert-geometry``.
- The command line: ``--combiner salt``, ``--geometry``, ``--sort-mode
  segmin`` and ``--stream --merge-every 2`` print the JAX CLI's stdout,
  and the usage errors of ``--merge-every`` are the JAX CLI's.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from mapreduce_tpu import cli as jcli
from mapreduce_tpu import config as jconfig
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.ops import table as jtable
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu.runtime import faults as jfaults
from mapreduce_tpu_torch import cli, convert
from mapreduce_tpu_torch import config as pconfig
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.runtime import checkpoint as ckpt
from mapreduce_tpu_torch.runtime import executor, faults

REPO = pathlib.Path(__file__).resolve().parents[1]
SENT = 0xFFFFFFFF
FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count")


def _np(t) -> dict:
    """A table's fields as uint32 numpy (either package's table)."""
    if isinstance(t.key_hi, torch.Tensor):
        return convert.table_to_numpy(t)
    return {f: np.asarray(getattr(t, f)).astype(np.uint32)
            for f in t._fields}


def _assert_tables(want, got):
    want, got = _np(want), _np(got)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _port(jcfg: JConfig, **change) -> Config:
    return dataclasses.replace(
        convert.config_from_dict(dataclasses.asdict(jcfg)), **change)


# -- Config -------------------------------------------------------------------

BAD_GEOMETRIES = [
    {"block_rows": 200}, {"aux_rows": 64}, {"sort3_slots": 100},
    {"radix_bits": 6}, {"combiner_slots": 12}, {"block_rows": 128},
    {"radix_bits": 5, "radix_block_rows": 64, "radix_slab_slack": 1},
    {"compact_slots": 120}]


def _refusals(make_jax, make_port) -> list:
    msgs = []
    for make in (make_jax, make_port):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    return msgs


@pytest.mark.parametrize("bad", BAD_GEOMETRIES,
                         ids=lambda b: "-".join(f"{k}{v}" for k, v in
                                                b.items()))
def test_bad_geometries_are_refused_as_by_jax(bad):
    want, got = _refusals(lambda: jconfig.Geometry(**bad),
                          lambda: pconfig.Geometry(**bad))
    assert got == want
    want, got = _refusals(lambda: JConfig(geometry=bad),
                          lambda: Config(geometry=bad))
    assert got == want


@pytest.mark.parametrize("kw", [
    {"sort_mode": "segmin", "sort_impl": "radix"},
    {"sort_mode": "segmin", "sort_impl": "radix_partition"},
    {"sort_mode": "segmin", "combiner": "salt"},
    {"sort_mode": "segmin", "rescue_overlong": 4},
    {"combiner": "bogus"}, {"geometry": "bogus"}, {"geometry": 42},
    {"merge_every": 0}],
    ids=["segmin-radix", "segmin-radix-partition", "segmin-salt",
         "segmin-rescue", "combiner", "geometry-name", "geometry-type",
         "merge-every-0"])
def test_config_refusals_equal_jax(kw):
    want, got = _refusals(lambda: JConfig(**kw), lambda: Config(**kw))
    assert got == want


def test_autotuner_values_stay_refused():
    for kw in ({"combiner": "auto"}, {"geometry": "auto"}):
        JConfig(**kw)  # the JAX command line resolves them before a run
        with pytest.raises(ValueError,
                           match=r"ROADMAP.md item A8b \(ii\), the "
                                 r"autotuner"):
            Config(**kw)


@pytest.mark.parametrize("geometry", [
    None, "default", "tall512", "combiner16",
    jconfig.Geometry(radix_bits=2, combiner_slots=24),
    {"radix_bits": 5, "block_rows": 512}, jconfig.Geometry()],
    ids=["none", "default", "tall512", "combiner16", "instance", "dict",
         "default-instance"])
def test_geometry_maps_across_and_resolves_as_in_jax(geometry):
    """Presets, ``Geometry`` instances and dicts: the same label, resolved
    geometry, cache depth (an explicit ``combiner_slots`` wins over the
    geometry's) and salt width in both packages; the port's config is
    hashable and equal to one built from the JAX config's fields."""
    for kw in ({}, {"map_impl": "fused", "combiner": "hot-cache"},
               {"map_impl": "fused", "combiner": "hot-cache",
                "combiner_slots": 32}, {"combiner": "salt"},
               {"sort_mode": "segmin", "merge_every": 3}):
        j = JConfig(geometry=geometry, backend="pallas", **kw)
        p = convert.config_from_dict(dataclasses.asdict(j))
        assert hash(p) is not None
        assert p == Config(geometry=j.geometry if not isinstance(
            j.geometry, jconfig.Geometry) else j.geometry.as_dict(),
            backend="pallas", **kw)
        assert p.geometry_label == j.geometry_label
        assert p.resolved_geometry.as_dict() == j.resolved_geometry.as_dict()
        assert (p.resolved_combiner, p.resolved_combiner_slots,
                p.resolved_salt_bits, p.rescue_slots, p.rescue_slots_max) \
            == (j.resolved_combiner, j.resolved_combiner_slots,
                j.resolved_salt_bits, j.rescue_slots, j.rescue_slots_max)
    assert pconfig.GEOMETRY_PRESETS.keys() == jconfig.GEOMETRY_PRESETS.keys()
    for name, g in pconfig.GEOMETRY_PRESETS.items():
        assert g.as_dict() == jconfig.GEOMETRY_PRESETS[name].as_dict()
    assert pconfig.COMBINER_SALT_BITS == jconfig.COMBINER_SALT_BITS
    assert dataclasses.asdict(pconfig.SMALL_CONFIG) \
        == dataclasses.asdict(convert.config_from_dict(
            dataclasses.asdict(jconfig.SMALL_CONFIG)))


# -- the packed build ----------------------------------------------------------

def _rows(kind: str, n: int = 6000, seed: int = 0):
    """Position-ordered packed rows as a kernel stream gives them: real
    tokens (one word, or Zipf over 500 keys), a poison row now and then
    (key (sent, sent-1), zero length) and a tail of dead filler."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(1 << 20, n, replace=False)).astype(np.uint64)
    if kind == "one_word":
        hi = np.full(n, 0x1234_5678, np.uint64)
        lo = np.full(n, 0x9ABC_DEF0, np.uint64)
        length = np.full(n, 5, np.uint64)
    else:
        vhi = rng.integers(0, SENT, 500, dtype=np.uint64)
        vlo = rng.integers(0, SENT - 1, 500, dtype=np.uint64)
        vlen = rng.integers(1, 33, 500).astype(np.uint64)
        pick = (rng.zipf(1.2, n) - 1) % 500
        hi, lo, length = vhi[pick], vlo[pick], vlen[pick]
    poison = np.zeros(n, bool)
    poison[7::97] = True
    hi = np.where(poison, SENT, hi)
    lo = np.where(poison, SENT - 1, lo)
    packed = (pos << 6) | np.where(poison, 0, length)
    dead = 300
    hi = np.concatenate([hi, np.full(dead, SENT, np.uint64)])
    lo = np.concatenate([lo, np.full(dead, SENT, np.uint64)])
    packed = np.concatenate([packed, np.full(dead, SENT, np.uint64)])
    total = int((~poison).sum())
    return hi.astype(np.uint32), lo.astype(np.uint32), \
        packed.astype(np.uint32), total


def _builds(rows, capacity, **kw):
    """The JAX build (the XLA sort) and the port's, ``kw`` to both except
    ``port_impl``, the port's sort (its radix seams run their plain
    versions on the CPU; the JAX package's radix seam equals its sort).
    The JAX segmin build is jitted: its scan runs slowly op by op."""
    hi, lo, packed, total = rows
    impl = kw.pop("port_impl", "xla")
    build = functools.partial(jtable.from_packed_rows, capacity=capacity,
                              pos_hi=3, **kw)
    if kw.get("sort_mode") == "segmin":
        build = jax.jit(build)
    want = build(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(packed),
                 jnp.uint32(total))
    t = [torch.from_numpy(x.astype(np.int64)) for x in (hi, lo, packed)]
    got = table_ops.from_packed_rows(*t, torch.tensor(total), capacity, 3,
                                     sort_impl=impl, **kw)
    return want, got


@pytest.mark.parametrize("kind", ["one_word", "zipf"])
@pytest.mark.parametrize("mode", ["stable2", "sort3"])
@pytest.mark.parametrize("impl", ["xla", "radix_partition", "radix"])
@pytest.mark.parametrize("capacity", [4096, 64], ids=["fits", "spill"])
def test_salted_build_equals_jax(kind, mode, impl, capacity):
    """The salted build and its rescue slice, every field: unspilled it is
    the unsalted table; under batch spill the cutoff falls on the salted
    key order in both packages (the JAX envelope's second leg)."""
    rows = _rows(kind)
    (want, want_r), (got, got_r) = _builds(
        rows, capacity, sort_mode=mode, rescue_slots=80, salt_bits=3,
        port_impl=impl)
    _assert_tables(want, got)
    np.testing.assert_array_equal(got_r.numpy().astype(np.uint32),
                                  np.asarray(want_r))
    # The poison rows stay unsalted: the rescue slice starts with them.
    assert (got_r.numpy()[:60] & 63 == 0).all()
    plain, _ = _builds(rows, capacity, sort_mode=mode, rescue_slots=80)[1]
    if capacity == 4096:
        _assert_tables(plain, got)
    elif kind == "zipf":  # the kept set moved with the salted order
        assert not np.array_equal(_np(plain)["key_lo"], _np(got)["key_lo"])


@pytest.mark.parametrize("kind", ["one_word", "zipf"])
@pytest.mark.parametrize("capacity", [4096, 64], ids=["fits", "spill"])
def test_segmin_build_equals_jax_and_stable2(kind, capacity):
    rows = _rows(kind, seed=1)
    want, got = _builds(rows, capacity, sort_mode="segmin")
    _assert_tables(want, got)
    stable2 = _builds(rows, capacity, sort_mode="stable2")[1]
    _assert_tables(stable2, got)


@pytest.mark.parametrize("kw", [
    {"sort_mode": "segmin", "salt_bits": 3},
    {"sort_mode": "segmin", "sort_impl": "radix"},
    {"sort_mode": "segmin", "rescue_slots": 4},
    {"sort_mode": "bogus"}, {"salt_bits": 7}],
    ids=["salt", "radix", "rescue", "mode", "salt-width"])
def test_build_refusals_equal_jax(kw):
    z = np.zeros(8, np.uint32)
    tz = torch.zeros(8, dtype=torch.int64)
    want, got = _refusals(
        lambda: jtable.from_packed_rows(*(jnp.asarray(z),) * 3,
                                        jnp.uint32(0), 4, 0, **kw),
        lambda: table_ops.from_packed_rows(tz, tz, tz, torch.tensor(0), 4,
                                           0, **kw))
    assert got == want


@pytest.mark.parametrize("capacity", [1024, 96], ids=["fits", "spill"])
def test_merge_batched_equals_jax(capacity):
    """One build over a running table and three staged batch tables (the
    last slot flushed: sentinel keys, count 0) against the JAX fold."""
    tables = []
    for seed in range(4):
        hi, lo, packed, total = _rows("zipf", n=1500, seed=seed + 3)
        tables.append(_builds((hi, lo, packed, total), 256,
                              sort_mode="stable2")[1])
    running = table_ops.merge(tables[0], tables[0], capacity=capacity)
    empty = table_ops.empty(256)
    staged = tables[1:3] + [empty]
    pend = [torch.cat([getattr(t, f) for t in staged]) for f in (
        "key_hi", "key_lo", "count", "pos_hi", "pos_lo", "length")]
    got = table_ops.merge_batched(running, *pend, capacity)
    want = jax.jit(functools.partial(jtable.merge_batched,
                                     capacity=capacity))(
        jtable.CountTable(**{f: jnp.asarray(v) for f, v in
                             _np(running).items()}),
        *(jnp.asarray(p.numpy().astype(np.uint32)) for p in pend))
    _assert_tables(want, got)
    # Against the pairwise folds: the same kept keys and counts, and with
    # the staged tables' own accounting (which ``combine`` folds in at
    # staging) the same dropped_count and a dropped_uniques at most theirs.
    pair = running
    for t in staged:
        pair = table_ops.merge(pair, t, capacity=capacity)
    a, b = _np(pair), _np(got)
    for f in ("key_hi", "key_lo", "count", "pos_hi", "pos_lo", "length"):
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    du, dc = (sum(int(getattr(t, f)) for t in staged)
              for f in ("dropped_uniques", "dropped_count"))
    assert int(b["dropped_count"]) + dc == int(a["dropped_count"])
    assert int(b["dropped_uniques"]) + du <= int(a["dropped_uniques"])


# -- count_table end to end -----------------------------------------------------

W = 8
CHUNK = 4096
JBASE = JConfig(backend="pallas", pallas_max_token=W, chunk_bytes=CHUNK,
                table_capacity=4096)


def _text(seed: int, n_words: int, overlong: bool = True) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(300)] + [b"abcdefgh"]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]
    if overlong:
        for i in range(40, len(words), 230):
            words[i] = b"overlong_token_%d" % (i % 3)
    return b" ".join(words)


ZIPF = _text(7, 800)  # ~3.3 KB, one padded 4 KB chunk


@pytest.fixture(scope="module")
def jax_tables():
    """The JAX tables, one Pallas program a configuration."""
    return {
        "salt": jwc.count_table(ZIPF, dataclasses.replace(
            JBASE, combiner="salt")),
        "segmin": jwc.count_table(ZIPF, dataclasses.replace(
            JBASE, sort_mode="segmin")),
        # Batch spill: the JAX fused path salts the one stream the port's
        # kernel emits (its split path salts the column stream alone).
        "salt-spill": jwc.count_table(ZIPF, dataclasses.replace(
            JBASE, combiner="salt", map_impl="fused", table_capacity=48)),
    }


@pytest.mark.parametrize("change", [
    {}, {"sort_mode": "sort3"}, {"sort_impl": "radix_partition"},
    {"sort_impl": "radix"}, {"map_impl": "fused"}, {"compact_slots": 0}],
    ids=["stable2", "sort3", "radix-partition", "radix", "fused", "pair"])
def test_salted_count_table_equals_jax(jax_tables, change):
    got = wc.count_table(ZIPF, _port(JBASE, combiner="salt", **change),
                         device="cpu")
    _assert_tables(jax_tables["salt"], got)
    assert int(got.dropped_count) == 0  # the rescue took every overlong


@pytest.mark.parametrize("change", [{}, {"map_impl": "fused"}],
                         ids=["split", "fused"])
def test_salted_spill_equals_jax_salted_table(jax_tables, change):
    got = wc.count_table(ZIPF, _port(JBASE, combiner="salt",
                                     table_capacity=48, **change),
                         device="cpu")
    _assert_tables(jax_tables["salt-spill"], got)
    unsalted = wc.count_table(ZIPF, _port(JBASE, table_capacity=48),
                              device="cpu")
    assert not np.array_equal(_np(unsalted)["key_lo"], _np(got)["key_lo"])


def test_segmin_count_table_equals_jax(jax_tables):
    got = wc.count_table(ZIPF, _port(JBASE, sort_mode="segmin"),
                         device="cpu")
    _assert_tables(jax_tables["segmin"], got)
    # No rescue under segmin: the overlong tokens land in dropped_*.
    n_over = ZIPF.split().count(b"overlong_token_0") \
        + ZIPF.split().count(b"overlong_token_1") \
        + ZIPF.split().count(b"overlong_token_2")
    assert int(got.dropped_count) == n_over > 0
    stable2 = wc.count_table(ZIPF, _port(JBASE, rescue_overlong=0),
                             device="cpu")
    _assert_tables(stable2, got)


@pytest.mark.parametrize("geometry,change", [
    ("combiner16", {"map_impl": "fused", "combiner": "hot-cache"}),
    ({"combiner_slots": 32}, {"map_impl": "fused", "combiner": "hot-cache"}),
    ("tall512", {}),
    ({"radix_bits": 2}, {"sort_impl": "radix_partition"}),
    ({"radix_bits": 5}, {"sort_impl": "radix"}),
    ({"radix_bits": 1}, {"sort_impl": "radix"})],
    ids=["combiner16", "combiner32", "tall512", "radix-bits2",
         "radix-bits5", "radix-bits1"])
def test_geometries_give_the_jax_table(jax_tables, geometry, change,
                                       monkeypatch):
    """A geometry picks K1d's cache depth and K2's digit width; the table
    is the JAX package's (its geometries and its salt change no table
    without spill).  The wrappers see the geometry's values."""
    from mapreduce_tpu_torch.ops.cuda import radix
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok

    seen = []
    real_sort, real_fused = radix.radix_sort3, ktok.tokenize_fused

    def sort(*a, bits, **kw):
        seen.append(("bits", bits))
        return real_sort(*a, bits=bits, **kw)

    def fused(*a, combiner_slots=0, **kw):
        seen.append(("cslots", combiner_slots))
        return real_fused(*a, combiner_slots=combiner_slots, **kw)

    monkeypatch.setattr(radix, "radix_sort3", sort)
    monkeypatch.setattr(ktok, "tokenize_fused", fused)
    cfg = _port(JBASE, geometry=geometry, **change)
    _assert_tables(jax_tables["salt"], wc.count_table(ZIPF, cfg,
                                                      device="cpu"))
    jcfg = dataclasses.replace(JBASE, geometry=geometry, **change)
    if "sort_impl" in change:
        assert seen == [("bits", jcfg.resolved_geometry.radix_bits)]
    elif change:
        assert seen == [("cslots", jcfg.resolved_combiner_slots)]
    else:
        assert seen == []


def test_salted_bigrams_equal_jax():
    """The gram build salts too (7 length bits): on the plain backend in
    both packages, with and without table spill, and on the port's
    kernel path (no overlong tokens, so it equals the plain one)."""
    data = _text(9, 900, overlong=False)
    j = JConfig(backend="xla", chunk_bytes=CHUNK, table_capacity=64,
                combiner="salt")
    want = jwc.count_ngrams(data, 2, j)
    assert want.dropped_uniques > 0
    for backend in ("xla", "pallas"):
        got = wc.count_ngrams(data, 2, _port(j, backend=backend,
                                             pallas_max_token=W),
                              device="cpu")
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (backend, f)
    unsalted = wc.count_ngrams(data, 2, _port(j, combiner="off"),
                               device="cpu")
    assert unsalted.words != want.words  # the salted cutoff moved


# -- merge_every --------------------------------------------------------------

JX = JConfig(backend="xla", chunk_bytes=CHUNK, table_capacity=512,
             merge_every=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two files of ~2,000 distinct words, 2 + 3 chunks, past a 512-entry
    table: a run of 5 combines ends mid-buffer (cursor 2)."""
    d = tmp_path_factory.mktemp("knobs")
    rng = np.random.default_rng(31)
    paths = []
    for i, n in enumerate((1500, 2300)):
        p = d / f"part{i}.txt"
        p.write_bytes(b" ".join(b"u%x" % (int(k) % 2000)
                                for k in rng.zipf(1.2, n)))
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module", autouse=True)
def _shared_engines():
    with torch_world.shared_jax_engines():
        yield


def test_staged_state_stages_and_folds(files):
    """The cursor is a host int that cycles through K; a staged batch's
    spill accounting folds in at once; the folded table keeps every key,
    count and position the pairwise folds keep (the leaves against the
    JAX state: the mid-buffer snapshots below)."""
    job = wc.WordCountJob(_port(JX), "cpu")
    pair = wc.WordCountJob(_port(JX, merge_every=1), "cpu")
    state, plain = job.init_state(), pair.init_state()
    data = open(files[1], "rb").read()
    for step in range(5):
        buf = tok_ops.pad_to(data[step * 1700:(step + 1) * 1700], CHUNK)
        upd = job.map_chunk(torch.from_numpy(buf), step)
        state, plain = job.combine(state, upd), pair.combine(plain, upd)
        assert isinstance(state.cursor, int)
        assert state.cursor == (step + 1) % 3
        assert int(state.table.dropped_count) >= int(upd.dropped_count)
    a, b = _np(pair.finalize(plain)), _np(job.finalize(state))
    for f in ("key_hi", "key_lo", "count", "pos_hi", "pos_lo", "length",
              "dropped_count"):
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    assert b["dropped_uniques"] <= a["dropped_uniques"]
    assert job.merge(state, job.init_state()).cursor == 0


@pytest.fixture(scope="module")
def staged_runs(files, tmp_path_factory):
    """Both packages' streamed runs at ``merge_every=3`` with a snapshot
    every 2 steps (the step-4 snapshot and ``.prev``, step 2, both
    mid-buffer), and the JAX top-k and distinct-sketched runs."""
    d = tmp_path_factory.mktemp("staged")
    out = {"dir": d}
    out["jax"] = jexecutor.count_file(files, JX, mesh=data_mesh(1),
                                      checkpoint_path=str(d / "jax.npz"),
                                      checkpoint_every=2)
    out["port"] = executor.count_file(files, _port(JX), device="cpu",
                                      checkpoint_path=str(d / "port.npz"),
                                      checkpoint_every=2)
    out["jax-topk"] = jexecutor.count_file(files, JX, mesh=data_mesh(1),
                                           top_k=25)
    out["jax-hll"] = jexecutor.count_file(files, JX, mesh=data_mesh(1),
                                          distinct_sketch=True)
    return out


def _assert_results(want, got):
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_staged_stream_equals_jax(staged_runs, files):
    _assert_results(staged_runs["jax"], staged_runs["port"])
    assert staged_runs["port"].dropped_uniques > 0  # the table spilled
    # The kernel path: no overlong token, so the plain backend's result.
    _assert_results(staged_runs["jax"], executor.count_file(
        files, _port(JX, backend="pallas", pallas_max_token=W),
        device="cpu"))
    # Window-boundary merges and window replay see staged states too.  A
    # partial merge flushes the staged batches at each window boundary,
    # so only the spill bound follows the other cadence.
    overlapped = executor.count_file(
        files, _port(JX, merge_overlap=True, inflight_groups=1),
        device="cpu")
    for f in FIELDS[:-2] + ("dropped_count",):
        assert getattr(overlapped, f) == getattr(staged_runs["jax"], f), f
    _assert_results(staged_runs["jax"], executor.count_file(
        files, _port(JX, fault_plan="at=dispatch:2:transient"),
        device="cpu", retry=1))
    # Every field but the spill bound equals merge_every=1's.
    one = executor.count_file(files, _port(JX, merge_every=1), device="cpu")
    for f in FIELDS[:-2] + ("dropped_count",):
        assert getattr(one, f) == getattr(staged_runs["port"], f), f
    assert staged_runs["port"].dropped_uniques <= one.dropped_uniques


@pytest.mark.parametrize("kw", [{"top_k": 25}, {"distinct_sketch": True}],
                         ids=["topk", "distinct-sketch"])
def test_staged_topk_and_sketch_equal_jax(staged_runs, files, kw):
    want = staged_runs["jax-topk" if "top_k" in kw else "jax-hll"]
    got = executor.count_file(files, _port(JX), device="cpu", **kw)
    _assert_results(want, got)
    assert got.distinct_estimate == want.distinct_estimate


def _copy_snapshot(src, dst) -> str:
    shutil.copy(src, dst)
    shutil.copy(ckpt.integrity_path(str(src)), ckpt.integrity_path(str(dst)))
    return str(dst)


@pytest.mark.parametrize("suffix", ["", ".prev"])
def test_mid_buffer_snapshot_equals_jax(staged_runs, suffix):
    want = np.load(staged_runs["dir"] / f"jax.npz{suffix}")
    got = np.load(staged_runs["dir"] / f"port.npz{suffix}")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k == "__meta":
            assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    leaves = sorted((k for k in got.files if k.startswith("__leaf_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    cursor = int(got[leaves[-1]][0])
    assert cursor == {"": 1, ".prev": 2}[suffix]  # mid-buffer


def test_mid_buffer_snapshot_resumes_across_packages(staged_runs, files,
                                                     tmp_path):
    d = staged_runs["dir"]
    got = executor.count_file(
        files, _port(JX), device="cpu",
        checkpoint_path=_copy_snapshot(d / "jax.npz.prev",
                                       tmp_path / "from_jax.npz"))
    _assert_results(staged_runs["jax"], got)
    assert got.run.metrics.bytes_processed \
        < sum(os.path.getsize(p) for p in files)
    want = jexecutor.count_file(
        files, JX, mesh=data_mesh(1),
        checkpoint_path=_copy_snapshot(d / "port.npz.prev",
                                       tmp_path / "from_port.npz"))
    _assert_results(staged_runs["jax"], want)


def test_ngrams_keep_refusing_merge_every():
    with pytest.raises(ValueError, match="wordcount family only"):
        wc.NGramCountJob(2, _port(JX), "cpu")
    # A unigram "n-gram" job is the word count: it stages as one.
    job = wc.NGramCountJob(1, _port(JX), "cpu")
    assert isinstance(job.init_state(), wc.BufferedTableState)


# -- the executor's geometry records ---------------------------------------------

@pytest.mark.parametrize("geometry", [None, "tall512", "combiner16",
                                      {"radix_bits": 2}])
def test_geometry_stamp_equals_jax(geometry, files, tmp_path):
    jcfg = JConfig(geometry=geometry)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert executor._geometry_stamp(cfg) == jexecutor._geometry_stamp(jcfg)
    ledger = tmp_path / "ledger.jsonl"
    from mapreduce_tpu_torch.obs.telemetry import Telemetry

    tel = Telemetry.create(ledger_path=str(ledger))
    try:
        executor.count_file(files[0], _port(JX, geometry=geometry),
                            device="cpu", telemetry=tel)
    finally:
        tel.close()
    start = [json.loads(line) for line in open(ledger)
             if '"run_start"' in line][0]
    stamp = jexecutor._geometry_stamp(jcfg)
    assert {k: start.get(k) for k in ("geometry", "geometry_spec")} \
        == {"geometry": stamp["geometry"],
            "geometry_spec": stamp.get("geometry_spec")}


def test_ladder_from_tall512_equals_jax():
    """The ladder's walk from a ``tall512`` config and each rung's config,
    as in the JAX executor: ``revert-geometry`` first, to geometry None."""
    jcfg = JConfig(geometry="tall512", map_impl="fused",
                   combiner="hot-cache", sort_impl="radix")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    summary = executor._config_summary(cfg)
    assert summary == jexecutor._config_summary(jcfg)
    walk = faults.ladder_walk(summary)
    assert walk == jfaults.ladder_walk(summary) == [
        "revert-geometry", "combiner-off", "map-split", "sort-xla"]
    for step in walk:
        name, field, value = faults.next_degrade(summary)
        assert name == step
        jcfg = jexecutor._apply_degrade(jcfg, field, value)
        cfg = executor._apply_degrade(cfg, field, value)
        assert cfg == convert.config_from_dict(dataclasses.asdict(jcfg))
        summary = executor._config_summary(cfg)
    assert cfg.geometry is None


def test_storm_at_tall512_reverts_the_geometry_first(files, monkeypatch):
    """A resource storm that clears once the map runs the default
    geometry: the ladder's first rung reverts it, and the result is
    exact."""
    policy = {"resource_retries": 1, "transient_retries": 1,
              "degrade": True, "backoff_base_s": 0.0, "jitter_frac": 0.0}
    want = executor.count_file(files, _port(JX), device="cpu")
    real = wc._map_stream

    def storming(chunk, config, *a, **kw):
        if config.geometry is not None:
            raise RuntimeError("RESOURCE_EXHAUSTED: injected storm")
        return real(chunk, config, *a, **kw)

    monkeypatch.setattr(wc, "_map_stream", storming)
    got = executor.count_file(files, _port(JX, geometry="tall512",
                                           failure_policy=policy),
                              device="cpu")
    assert got.run.pipeline["degrade_steps"] == ["revert-geometry"]
    _assert_results(want, got)


# -- the command line ------------------------------------------------------------

def _jax_main(argv) -> tuple:
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out):
        rc = jcli.main(list(argv))
    return rc, out.buffer.getvalue()


@pytest.mark.parametrize("flags", [
    ("--geometry", "tall512"),
    ("--geometry", "combiner16", "--map-impl", "fused", "--combiner",
     "hot-cache", "--format", "json"),
    ("--stream", "--merge-every", "2", "--chunk-bytes", "4096",
     "--geometry-profile", "no-such.json", "--format", "json")],
    ids=["tall512", "combiner16", "merge-every"])
def test_knob_flags_print_the_jax_stdout(flags, capsysbinary, monkeypatch,
                                         tmp_path):
    """The port (its kernel path, as 'auto' resolves here) against the JAX
    CLI's single-buffer run at the same flags (its plain backend on the
    CPU; the corpus has no token longer than W).  ``--combiner salt`` and
    ``--sort-mode segmin``: ``tests/test_torch_cli.py``."""
    monkeypatch.chdir(REPO)
    other = tmp_path / "more.txt"
    other.write_bytes(b"Good Good\tbye\nHello " * 700)
    files = ["test.txt", str(other)]
    jax_flags = [f for f in flags if f not in ("--stream", "--chunk-bytes",
                                               "4096", "--merge-every", "2")]
    rc, want = _jax_main(files + jax_flags)
    assert rc == 0
    assert cli.main(files + list(flags) + ["--platform", "cpu"]) == 0
    assert capsysbinary.readouterr().out == want


@pytest.mark.parametrize("flags", [
    ("--merge-every", "2"),
    ("--stream", "--merge-every", "2", "--ngram", "2"),
    ("--merge-every", "2", "--grep", "x"),
    ("--merge-every", "2", "--sample", "3"),
    ("--stream", "--merge-every", "0")],
    ids=["no-stream", "ngram", "grep", "sample", "zero"])
def test_merge_every_usage_errors_match_jax_cli(flags, capsys):
    errs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["test.txt", *flags] + (["--platform", "cpu"]
                                         if main is cli.main else []))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    want, got = errs
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]
