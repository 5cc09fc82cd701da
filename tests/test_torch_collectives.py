"""The port's collectives over a gloo world of CPU ranks against the JAX
package's under ``shard_map`` on a CPU mesh of the same size.

Crafted tables (chosen keys, counts past 2**32 when summed, keys with
``key_hi >= 2**31``) go through ``tree_merge``, ``gather_merge`` and
``key_range_merge`` on D = 2, 3 and 4 ranks (3 is not a power of two, so
``tree`` takes ``gather``), and ``psum64`` sums lane pairs with carries;
every field equals the JAX result exactly, on every rank.  Keyrange's
budget spill never reports a key with a partial count, and on tiny
skewed tables keyrange equals tree.  One world a size runs every case
(``tests/torch_world.py``).  Also: the pure byte-range helpers, the
``DataAxis`` of a process outside a world, and the Engine's and
``Config``'s strategy checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.ops import table as jtable
from mapreduce_tpu.parallel import collectives as jcoll
from mapreduce_tpu.parallel import distributed as jdist
from mapreduce_tpu.parallel.compat import shard_map
from mapreduce_tpu.parallel.mesh import data_mesh as jdata_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import grep
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.parallel import distributed, mesh
from mapreduce_tpu_torch.parallel.mapreduce import Engine

SIZES = (2, 3, 4)
CAP = 64
OPS = ("tree", "gather", "keyrange")


def _random_tables(d: int, seed: int):
    """Rank r's rows (key_hi, key_lo, pos_hi, pos_lo, count, length): 40
    keys each from a pool of 90 (so keys meet across ranks and the merge
    spills past CAP), a third with ``key_hi >= 2**31``, and one key on
    every rank whose counts sum past 2**32."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 32, 90, dtype=np.int64)
    hi[:30] |= 1 << 31
    pool = list(zip(hi.tolist(), rng.integers(0, (1 << 32) - 2, 90,
                                              dtype=np.int64).tolist()))
    big = (123, 456)
    out = []
    for r in range(d):
        keys = [pool[i] for i in rng.choice(90, 40, replace=False)]
        rows = [(kh, kl, r, int(rng.integers(0, 4096)),
                 int(rng.integers(1, 9)), int(rng.integers(1, 30)))
                for kh, kl in keys]
        rows.append((*big, r, 7, 0xF0000000, 5))
        out.append(rows)
    return out


def _spill_tables(d: int):
    """Rank 0 holds 60 keys of partition 3 (``key_lo % d == 3``), past
    keyrange's budget B = 48 at capacity 64; rank 1 holds copies of the 8
    largest and 10 keys of its own; the others hold nothing."""
    hot = [(0x1000 + i, d * i + 3) for i in range(60)]
    copies = hot[-8:]
    own = [(0x9000 + i, d * i + 1) for i in range(10)]
    rows0 = [(kh, kl, 0, i, 1, 3) for i, (kh, kl) in enumerate(hot)]
    rows1 = [(kh, kl, 1, i, 1, 3) for i, (kh, kl) in enumerate(copies + own)]
    return [rows0, rows1] + [[] for _ in range(d - 2)]


def _skewed_tables(d: int, seed: int):
    """Tiny-capacity tables (16) of 12 keys each from a pool of 40."""
    rng = np.random.default_rng(seed)
    pool = [(int(h), int(lo)) for h, lo in zip(
        rng.integers(0, 1 << 32, 40), rng.integers(0, 1 << 32, 40))]
    return [[(kh, kl, r, i, int(rng.integers(1, 4)), 4) for i, (kh, kl)
             in enumerate(pool[j] for j in rng.choice(40, 12,
                                                      replace=False))]
            for r in range(d)]


def _pairs(d: int):
    return [[0xFFFFFFF0 - r, r] for r in range(d)]


def _jax_tables(rows_per_dev, cap: int):
    """Stacked per-device JAX tables built through the JAX ``_build``."""
    stacked = []
    for rows in rows_per_dev:
        n = max(len(rows), 1)
        pad = -(-n // 8) * 8
        cols = np.zeros((6, pad), np.uint32)
        cols[0:2] = 0xFFFFFFFF
        cols[2:4] = 0xFFFFFFFF
        for i, row in enumerate(rows):
            cols[:, i] = row
        z = jnp.uint32(0)
        stacked.append(jtable._build(
            *(jnp.asarray(c) for c in cols[:5]),
            jnp.zeros((pad,), jnp.uint32), jnp.asarray(cols[5]), cap,
            z, z, z, z))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *stacked)


def _jax_collective(d: int, fn, stacked):
    from jax.sharding import PartitionSpec as P

    def body(state):
        return fn(jax.tree.map(lambda x: x[0], state))

    prog = shard_map(body, mesh=jdata_mesh(d), in_specs=(P("data"),),
                     out_specs=P(), check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(prog)(stacked))


def _jax_op(op: str, cap: int):
    merge = lambda a, b: jtable.merge(a, b, capacity=cap)  # noqa: E731
    if op == "tree":
        return lambda t: jcoll.tree_merge(t, merge, "data")
    if op == "gather":
        return lambda t: jcoll.gather_merge(t, merge, "data")
    return lambda t: jcoll.key_range_merge(t, "data")


def _cases(d: int) -> list:
    cases = [{"name": f"random-{op}", "kind": "collective",
              "args": {"op": op, "tables": _random_tables(d, 7 + d),
                       "capacity": CAP}} for op in OPS]
    cases.append({"name": "psum64", "kind": "collective",
                  "args": {"op": "psum64", "pairs": _pairs(d)}})
    cases.append({"name": "psum", "kind": "collective",
                  "args": {"op": "psum", "pairs": [
                      [v & 0xFFFF for v in p] for p in _pairs(d)]}})
    if d == 4:
        cases.append({"name": "spill-keyrange", "kind": "collective",
                      "args": {"op": "keyrange", "tables": _spill_tables(d),
                               "capacity": CAP}})
        for op in ("keyrange", "tree"):
            for seed in range(3):
                cases.append({"name": f"skewed{seed}-{op}",
                              "kind": "collective",
                              "args": {"op": op, "capacity": 16,
                                       "tables": _skewed_tables(d, seed)}})
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every size's world, each running all its cases once, in the
    background while the tests compute their JAX references."""
    tmp = {d: tmp_path_factory.mktemp(f"w{d}") for d in SIZES}
    return torch_world.Later(lambda: {
        d: torch_world.spawn_world(d, _cases(d), tmp[d]) for d in SIZES})


def _port(worlds, d: int, name: str):
    """The result of ``name`` on rank 0, after checking every rank got the
    same (the collectives replicate)."""
    got = [w[name] for w in worlds[d]]
    assert not (type(got[0]) is tuple and got[0][:1] == ("error",)), got[0]
    for other in got[1:]:
        _assert_same(got[0], other)
    return got[0]


def _assert_same(a, b):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
    else:
        assert a == b


def _assert_table_equal(jax_table, port_table):
    for f in jax_table._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(port_table, f)).astype(np.uint32),
            np.asarray(getattr(jax_table, f)), err_msg=f)


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax(worlds, d, op):
    want = _jax_collective(d, _jax_op(op, CAP),
                           _jax_tables(_random_tables(d, 7 + d), CAP))
    got = _port(worlds, d, f"random-{op}")
    _assert_table_equal(want, got)
    # The big key's counts carried past 2**32.
    assert (np.asarray(got.count_hi) > 0).any()


@pytest.mark.parametrize("d", SIZES)
def test_psum64_carries_match_jax(worlds, d):
    pairs = np.asarray(_pairs(d), np.uint32)
    want = _jax_collective(
        d, lambda p: jcoll.psum64(p[0], p[1], "data"), jnp.asarray(pairs))
    total = sum(lo + (hi << 32) for lo, hi in _pairs(d))
    assert _port(worlds, d, "psum64") == tuple(int(x) for x in want) \
        == (total & 0xFFFFFFFF, total >> 32)
    assert total >> 32 > sum(hi for _, hi in _pairs(d))  # lanes carried


@pytest.mark.parametrize("d", SIZES)
def test_psum_matches_jax(worlds, d):
    """The additive all-reduce of a state's leaves (small values: JAX
    sums uint32 lanes, which these do not overflow)."""
    pairs = np.asarray(_pairs(d), np.uint32) & np.uint32(0xFFFF)
    want = _jax_collective(d, lambda p: jcoll.psum((p, p[0]), "data"),
                           jnp.asarray(pairs))
    got = _port(worlds, d, "psum")
    assert got == (want[0].tolist(), int(want[1]))


def test_keyrange_budget_spill_never_partial(worlds):
    """A partition past the budget on rank 0: the spilled keys are evicted
    everywhere, never reported with a partial count, all their mass is in
    ``dropped_count``, the survivors are the smallest keys, and the result
    equals the JAX package's."""
    d = 4
    tables = _spill_tables(d)
    got = _port(worlds, d, "spill-keyrange")
    _assert_table_equal(_jax_collective(d, _jax_op("keyrange", CAP),
                                        _jax_tables(tables, CAP)), got)
    kept = {(int(h), int(lo)): int(c) for h, lo, c in
            zip(got.key_hi, got.key_lo, got.count) if c}
    truth: dict = {}
    for rows in tables:
        for kh, kl, *_, cnt, _ in rows:
            truth[(kh, kl)] = truth.get((kh, kl), 0) + cnt
    for k, c in kept.items():
        assert truth[k] == c, (k, c)
    assert len(kept) < len(truth)
    dc = int(got.dropped_count) + (int(got.dropped_count_hi) << 32)
    assert sum(kept.values()) + dc == sum(truth.values())
    spilled = sorted(set(truth) - set(kept))
    surviving_hot = [k for k in kept if k[1] % d == 3]
    assert spilled and max(surviving_hot) < min(spilled)


@pytest.mark.parametrize("seed", range(3))
def test_keyrange_tiny_capacity_skewed_equals_tree(worlds, seed):
    """Capacity 16 over 4 ranks (a block budget of order C/D): keyrange
    equals tree on every field but the ``dropped_uniques`` bound, and
    equals the JAX keyrange."""
    d = 4
    tables = _skewed_tables(d, seed)
    kr = _port(worlds, d, f"skewed{seed}-keyrange")
    tree = _port(worlds, d, f"skewed{seed}-tree")
    _assert_table_equal(_jax_collective(d, _jax_op("keyrange", 16),
                                        _jax_tables(tables, 16)), kr)
    for f in kr._fields:
        if not f.startswith("dropped_uniques"):
            np.testing.assert_array_equal(getattr(kr, f), getattr(tree, f),
                                          err_msg=f)


def test_byte_range_helpers_match_jax(tmp_path):
    data = b"alpha beta\ngamma  delta\tepsilon " * 300 + b"zeta"
    path = tmp_path / "c.txt"
    path.write_bytes(data)
    for n in (1, 3, 4, 7):
        ranges = [distributed.host_byte_range(len(data), p, n)
                  for p in range(n)]
        assert ranges == [jdist.host_byte_range(len(data), p, n)
                          for p in range(n)]
        for lo, hi in ranges:
            for kw in ({}, {"separators": b"\n"}, {"max_token_bytes": 3}):
                assert distributed.align_range_to_separator(
                    str(path), lo, hi, **kw) \
                    == jdist.align_range_to_separator(str(path), lo, hi, **kw)
    assert list(distributed.host_shards(16, 1, 4)) \
        == list(jdist.host_shards(16, 1, 4))
    with pytest.raises(ValueError, match="outside"):
        distributed.host_byte_range(100, 4, 4)
    with pytest.raises(ValueError, match="do not divide"):
        distributed.host_shards(10, 0, 4)
    # Outside a world the defaults are rank 0 of 1.
    assert distributed.host_byte_range(100) == (0, 100)
    assert list(distributed.host_shards(3)) == [0, 1, 2]


def test_data_mesh_outside_a_world(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    axis = mesh.data_mesh()
    assert (axis.rank, axis.size, axis.group) == (0, 1, None)
    assert axis.coordinator and mesh.data_mesh(1).size == 1
    with pytest.raises(ValueError, match="torchrun"):
        mesh.data_mesh(2)
    # Without a launcher, initialize joins nothing.
    assert distributed.initialize("cpu").type == "cpu"
    assert distributed.is_coordinator()


def test_engine_strategy_checks():
    """The JAX Engine's checks: an unresolved 'auto', an unknown name,
    keyrange without the hook; a two-level strategy on a one-axis mesh
    is refused with the JAX message."""
    job = wc.WordCountJob(Config(), "cpu")
    for bad, match in (("auto", "unresolved"), ("nope", "unknown"),
                       ("hier-kr-tree", "composes two mesh levels"),
                       ("hier-tree-tree", "composes two mesh levels")):
        with pytest.raises(ValueError, match=match):
            Engine(job, "cpu", merge_strategy=bad)
    with pytest.raises(ValueError, match="keyrange_merge hook"):
        Engine(grep.GrepJob(b"x", device="cpu"), "cpu",
               merge_strategy="keyrange")
    for ok in ("tree", "gather", "keyrange"):
        assert Engine(job, "cpu", merge_strategy=ok).n_devices == 1


def test_config_merge_strategy_matches_jax():
    for s in ("tree", "gather", "keyrange", "auto"):
        assert Config(merge_strategy=s).resolved_merge_strategy \
            == JConfig(merge_strategy=s).resolved_merge_strategy
        assert convert.config_from_dict(dataclasses.asdict(
            JConfig(merge_strategy=s, backend="pallas"))).merge_strategy == s
    for s in ("hier-kr-tree", "hier-tree-tree"):
        assert Config(merge_strategy=s).resolved_merge_strategy \
            == JConfig(merge_strategy=s).resolved_merge_strategy == s
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match="unknown merge_strategy"):
            cls(merge_strategy="nope")
