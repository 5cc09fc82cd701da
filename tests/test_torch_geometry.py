"""The port's geometry search (``mapreduce_tpu_torch/analysis/geometry.py``)
against the JAX package's (``mapreduce_tpu/analysis/geometry.py``) on the
CPU.

The JAX module needs no JAX (its imports are ``config`` and
``ops/pallas/meta``) and is loaded by file path.  The two walk the same
lattice, so a ``tuned.json`` from either names the same geometries: the
candidates' labels, axes and geometry dicts are equal, and ``label_for``
agrees on every point.  The port certifies against its own plans (static
shared memory, blocks an SM, the register cap, ``MAX_CACHE``) and prices
with its own cost model, where the fields it does not read price as the
default and are marked ``inert``.
"""

import dataclasses
import importlib.util
import pathlib
import sys

import pytest

from mapreduce_tpu.config import Geometry as JGeometry
from mapreduce_tpu_torch.analysis import geometry
from mapreduce_tpu_torch.config import DEFAULT_GEOMETRY, Geometry
from mapreduce_tpu_torch.ops.cuda import plans

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_geometry():
    name = "_jax_geometry"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, REPO / "mapreduce_tpu" / "analysis" / "geometry.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.fixture(scope="module")
def both():
    jgeo = _jax_geometry()
    return jgeo.enumerate_candidates(), geometry.enumerate_candidates()


def test_candidates_name_the_jax_geometries(both):
    want, got = both
    assert [c.label for c in got] == [c.label for c in want]
    assert [c.axis for c in got] == [c.axis for c in want]
    assert [c.geometry.as_dict() for c in got] \
        == [c.geometry.as_dict() for c in want]
    assert got[0].label == "default" and got[0].axis == "default"
    assert geometry.LATTICE_AXES == _jax_geometry().LATTICE_AXES


def test_label_for_equals_jax_over_the_lattice(both):
    jgeo = _jax_geometry()
    for c in both[1]:
        spec = c.geometry.as_dict()
        assert geometry.label_for(Geometry(**spec)) \
            == jgeo.label_for(JGeometry(**spec))
    assert geometry.label_for(Geometry(combiner_slots=16)) == "combiner16"
    assert geometry.label_for(Geometry(radix_bits=5, aux_rows=128)) \
        == "aux_rows=128,radix_bits=5"


def test_off_lattice_points_are_dropped_by_geometry_itself():
    for bad in ({"block_rows": 200}, {"combiner_slots": 40},
                {"radix_bits": 6}, {"sort3_slots": 76}):
        with pytest.raises(ValueError):
            Geometry(**bad)
    labels = {c.label for c in geometry.enumerate_candidates()}
    assert "sort3_block_rows=256,sort3_slots=136" not in labels


def test_every_candidate_certifies_and_the_certifier_bites(monkeypatch):
    for c in geometry.enumerate_candidates():
        assert geometry.certify(c.geometry) == [], c.label
    # Over the port's limits: a cache deeper than the kernels hold, and
    # a static shared-memory budget below the combiner's kernel.
    monkeypatch.setattr(plans, "MAX_CACHE", 16)
    errs = geometry.certify(Geometry(combiner_slots=24))
    assert any("cache entries" in e for e in errs)
    assert not geometry.certify(Geometry(combiner_slots=16))
    monkeypatch.setattr(plans, "STATIC_SMEM_LIMIT", 16 * 1024)
    errs = geometry.certify(DEFAULT_GEOMETRY)
    assert any("combiner_stream" in e and "static shared" in e for e in errs)
    assert any("sort_scatter" in e for e in errs)
    monkeypatch.undo()
    monkeypatch.setattr(geometry, "REGISTER_FLOOR", 64)
    assert any("tokenize_stream" in e and "registers" in e
               for e in geometry.certify(DEFAULT_GEOMETRY))


def test_price_reads_only_the_fields_the_port_reads():
    base = geometry.price(DEFAULT_GEOMETRY)
    for inert in (Geometry(block_rows=512), Geometry(aux_rows=128),
                  Geometry(radix_slab_slack=2), Geometry(pair_block_rows=128)):
        assert geometry.price(inert) == base
        assert geometry.inert(inert)
    assert not geometry.inert(DEFAULT_GEOMETRY)
    deeper = geometry.price(Geometry(combiner_slots=32))
    assert deeper["combiner_bytes"] > base["combiner_bytes"]
    assert deeper["sort_rows"] == base["sort_rows"]
    wide = geometry.price(Geometry(radix_bits=5))
    assert wide["radix_amplification"] < base["radix_amplification"]
    # The sort's rows are the dense stream's, from the card's fixture.
    assert base["sort_rows"] == 5314937
    assert base["sort_pass_bytes"] == 2 * base["sort_rows"] * 3 * 8
    assert geometry.price(DEFAULT_GEOMETRY, 1 << 20)["sort_rows"] \
        == round(5314937 / 32)


def test_shortlist_tie_break_ranks_inert_candidates_after():
    cands = geometry.enumerate_candidates()
    top = geometry.shortlist(cands, k=len(cands))
    assert top[0].label in ("radix_bits=4", "radix_bits=5")
    pos = {c.label: i for i, c in enumerate(top)}
    assert pos["default"] < pos["tall512"]
    assert pos["radix_bits=5"] < pos["radix_bits=5,radix_slab_slack=2"]
    # Within the default's price, the candidates that move a launch come
    # first, then the inert ones (every TPU-only field).
    d = top[pos["default"]]
    group = [c.inert for c in top
             if (c.radix_amplification, c.combiner_bytes, c.smem_peak_bytes)
             == (d.radix_amplification, d.combiner_bytes, d.smem_peak_bytes)]
    assert group == sorted(group) and group.count(True) > 10
    narrowed = geometry.shortlist(cands, k=10, axis="combiner_slots")
    assert {c.axis for c in narrowed} <= {"combiner_slots", "default"}
    assert narrowed[0].label == "default"  # a deeper cache costs bytes


def test_search_artifact_has_the_jax_keys(both):
    jgeo = _jax_geometry()
    want = jgeo.search_artifact(both[0])
    got = geometry.search_artifact(both[1])
    assert set(got) == set(want)
    assert (got["candidates"], got["pricing_chunk_bytes"],
            got["geometry_search_version"]) == (
        want["candidates"], want["pricing_chunk_bytes"],
        want["geometry_search_version"])
    assert got["default"]["label"] == "default"
    assert len(got["shortlist"]) == 5
    assert {"inert", "smem_peak_bytes", "combiner_bytes"} \
        <= set(got["shortlist"][0])


def test_geometry_plans_are_the_production_plans():
    labels = {p.geometry for p in plans.production_plans()}
    assert labels == {"default", "tall512", "combiner16"}
    got = plans.geometry_plans(Geometry(combiner_slots=16), "combiner16")
    fold = [p for p in got if p.wrapper == "combiner_fold"][0]
    assert dict(fold.sizes)["entries"] == 16 * plans.SEGMENTS
    assert dataclasses.replace(got[0], geometry="x").geometry == "x"


def test_stream_rows_reads_its_fixture_once_and_needs_it(monkeypatch,
                                                         tmp_path):
    """The sort rows scale from the card's fixture, read once; without the
    fixture the pricing raises instead of switching to another model."""
    rows = geometry.stream_rows(1 << 25)
    assert rows == geometry._measured_rows()[0]  # the fixture's own chunk
    monkeypatch.setattr(geometry, "_RATES_PATH", str(tmp_path / "none"))
    assert geometry.stream_rows(1 << 25) == rows  # cached, not re-read
    geometry._measured_rows.cache_clear()
    try:
        with pytest.raises(OSError):
            geometry.stream_rows(1 << 25)
    finally:
        monkeypatch.undo()
        geometry._measured_rows.cache_clear()


@pytest.mark.parametrize("cslots", [8, 16, 24, 32])
def test_combiner_bytes_are_what_the_cost_model_charges(cslots):
    """The search and the cost model price the combiner alike: its flushed
    planes and the scratch its two plans declare, which the cost model
    charges on each kernel node."""
    n = plans.PRODUCTION_CHUNK
    nodes = [plans.combiner(n, 32, cslots),
             plans.combiner_fold(cslots * plans.SEGMENTS, 1 << 18)]
    charged = sum(sum(p.scratch_bytes) for p in nodes)
    assert geometry.combiner_bytes(Geometry(combiner_slots=cslots), n) \
        == charged + 4 * 8 * cslots * plans.SEGMENTS
    # A window after its segment's first reads the key list back.
    wps = plans.combiner_windows(n)
    assert ("list", 16 * cslots * plans.SEGMENTS * (wps - 1), 0) \
        in nodes[0].scratch
