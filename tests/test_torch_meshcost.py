"""The port's link model (``mapreduce_tpu_torch/analysis/meshcost.py``)
against the JAX package's (``mapreduce_tpu/analysis/meshcost.py``).

The JAX module is stdlib only and is loaded by file path (importing
``mapreduce_tpu.analysis`` needs the ``jax.core`` alias).  Its link levels
are a TPU's (``ici``, ``dcn``) and the port's a card's (``nvlink``,
``net``): the same arithmetic is compared at the same rates under the map
ici -> nvlink, dcn -> net, on hypothesis-drawn payloads, sizes and rates.
Floating point: every schedule is the same expression in both, so the
comparison is exact.
"""

import importlib.util
import json
import math
import pathlib
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mapreduce_tpu_torch.analysis import meshcost
from mapreduce_tpu_torch.parallel import collectives

REPO = pathlib.Path(__file__).resolve().parents[1]
LEVELS = {"ici": "nvlink", "dcn": "net", "hbm": "hbm"}


def _load_jax_meshcost():
    name = "_jax_meshcost"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, REPO / "mapreduce_tpu" / "analysis" / "meshcost.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


jmc = _load_jax_meshcost()

rates = st.tuples(st.floats(1e-7, 1e-3), st.floats(0.5, 5000.0))
payloads = st.integers(0, 1 << 34)
sizes = st.integers(1, 4096)


def _links(alpha_s, beta_gbps):
    return (jmc.Link("ici", alpha_s, beta_gbps * 1e9),
            meshcost.Link("nvlink", alpha_s, beta_gbps * 1e9))


def _rates(spec):
    """The same rates as each package's fixture dict: ``{level: (alpha,
    beta_gbps)}`` with the JAX level names."""
    j = {"levels": {k: jmc.Link(k, a, b * 1e9) for k, (a, b) in spec.items()},
         "keyrange_slack": 2.0}
    p = {"levels": {LEVELS[k]: meshcost.Link(LEVELS[k], a, b * 1e9)
                    for k, (a, b) in spec.items()},
         "keyrange_slack": 2.0}
    return j, p


@settings(max_examples=150, deadline=None)
@given(m=payloads, d=sizes, rate=rates)
def test_schedules_equal_jax(m, d, rate):
    jl, pl = _links(*rate)
    for fn in ("allreduce_ring", "allreduce_tree", "allgather",
               "reduce_scatter", "all_to_all"):
        assert getattr(meshcost, fn)(m, d, pl) == getattr(jmc, fn)(m, d, jl)
    for slack in (1.0, 2.0, 3.5):
        assert meshcost.keyrange(m, d, pl, slack) \
            == jmc.keyrange(m, d, jl, slack)
    want = jmc.ring_tree_crossover_bytes(d, jl)
    got = meshcost.ring_tree_crossover_bytes(d, pl)
    assert got == want or (math.isinf(got) and math.isinf(want))


def test_ring_tree_crossover_at_four_is_eight_alpha_beta():
    link = meshcost.Link("nvlink", 5e-6, 450e9)
    assert meshcost.ring_tree_crossover_bytes(4, link) \
        == pytest.approx(8 * 5e-6 * 450e9)
    assert math.isinf(meshcost.ring_tree_crossover_bytes(2, link))


@settings(max_examples=150, deadline=None)
@given(cap=st.integers(1, 1 << 22), d=sizes,
       slack=st.floats(0.5, 8.0))
def test_keyrange_budget_rows_equal_jax_and_the_runtime(cap, d, slack):
    got = meshcost.keyrange_budget_rows(cap, d, slack)
    assert got == jmc.keyrange_budget_rows(cap, d, slack)
    if d > 1:
        assert got == collectives._block_budget(cap, d, slack)


def test_strategies_in_bijection_with_the_runtime():
    assert set(meshcost.STRATEGIES) == set(collectives.STRATEGIES)
    assert set(meshcost.STRATEGIES) == set(jmc.STRATEGIES)
    for name, strat in meshcost.STRATEGIES.items():
        rt = collectives.STRATEGIES[name]
        assert strat.name == name
        assert strat.builder == rt["builder"]
        assert strat.power_of_two_only == rt["power_of_two_only"]
        assert strat.needs_keyrange_hook == rt["needs_keyrange_hook"]
        fn = strat.builder.rsplit(".", 1)[1]
        assert callable(getattr(collectives, fn))
        jstrat = jmc.STRATEGIES[name]
        assert (strat.power_of_two_only, strat.needs_keyrange_hook) \
            == (jstrat.power_of_two_only, jstrat.needs_keyrange_hook)


shapes = st.tuples(st.integers(1, 16), st.integers(1, 16))


@settings(max_examples=100, deadline=None)
@given(shape=shapes, m=payloads,
       rate=st.fixed_dictionaries({"hbm": rates, "ici": rates,
                                   "dcn": rates}),
       strategy=st.sampled_from(sorted(meshcost.STRATEGIES)))
def test_price_strategy_equals_jax(shape, m, rate, strategy):
    p, ld = shape
    jr, pr = _rates(rate)
    jmesh = jmc.MeshSpec.fleet(p, ld) if p > 1 \
        else jmc.MeshSpec.single_host(ld)
    pmesh = meshcost.MeshSpec.fleet(p, ld) if p > 1 \
        else meshcost.MeshSpec.single_host(ld)
    want = jmc.price_strategy(strategy, m, jmesh, jr["levels"])
    got = meshcost.price_strategy(strategy, m, pmesh, pr["levels"])
    assert got["modeled_s"] == want["modeled_s"]
    assert [(lv["axis"], lv["d"], LEVELS[lv["level"]], lv["seconds"])
            for lv in want["per_level"]] \
        == [(lv["axis"], lv["d"], lv["level"], lv["seconds"])
            for lv in got["per_level"]]
    assert got["builder"].startswith("mapreduce_tpu_torch.parallel.")


@settings(max_examples=100, deadline=None)
@given(shape=shapes, cap=st.integers(2, 1 << 20),
       rate=st.fixed_dictionaries({"hbm": rates, "ici": rates,
                                   "dcn": rates}),
       top_mass=st.one_of(st.none(), st.floats(0.0, 0.9)),
       occupancy=st.one_of(st.none(), st.floats(0.0, 1.0)),
       hook=st.booleans())
def test_plan_ranks_and_skips_as_jax(shape, cap, rate, top_mass, occupancy,
                                     hook):
    p, ld = shape
    jr, pr = _rates(rate)
    kw = dict(top_mass=top_mass, table_occupancy=occupancy,
              has_keyrange_hook=hook, incumbent="tree")
    want = jmc.plan(p, ld, cap, rates=jr, **kw)
    got = meshcost.plan(p, ld, cap, rates=pr, **kw)
    assert [r["strategy"] for r in got["ranked"]] \
        == [r["strategy"] for r in want["ranked"]]
    assert [r["modeled_s"] for r in got["ranked"]] \
        == [r["modeled_s"] for r in want["ranked"]]
    assert [s["strategy"] for s in got["skipped"]] \
        == [s["strategy"] for s in want["skipped"]]
    assert (got["top"], got["incumbent_is_top"], got["payload_bytes"]) \
        == (want["top"], want["incumbent_is_top"], want["payload_bytes"])
    for g, w in zip(got["ranked"], want["ranked"]):
        assert g.get("spill_risk") == w.get("spill_risk")
        assert g.get("keyrange_budget_rows") == w.get("keyrange_budget_rows")


@settings(max_examples=60, deadline=None)
@given(m=payloads, shape=shapes,
       rate=st.fixed_dictionaries({"hbm": rates, "ici": rates,
                                   "dcn": rates}),
       prim=st.sampled_from(sorted(jmc.COLLECTIVE_PRIMS)))
def test_price_eqn_equals_jax(m, shape, rate, prim):
    p, ld = shape
    jr, pr = _rates(rate)
    names = ("replica", "data")
    want = jmc.price_eqn(prim, m, names, jmc.MeshSpec.from_mesh(
        names, (p, ld), processes=p), jr["levels"])
    got = meshcost.price_eqn(prim, m, names, meshcost.MeshSpec.from_mesh(
        names, (p, ld), processes=p), pr["levels"])
    if want is None:
        assert got is None
        return
    assert got["seconds"] == want["seconds"]
    assert got["schedule"] == want["schedule"]


def test_mesh_labels_and_levels():
    spec = meshcost.MeshSpec.fleet(2, 4)
    assert spec.label() == "2nx4v" and spec.slowest_level() == "net"
    assert [a.level for a in spec.axes] == ["net", "nvlink"]
    assert meshcost.MeshSpec.single_host(8).label() == "8v"
    assert meshcost.MeshSpec.from_mesh(("data",), (8,), 8).label() == "8n"
    assert meshcost.table_bytes(512) == jmc.table_bytes(512)
    for op, prim in meshcost.C10D_PRIMS.items():
        assert prim in meshcost.COLLECTIVE_PRIMS, op


def test_link_rates_name_their_sources_and_no_tpu_number():
    raw = json.loads(pathlib.Path(meshcost.LINK_RATES_PATH).read_text())
    assert set(raw["levels"]) == {"hbm", "nvlink", "net"}
    assert raw["levels"]["hbm"]["source"] == "measured"
    assert raw["levels"]["nvlink"]["source"] == "datasheet"
    assert raw["levels"]["net"]["source"] == "datasheet"
    measured = json.loads((pathlib.Path(meshcost.LINK_RATES_PATH).parent
                           / "measured_rates.json").read_text())
    assert raw["levels"]["hbm"]["beta_gbps"] == measured["copy_gbps"]
    tpu = json.loads((REPO / "mapreduce_tpu" / "analysis" / "baselines"
                      / "measured_link_rates.json").read_text())
    tpu_numbers = {v[k] for v in tpu["levels"].values()
                   for k in ("alpha_s", "beta_gbps")}
    assert not {v[k] for v in raw["levels"].values()
                for k in ("alpha_s", "beta_gbps")} & tpu_numbers
    loaded = meshcost.load_link_rates()
    assert loaded["levels"]["nvlink"].beta_bps == 450e9
    assert loaded["keyrange_slack"] == 2.0
