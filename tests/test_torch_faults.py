"""The streamed executor's failure policy, fault plans and preemption: the
port against the JAX package, on the CPU.

Module parity: ``classify``, ``backoff_s``, the spec grammar, ``decide``,
``ladder_walk``, ``from_ledger`` and ``fired_sequence`` give the JAX
module's answers on the same inputs (the port's deliberate difference, the
CUDA runtime's sticky errors, is stated case by case).

Executor parity: both packages stream the same 5-chunk file (4 KB chunks,
table capacity 2048; the JAX side on a one-device mesh, backend pallas, its
Pallas kernel in interpret mode) under the same fault plan or failure, at
``(inflight_groups, superstep)`` of (4, 1), (1, 1) and (4, 3).  Each plan
is captured by wrapping ``FaultPlan.resolve``; the finished tables must be
equal field for field, the fired ``(seam, index, class)`` sequences equal,
the ladder's steps equal, a failure the same exception at the same step, a
preemption the same step and cursor, and every result the oracle's.
"""

import contextlib
import dataclasses
import logging
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.parallel import mapreduce as jmr
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu.runtime import faults as jfaults
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.parallel import mapreduce as pmr
from mapreduce_tpu_torch.runtime import checkpoint as ckpt
from mapreduce_tpu_torch.runtime import executor, faults
from mapreduce_tpu_torch.runtime.logging import LOGGER_NAME
from mapreduce_tpu_torch.utils import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
CHUNK = 4096
JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=CHUNK, table_capacity=2048,
               rescue_overlong=4)
WINDOWS = [(4, 1), (1, 1), (4, 3)]
#: Every seam the port crosses but process-kill (tested on its own).
CROSSED = ("reader-read", "stage-acquire", "h2d", "dispatch", "token-wait",
           "checkpoint-save", "collective-finish")
NO_BACKOFF = {"backoff_base_s": 0.0, "jitter_frac": 0.0}


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_engines():
    """One JAX ``Engine`` per job kind and map configuration.  The JAX
    executor builds an Engine per run, and each compiles its programs anew
    (~12 s interpreted); the programs read neither the fault plan, the
    policy nor the pipeline knobs, so runs that differ only there share
    one."""
    memo = {}
    real = jexecutor.Engine

    def engine(job, mesh, **kw):
        cfg = dataclasses.replace(job.config, fault_plan=None,
                                  failure_policy=None, inflight_groups=1,
                                  superstep=1, prefetch_depth=None)
        key = (type(job), cfg, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = real(job, mesh, **kw)
        return memo[key]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jexecutor, "Engine", engine)
        yield


def _text(seed: int, n_words: int) -> bytes:
    """Zipf words with a token longer than W = 8 now and then (the
    rescue)."""
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(250)] + [b"abcdefgh"]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]
    for i in range(120, len(words), 900):
        words[i] = b"streamed_over%d" % (i % 3)
    return b" ".join(words)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = _text(7, 5200)
    p = tmp_path_factory.mktemp("faults") / "corpus.txt"
    p.write_bytes(data)
    # 5 chunks: a window of 4 fills, superstep 3 leaves a remainder of 2.
    assert len(list(reader_mod.iter_batches_multi(str(p), 1, CHUNK))) == 5
    return str(p), oracle.word_counts(data)


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------


def _classify_cases(f):
    """The inputs of the JAX package's ``test_classify_taxonomy``."""
    return [f.TransientFault("x"), f.ResourceFault("x"), f.PermanentFault("x"),
            f.PreemptionFault("x"), f.TokenTimeout("hung"),
            RuntimeError("RESOURCE_EXHAUSTED: failed to allocate"),
            RuntimeError("VMEM limit exceeded"),
            RuntimeError("host preempted: maintenance event"),
            KeyboardInterrupt(), ValueError("bad shape"), TypeError("no"),
            ValueError("bad bloom_bits"), KeyError("room_id"),
            ValueError("preempt_queue empty"),
            RuntimeError("bloom filter relay failed"),
            OSError("no room in zoom buffer"),
            RuntimeError("OOM when allocating"),
            RuntimeError("flaky relay"), OSError("read failed")]


def test_classify_matches_jax_and_classes_cuda_errors():
    assert [faults.classify(e) for e in _classify_cases(faults)] \
        == [jfaults.classify(e) for e in _classify_cases(jfaults)]
    # The CUDA runtime's errors: out of memory is a resource fault (as
    # in the JAX package); a sticky error poisons the context, so the port
    # fails at once where the JAX markers would retry it as transient.
    cuda = [
        (torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
            "total capacity of 79.19 GiB"), "resource", "resource"),
        (RuntimeError("CUDA error: out of memory"), "resource", "resource"),
        (RuntimeError("CUDA error: an illegal memory access was "
                      "encountered"), "permanent", "transient"),
        (RuntimeError("CUDA error: unspecified launch failure"),
         "permanent", "transient"),
        (RuntimeError("CUDA error: device-side assert triggered"),
         "permanent", "transient"),
        (RuntimeError("CUDA error: misaligned address"), "permanent",
         "transient"),
        (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
         "permanent", "transient"),
        (faults.TokenTimeout("completion token not ready"), "transient",
         None),
    ]
    for exc, port_class, jax_class in cuda:
        assert faults.classify(exc) == port_class, exc
        if jax_class is not None:
            assert jfaults.classify(exc) == jax_class, exc


def test_policy_backoff_and_resolution_match_jax():
    grid = [dict(), dict(backoff_base_s=0.01, backoff_factor=3.0,
                         backoff_max_s=0.5, jitter_frac=0.3, seed=11),
            dict(jitter_frac=0.0), dict(seed=7, jitter_frac=0.5)]
    for kw in grid:
        p, j = faults.FailurePolicy(**kw), jfaults.FailurePolicy(**kw)
        for cls in jfaults.FAULT_CLASSES:
            for seam in ("", "dispatch", "reader-read", "checkpoint-save"):
                got = [p.backoff_s(cls, a, seam=seam) for a in range(0, 9)]
                assert got == [j.backoff_s(cls, a, seam=seam)
                               for a in range(0, 9)]
            assert p.budget(cls) == j.budget(cls)
        assert p.as_dict() == j.as_dict()
    for retry in (0, 1, 3):
        p = faults.FailurePolicy.resolve(None, retry=retry)
        j = jfaults.FailurePolicy.resolve(None, retry=retry)
        assert p.as_dict() == j.as_dict()
        assert p.dispatch_budget == j.dispatch_budget
    for bad in (dict(transient_retries=-1), dict(backoff_factor=0.5),
                dict(jitter_frac=1.5), dict(token_timeout_s=0)):
        with pytest.raises(ValueError):
            faults.FailurePolicy(**bad)
    with pytest.raises(ValueError, match="failure_policy"):
        faults.FailurePolicy.resolve("not-a-policy")


SPECS = ["seed=9,rate=0.1,seams=dispatch+token-wait,classes=transient,max=3,"
         "at=checkpoint-save:0:resource",
         "seed=7,rate=0.2,classes=transient+resource,max=6",
         "at=token-wait:0:preemption,at=dispatch:3:permanent",
         "seed=3,rate=1.0,seams=process-kill",
         "seed=42,rate=0.02"]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_spec_and_decisions_match_jax(spec):
    p, j = faults.FaultPlan.from_spec(spec), jfaults.FaultPlan.from_spec(spec)
    assert p.spec == j.spec
    assert faults.FaultPlan.from_spec(p.spec).spec == p.spec
    assert p.events == j.events and p.seams == j.seams
    for seam in jfaults.SEAMS:
        for i in range(60):
            assert p.decide(seam, i) == j.decide(seam, i), (seam, i)
    # Crossing the seams in one order fires the same faults.
    order = [s for i in range(40) for s in jfaults.SEAMS]
    for seam in order:
        a, b = p.check(seam), j.check(seam)
        assert (a is None) == (b is None)
        if a is not None:
            assert (type(a).__name__, str(a)) == (type(b).__name__, str(b))
    assert p.fired == j.fired and p.counts == j.counts


def test_bad_specs_and_config_surface():
    for bad in ("", "rate=1.5", "at=dispatch:x:transient", "seams=warp",
                "classes=entropic", "bogus"):
        with pytest.raises(ValueError):
            faults.FaultPlan.from_spec(bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan.from_spec(bad)
    assert faults.FaultPlan.resolve(None) is None
    with pytest.raises(ValueError):
        wc.Config(fault_plan="rate=2.0")
    with pytest.raises(ValueError, match="fault_plan"):
        wc.Config(fault_plan=123)
    c = wc.Config(failure_policy={"transient_retries": 2, "degrade": False})
    assert isinstance(c.failure_policy, faults.FailurePolicy)
    assert c.failure_policy.transient_retries == 2
    hash(c)
    with pytest.raises(ValueError, match="failure_policy"):
        wc.Config(failure_policy="retry-lots")


def test_ladder_and_ledger_replay_match_jax():
    for start in ({"geometry": "tall512", "combiner": "hot-cache",
                   "map_impl": "fused", "sort_impl": "radix"},
                  {"geometry": "default", "combiner": "hot-cache",
                   "map_impl": "fused", "sort_impl": "radix"},
                  {"geometry": "default", "combiner": "off",
                   "map_impl": "split", "sort_impl": "radix_partition"},
                  {"geometry": "default", "combiner": "off",
                   "map_impl": "split", "sort_impl": "xla"}):
        assert faults.ladder_walk(start) == jfaults.ladder_walk(start)
        assert faults.next_degrade(start) == jfaults.next_degrade(start)
    # The port's own config summary walks the ladder from its kernels.
    cfg = wc.Config(map_impl="fused", combiner="hot-cache", sort_impl="radix")
    assert faults.ladder_walk(executor._config_summary(cfg)) \
        == ["combiner-off", "map-split", "sort-xla"]
    records = [
        {"kind": "run_start", "run_id": "a"},
        {"kind": "fault", "run_id": "a", "injected": True,
         "seam": "dispatch", "index": 3, "fault_class": "resource"},
        {"kind": "fault", "run_id": "a", "injected": False,
         "seam": "token-wait", "index": 0, "fault_class": "transient"},
        {"kind": "fault", "injected": True, "seam": "h2d", "index": 1,
         "fault_class": "transient"},
        {"kind": "fault", "run_id": "b", "injected": True,
         "seam": "reader-read", "index": 2, "fault_class": "permanent"},
        {"kind": "fault", "run_id": "a", "injected": True,
         "seam": "warp", "index": 2, "fault_class": "transient"},
        "not a record",
    ]
    for run_id in (None, "a", "b", "c"):
        assert faults.fired_sequence(records, run_id) \
            == jfaults.fired_sequence(records, run_id)
        p = faults.FaultPlan.from_ledger(records, run_id)
        j = jfaults.FaultPlan.from_ledger(records, run_id)
        assert p.events == j.events and p.spec == j.spec


# ---------------------------------------------------------------------------
# executor parity
# ---------------------------------------------------------------------------


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append((record.getMessage(),
                             dict(getattr(record, "fields", {}))))


@contextlib.contextmanager
def _logs(name):
    h = _Capture()
    logger = logging.getLogger(name)
    logger.addHandler(h)
    try:
        yield h.records
    finally:
        logger.removeHandler(h)


class _Killed(BaseException):
    """Stands in for ``os._exit`` at the process-kill seam."""


def _configs(inflight, superstep, **kw):
    jcfg = dataclasses.replace(JCFG, inflight_groups=inflight,
                               superstep=superstep, **kw)
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _outcome(fn, log_name):
    """``(result or exception, the 'step failed' records)`` of a run."""
    with _logs(log_name) as records:
        try:
            out = fn()
        except (Exception, _Killed) as e:
            out = e
    return out, [(f["step"], f["offset"], f.get("fault_class"))
                 for m, f in records if m == "step failed"]


def _run_both(path, monkeypatch, inflight, superstep, *, plan=None,
              policy=None, retry=0, ck_dir=None, checkpoint_every=0,
              jax_config=None):
    """Run the JAX and the port's ``run_job`` on ``path`` under the same
    plan and policy: ``{pkg: (outcome, step-failed records, fired)}``."""
    jcfg, cfg = _configs(inflight, superstep, fault_plan=plan,
                         failure_policy=policy, **(jax_config or {}))
    plans = {"jax": [], "port": []}
    for name, mod in (("jax", jfaults), ("port", faults)):
        real = mod.FaultPlan.resolve.__func__

        def resolve(cls, spec, _real=real, _name=name):
            got = _real(cls, spec)
            if got is not None:
                plans[_name].append(got)
            return got

        monkeypatch.setattr(mod.FaultPlan, "resolve", classmethod(resolve))
    kw = {}
    out = {}
    for name in ("jax", "port"):
        if ck_dir is not None:
            kw = {"checkpoint_path": str(ck_dir / f"{name}.npz"),
                  "checkpoint_every": checkpoint_every}
        if name == "jax":
            fn = lambda: jexecutor.run_job(  # noqa: E731
                jwc.WordCountJob(jcfg), path, jcfg, mesh=data_mesh(1),
                retry=retry, **kw)
        else:
            fn = lambda: executor.run_job(  # noqa: E731
                wc.WordCountJob(cfg, "cpu"), path, cfg, retry=retry, **kw)
        res, failed = _outcome(fn, "mapreduce_tpu" if name == "jax"
                               else LOGGER_NAME)
        fired = [(f["seam"], f["index"], f["fault_class"])
                 for p in plans[name] for f in p.fired]
        out[name] = (res, failed, fired)
    return out


def _table(rr) -> dict:
    v = rr.value
    if isinstance(v, table_ops.CountTable):
        return convert.table_to_numpy(v)
    return {f: np.asarray(getattr(v, f)).astype(np.uint32).reshape(-1)
            for f in v._fields}


def _assert_same_success(out, path, want):
    (jrr, jfail, jfired), (prr, pfail, pfired) = out["jax"], out["port"]
    assert not isinstance(jrr, BaseException), jrr
    assert not isinstance(prr, BaseException), prr
    assert pfired == jfired
    assert pfail == jfail == []
    jt, pt = _table(jrr), _table(prr)
    for f in jt:
        np.testing.assert_array_equal(pt[f], jt[f], err_msg=f)
    np.testing.assert_array_equal(prr.bases, jrr.bases)
    assert prr.pipeline.get("degrade_steps") \
        == jrr.pipeline.get("degrade_steps")
    got = executor.recover_from_file(prr.value, path, prr.bases)
    assert got.as_dict() == want
    assert list(got.words) == list(want)


def _assert_same_failure(out):
    (je, jfail, jfired), (pe, pfail, pfired) = out["jax"], out["port"]
    assert isinstance(je, BaseException) and isinstance(pe, BaseException)
    assert (type(pe).__name__, str(pe)) == (type(je).__name__, str(je))
    assert pfired == jfired
    assert pfail == jfail and len(pfail) == 1
    return pe


_SEAM_INDEX = {"checkpoint-save": 0, "collective-finish": 0}


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
@pytest.mark.parametrize("seam", CROSSED)
def test_transient_fault_at_each_seam(monkeypatch, tmp_path, corpus, seam,
                                      inflight, superstep):
    path, want = corpus
    out = _run_both(path, monkeypatch, inflight, superstep,
                    plan=f"at={seam}:{_SEAM_INDEX.get(seam, 1)}:transient",
                    retry=2, ck_dir=tmp_path, checkpoint_every=2)
    _assert_same_success(out, path, want)
    assert out["port"][2] == [(seam, _SEAM_INDEX.get(seam, 1), "transient")]
    _assert_same_snapshot(tmp_path)


def _assert_same_snapshot(tmp_path):
    j = ckpt.load(str(tmp_path / "jax.npz"))
    p = ckpt.load(str(tmp_path / "port.npz"))
    assert p[1:3] == j[1:3] and p[4] == j[4]
    np.testing.assert_array_equal(p[3], j[3])
    for a, b in zip(p[0], j[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_process_kill_lands_between_groups(monkeypatch, tmp_path, corpus,
                                           inflight, superstep):
    """The hard kill, with ``os._exit`` replaced by an exception, lands
    after the same group in both packages: the snapshots left behind are
    equal."""
    def kill(code):
        raise _Killed(code)

    monkeypatch.setattr(os, "_exit", kill)
    path, _ = corpus
    out = _run_both(path, monkeypatch, inflight, superstep,
                    plan="at=process-kill:2:transient", retry=2,
                    ck_dir=tmp_path, checkpoint_every=1)
    for name in ("jax", "port"):
        assert isinstance(out[name][0], _Killed)
    assert out["port"][2] == out["jax"][2] == [
        ("process-kill", 2, "transient")]
    _assert_same_snapshot(tmp_path)
    assert ckpt.load(str(tmp_path / "port.npz"))[1] == 2


def test_process_kill_exits_113_and_resumes(tmp_path, corpus):
    """The real kill: the process exits 113 between groups, after the
    snapshot of the previous one; a relaunch resumes exactly."""
    path, want = corpus
    ck = str(tmp_path / "ck.npz")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from mapreduce_tpu_torch.runtime.executor import count_file; "
            "from mapreduce_tpu_torch import Config; "
            "cfg = Config(chunk_bytes=4096, table_capacity=2048, "
            "pallas_max_token=8, rescue_overlong=4, backend='pallas', "
            "fault_plan='at=process-kill:2:transient'); "
            "count_file(sys.argv[2], cfg, device='cpu', "
            "checkpoint_path=sys.argv[3], checkpoint_every=1)")
    proc = subprocess.run([sys.executable, "-c", code, str(REPO), path, ck],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 113, proc.stderr
    _, step, *_ = ckpt.load(ck)
    assert step == 2  # groups 0 and 1 saved; killed after group 2
    _, cfg = _configs(4, 1)
    got = executor.count_file(path, cfg, device="cpu", checkpoint_path=ck)
    assert got.as_dict() == want and list(got.words) == list(want)


RANDOM = ("seed=5,rate=0.2,seams=" + "+".join(CROSSED)
          + ",classes=transient+resource,max=6")


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_random_plan(monkeypatch, tmp_path, corpus, inflight, superstep):
    path, want = corpus
    out = _run_both(path, monkeypatch, inflight, superstep, plan=RANDOM,
                    retry=3, ck_dir=tmp_path, checkpoint_every=2)
    _assert_same_success(out, path, want)
    assert len(out["port"][2]) >= 3, out["port"][2]


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_permanent_fault_fails_at_once(monkeypatch, corpus, inflight,
                                       superstep):
    path, _ = corpus
    with _logs(LOGGER_NAME) as records:
        out = _run_both(path, monkeypatch, inflight, superstep,
                        plan="at=dispatch:1:permanent", retry=3)
    e = _assert_same_failure(out)
    assert isinstance(e, faults.PermanentFault)
    assert out["port"][1][0][2] == "permanent"
    assert not [m for m, _ in records if m == "step failed; retrying"]


def _storm(monkeypatch, until=None):
    """Every step raises a resource error while ``until(config)`` is false
    (always, with ``until`` None), in both packages' engines (the JAX
    engine runs a superstep group as one ``step_many``)."""
    for cls, name in ((jmr.Engine, "step"), (jmr.Engine, "step_many"),
                      (pmr.Engine, "step")):
        real = getattr(cls, name)

        def storming(self, state, chunk, step_index, *a, _real=real):
            if until is None or not until(self.job.config):
                raise RuntimeError("RESOURCE_EXHAUSTED: injected storm")
            return _real(self, state, chunk, step_index, *a)

        monkeypatch.setattr(cls, name, storming)


LADDER_POLICY = {"resource_retries": 1, "transient_retries": 1,
                 "degrade": True, **NO_BACKOFF}


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_resource_storm_walks_the_ladder(monkeypatch, corpus, inflight,
                                         superstep):
    """From the fused map with the hot-key combiner and the radix sort, a
    storm that clears only under the torch sort walks every rung."""
    path, want = corpus
    _storm(monkeypatch, until=lambda c: c.sort_impl == "xla")
    out = _run_both(path, monkeypatch, inflight, superstep,
                    policy=LADDER_POLICY,
                    jax_config={"map_impl": "fused", "combiner": "hot-cache",
                                "combiner_slots": 8, "sort_impl": "radix"})
    _assert_same_success(out, path, want)
    assert out["port"][0].pipeline["degrade_steps"] \
        == ["combiner-off", "map-split", "sort-xla"]


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_exhausted_ladder_fails_with_resource_class(monkeypatch, corpus,
                                                    inflight, superstep):
    path, _ = corpus
    _storm(monkeypatch)
    with _logs(LOGGER_NAME) as records:
        out = _run_both(path, monkeypatch, inflight, superstep,
                        policy=LADDER_POLICY)
    _assert_same_failure(out)
    assert out["port"][1][0][2] == "resource"
    assert not [m for m, _ in records if m == "degradation ladder step"]


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_token_timeout_replays(monkeypatch, corpus, inflight, superstep):
    """The first completion wait hangs past ``token_timeout_s``: a typed
    TokenTimeout, a replay from the anchor, and the exact result."""
    path, want = corpus
    hung = {}

    def slow_jax_wait(token, _real=jexecutor._wait_token):
        if "jax" not in hung:
            hung["jax"] = True
            time.sleep(1.0)
        return _real(token)

    def slow_ready(token):
        if token is None:  # an H2D copy event (the CPU has none)
            return True
        t0 = hung.setdefault("port", (token, time.monotonic()))
        return token is not t0[0] or time.monotonic() - t0[1] >= 1.0

    monkeypatch.setattr(jexecutor, "_wait_token", slow_jax_wait)
    monkeypatch.setattr(executor._HostStage, "ready",
                        staticmethod(slow_ready))
    policy = {"transient_retries": 2, "token_timeout_s": 0.2, **NO_BACKOFF}
    with _logs(LOGGER_NAME) as precs, _logs("mapreduce_tpu") as jrecs:
        out = _run_both(path, monkeypatch, inflight, superstep,
                        policy=policy)
    _assert_same_success(out, path, want)
    assert set(hung) == {"jax", "port"}

    def retries(records):
        return [(f["step"], f["attempt"], f["fault_class"])
                for m, f in records if m == "step failed; retrying"]

    assert retries(precs) == retries(jrecs) and len(retries(precs)) == 1
    assert out["port"][0].pipeline["recoveries"] == 1


def _preempted(out):
    (je, _, jfired), (pe, _, pfired) = out["jax"], out["port"]
    assert isinstance(je, jfaults.Preempted), je
    assert isinstance(pe, faults.Preempted), pe
    assert (pe.step, pe.cursor_bytes, pe.checkpointed) \
        == (je.step, je.cursor_bytes, je.checkpointed)
    assert pfired == jfired
    return pe


def _resume_exact(tmp_path, path, want, inflight, superstep):
    jcfg, cfg = _configs(inflight, superstep)
    got = executor.count_file(path, cfg, device="cpu",
                              checkpoint_path=str(tmp_path / "port.npz"),
                              checkpoint_every=50)
    assert got.as_dict() == want and list(got.words) == list(want)
    jgot = jexecutor.count_file(path, jcfg, mesh=data_mesh(1),
                                checkpoint_path=str(tmp_path / "jax.npz"),
                                checkpoint_every=50)
    assert jgot.as_dict() == want


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
@pytest.mark.parametrize("plan", ["at=dispatch:2:preemption",
                                  "at=token-wait:0:preemption"])
def test_injected_preemption_drains_checkpoints_and_resumes(
        monkeypatch, tmp_path, corpus, plan, inflight, superstep):
    path, want = corpus
    out = _run_both(path, monkeypatch, inflight, superstep, plan=plan,
                    retry=1, ck_dir=tmp_path, checkpoint_every=50)
    pe = _preempted(out)
    assert pe.checkpointed and 0 < pe.cursor_bytes
    _resume_exact(tmp_path, path, want, inflight, superstep)


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_keyboard_interrupt_is_a_preemption(monkeypatch, tmp_path, corpus,
                                            inflight, superstep):
    """A real ``KeyboardInterrupt`` in a step takes the same drain,
    checkpoint and exit in both packages."""
    path, want = corpus
    fired = []
    for mod in (jmr, pmr):
        real = mod.Engine.step

        def interrupted(self, state, chunk, step_index, _real=real,
                        _mod=mod):
            if int(step_index) == 3 and _mod not in fired:
                fired.append(_mod)
                raise KeyboardInterrupt
            return _real(self, state, chunk, step_index)

        monkeypatch.setattr(mod.Engine, "step", interrupted)
    out = _run_both(path, monkeypatch, inflight, superstep, retry=1,
                    ck_dir=tmp_path, checkpoint_every=50)
    assert len(fired) == 2
    pe = _preempted(out)
    assert pe.checkpointed and pe.step == 3
    _resume_exact(tmp_path, path, want, inflight, superstep)


def test_interrupt_in_the_readers_next_is_a_preemption(monkeypatch,
                                                       tmp_path, corpus):
    """A ``KeyboardInterrupt`` that reaches the loop through the reader's
    next drains and checkpoints; the reader thread is stopped."""
    path, want = corpus
    real = reader_mod.iter_batches_multi

    def interrupted(*args, **kw):
        for b in real(*args, **kw):
            if b.step == 3:
                raise KeyboardInterrupt
            yield b

    monkeypatch.setattr(reader_mod, "iter_batches_multi", interrupted)
    _, cfg = _configs(4, 1)
    ck = str(tmp_path / "port.npz")
    before = set(threading.enumerate())
    with pytest.raises(faults.Preempted) as ei:
        executor.count_file(path, cfg, device="cpu", checkpoint_path=ck,
                            checkpoint_every=50, retry=1)
    assert (ei.value.step, ei.value.checkpointed) == (3, True)
    assert not [t for t in set(threading.enumerate()) - before
                if t.name == "ingest-prefetch"]
    monkeypatch.undo()
    got = executor.count_file(path, cfg, device="cpu", checkpoint_path=ck)
    assert got.as_dict() == want


def test_sticky_cuda_error_fails_without_a_retry(monkeypatch, corpus):
    path, _ = corpus
    real = pmr.Engine.step

    def poisoned(self, state, chunk, step_index):
        if step_index >= 1:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return real(self, state, chunk, step_index)

    monkeypatch.setattr(pmr.Engine, "step", poisoned)
    _, cfg = _configs(4, 1)
    with _logs(LOGGER_NAME) as records, \
            pytest.raises(RuntimeError, match="illegal memory access"):
        executor.count_file(path, cfg, device="cpu", retry=3)
    assert [f["fault_class"] for m, f in records if m == "step failed"] \
        == ["permanent"]
    assert not [m for m, _ in records if m == "step failed; retrying"]


@pytest.mark.parametrize("kw", [
    {},
    {"map_impl": "fused", "combiner": "hot-cache", "sort_impl": "radix"},
])
def test_anchor_is_unchanged_by_a_step(corpus, kw):
    """The replay anchor holds the state's tensors by reference: a step
    must never write into its input state."""
    path, _ = corpus
    cfg = dataclasses.replace(_configs(4, 1)[1], **kw)
    eng = pmr.Engine(wc.WordCountJob(cfg, "cpu"), "cpu")
    data = np.frombuffer(pathlib.Path(path).read_bytes(), np.uint8)
    chunks = [data[i:i + CHUNK] for i in range(0, 3 * CHUNK, CHUNK)]
    state = eng.init_states()
    for i, c in enumerate(chunks[:2]):
        state = eng.step(state, torch.from_numpy(
            np.pad(c, (0, CHUNK - c.shape[0]))), i)
    anchor = state
    before = [t.clone() for t in anchor]
    after = eng.step(anchor, torch.from_numpy(chunks[2].copy()), 2)
    for f, a, b in zip(anchor._fields, anchor, before):
        assert torch.equal(a, b), f
    assert after.total_count() > anchor.total_count()


def test_sigint_to_the_cli_exits_75_and_resumes_exactly(tmp_path):
    """A real SIGINT to a streamed CLI run once its first snapshot landed:
    the run drains, saves the state that matches its cursor and exits 75;
    the relaunch prints what an uninterrupted run prints."""
    import io
    import signal

    from mapreduce_tpu_torch import cli

    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(_text(11, 40000))  # ~33 chunks
    flags = [str(corpus), "--platform", "cpu", "--stream", "--chunk-bytes",
             str(CHUNK), "--table-capacity", "4096", "--format", "json",
             "--no-echo"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(flags) == 0
    want = buf.getvalue().encode()
    ck = str(tmp_path / "ck.npz")
    cmd = [sys.executable, "-m", "mapreduce_tpu_torch", *flags,
           "--checkpoint", ck, "--checkpoint-every", "2"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    child = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while child.poll() is None and time.monotonic() < deadline:
            if os.path.exists(ckpt.integrity_path(ck)):
                child.send_signal(signal.SIGINT)
                break
            time.sleep(0.001)
        out, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 75, err.decode()[-2000:]
    assert out == b"" and b"\npreempted: preempted at step " in b"\n" + err
    _, step, *_ = ckpt.load(ck)
    relaunch = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              timeout=60)
    assert relaunch.returncode == 0, relaunch.stderr.decode()[-2000:]
    assert b"resumed from checkpoint" in relaunch.stderr
    assert relaunch.stdout == want


def test_preemption_during_a_replay_keeps_the_last_snapshot(monkeypatch,
                                                            tmp_path,
                                                            corpus):
    """A preemption that lands inside a replay exits without a snapshot:
    the replayed state is not the one the cursor counts, and the last
    snapshot on disk still resumes exactly."""
    path, want = corpus
    # The drain at the step-4 checkpoint: the wait on group 3 fails, and
    # the replay of groups 2 and 3 is preempted at group 3's dispatch.
    _, cfg = _configs(4, 1, fault_plan="at=token-wait:3:transient,"
                                       "at=dispatch:5:preemption")
    ck = str(tmp_path / "port.npz")
    with _logs(LOGGER_NAME) as records, \
            pytest.raises(faults.Preempted) as ei:
        executor.count_file(path, cfg, device="cpu", retry=2,
                            checkpoint_path=ck, checkpoint_every=2)
    assert not ei.value.checkpointed
    assert "preempted during a replay; exiting without checkpoint" \
        in [m for m, _ in records]
    _, step, *_ = ckpt.load(ck)
    assert step == 2
    got = executor.count_file(path, _configs(4, 1)[1], device="cpu",
                              checkpoint_path=ck)
    assert got.as_dict() == want and list(got.words) == list(want)


def test_a_kernel_that_never_finishes_ends_the_run(monkeypatch, corpus):
    """Every completion after the first never comes: each wait times out,
    the replays spend the budget, and the run ends with a TokenTimeout
    instead of stalling."""
    path, _ = corpus
    seen = []

    def hung(token):
        if token is not None:
            seen.append(token)
        return token is None or token is seen[0]

    monkeypatch.setattr(executor._HostStage, "ready", staticmethod(hung))
    _, cfg = _configs(4, 1, failure_policy={
        "transient_retries": 2, "token_timeout_s": 0.05, **NO_BACKOFF})
    t0 = time.monotonic()
    with _logs(LOGGER_NAME) as records, \
            pytest.raises(faults.TokenTimeout):
        executor.count_file(path, cfg, device="cpu")
    assert time.monotonic() - t0 < 5
    # Group 1's wait times out (one attempt charged); the replay of group
    # 0 hangs twice more and spends the budget of 2.
    assert [(f["step"], f["attempt"]) for m, f in records
            if m == "step failed; retrying"] == [(1, 1), (0, 1), (0, 2)]
    assert [f["fault_class"] for m, f in records if m == "step failed"] \
        == ["transient"]


@pytest.mark.parametrize("timeout", [None, 0.5])
def test_the_maps_host_read_goes_through_the_stage_under_a_timeout(
        monkeypatch, corpus, timeout):
    """Under ``token_timeout_s`` the map's one host read of each chunk is
    the stage's bounded read (on the card a copy behind an event, polled
    against the deadline); without one it is the blocking read of PR 5.
    The read is the driver's only while the stream runs."""
    path, want = corpus
    reads = []
    real = executor._HostStage.read

    def read(flags, timeout_s):
        reads.append(timeout_s)
        return real(flags, timeout_s)

    monkeypatch.setattr(executor._HostStage, "read", staticmethod(read))
    _, cfg = _configs(4, 1, failure_policy={"transient_retries": 1,
                                            "token_timeout_s": timeout})
    got = executor.count_file(path, cfg, device="cpu")
    assert got.as_dict() == want
    assert reads == ([] if timeout is None else [timeout] * 5)
    assert tracepoints._HOST_READ.get() is None


def test_a_second_sigint_during_the_preemption_drain_keeps_preempted(
        monkeypatch, tmp_path, corpus):
    """A SIGINT that arrives while a preempted run drains and saves its
    snapshot is absorbed: the run still leaves with ``Preempted`` (the
    CLI's exit 75), not with a ``KeyboardInterrupt``."""
    import signal

    path, want = corpus
    # The deferral itself: a SIGINT recorded while Preempted propagates is
    # not delivered again.
    with pytest.raises(faults.Preempted):
        with executor._sigint_deferred() as pending:
            pending.append(signal.SIGINT)
            raise faults.Preempted(step=1, cursor_bytes=2,
                                   checkpoint_path=None, checkpointed=False)
    # Through the driver: the snapshot save of the preemption is
    # interrupted by a real SIGINT (where the driver defers them: the main
    # thread, over Python's default handler).
    real_save = ckpt.save
    outside = signal.getsignal(signal.SIGINT)
    sent = []

    def save(*args, **kw):
        if signal.getsignal(signal.SIGINT) is not outside:  # deferred
            sent.append(True)
            signal.raise_signal(signal.SIGINT)
        return real_save(*args, **kw)

    monkeypatch.setattr(ckpt, "save", save)
    _, cfg = _configs(4, 1, fault_plan="at=token-wait:2:preemption")
    ck = str(tmp_path / "port.npz")
    with pytest.raises(faults.Preempted) as ei:
        executor.count_file(path, cfg, device="cpu", retry=1,
                            checkpoint_path=ck, checkpoint_every=50)
    assert ei.value.checkpointed
    assert sent == ([True] if threading.current_thread()
                    is threading.main_thread()
                    and outside is signal.default_int_handler else [])
    monkeypatch.undo()
    got = executor.count_file(path, _configs(4, 1)[1], device="cpu",
                              checkpoint_path=ck)
    assert got.as_dict() == want and list(got.words) == list(want)
