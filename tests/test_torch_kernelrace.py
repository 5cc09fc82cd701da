"""The kernel-race certificate (``analysis/passes/kernelrace.py``) over the
port's CUDA sources, on the CPU.

Every ``__global__`` function of ``csrc/*.cu`` is held to its declared
cross-block protocol (``ops/cuda/plans.py:PROTOCOLS``): the shipped
sources certify clean, and doctored copies of one kernel fail it the way
the JAX pass's known-bad fixtures fail the JAX pass: a blind write to a
target every block shares (a plain store its protocol does not give one
block), a store outside the declaration, status words the launcher no
longer clears, a poll loop without its bound, a buffer read before its
first write.  The copies are edited text; the sources on
disk are never touched.  The dynamic half (each kernel's probe eight
times, half of them beside a concurrent kernel) runs on the card in
``chip_smoke.py`` phase 15.
"""

import os
import re

import pytest
import torch

from mapreduce_tpu_torch import analysis
from mapreduce_tpu_torch import models as models_mod
from mapreduce_tpu_torch.analysis import core
from mapreduce_tpu_torch.analysis.passes import kernelrace
from mapreduce_tpu_torch.ops.cuda import plans

CPU = torch.device("cpu")
TOKENIZE = os.path.join(kernelrace.CSRC, "tokenize.cu")
RADIX = os.path.join(kernelrace.CSRC, "radix.cu")


def _text(path):
    with open(path) as f:
        return f.read()


def test_shipped_sources_certify_clean():
    cert = kernelrace.certificate()
    assert set(cert) == set(plans.PROTOCOLS) == set(plans.KERNELS)
    assert {k: v for k, v in cert.items() if v} == {}
    found = kernelrace.certify_sources()
    assert [f.severity for f in found] == ["info"] * len(cert)
    assert all(f.model == "<kernels>" for f in found)


def test_every_declared_buffer_is_written_and_every_spec_line_holds_it():
    for path in (TOKENIZE, RADIX):
        functions = kernelrace.parse(_text(path))
        lines = _text(path).splitlines()
        for name, fn in functions.items():
            if fn.kind != "global":
                continue
            written = {s.buffer for s in kernelrace.stores(fn, functions)}
            assert written == {b for b, _ in plans.PROTOCOLS[name].buffers}
            src, line = plans.KERNELS[name].source.rsplit(":", 1)
            assert lines[int(line) - 1].startswith("__global__")
            assert re.match(rf"\s*{name}\s*\(", lines[int(line)])


DOCTORED = {
    # combiner_stream's spill counter as a plain store from every window
    # (its protocol gives one block only counters[3], the live count).
    "blind_shared_store": (
        TOKENIZE, "combiner_stream",
        "atomicAdd(&counters[2], static_cast<unsigned long long>(kept - slots));",
        "counters[2] = static_cast<unsigned long long>(kept - slots);",
        "error", "blind write"),
    # tokenize_stream takes its tile with a plain read-and-store.
    "blind_ticket": (
        TOKENIZE, "tokenize_stream",
        "sh_tile = static_cast<int>(atomicAdd(ticket, 1u));",
        "sh_tile = static_cast<int>(*ticket); *ticket = sh_tile + 1;",
        "error", "ticket"),
    # combiner_fold_keys writes a buffer it does not declare (the table it
    # reads; the edited text is scanned, never compiled).
    "undeclared_store": (
        TOKENIZE, "combiner_fold_keys",
        "    counters[2] = live;",
        "    counters[2] = live; t_khi[0] = 0;",
        "error", "outside its declaration"),
    # the combiner launcher no longer clears its ticket and status words.
    "status_not_cleared": (
        TOKENIZE, "combiner_stream",
        "  cudaError_t e = cudaMemsetAsync(work, 0, 8 * work_words, s);",
        "  cudaError_t e = cudaSuccess; /* no clear */",
        "error", "does not clear"),
    # the radix scatter's look-back loses its bound.
    "unbounded_poll": (
        RADIX, "sort_scatter",
        "            if (++polls > kMaxPolls) __trap();",
        "            (void)polls;",
        "error", "not bounded"),
    # the combiner's wait for its segment's list loses its bound.
    "unbounded_list_poll": (
        TOKENIZE, "combiner_stream",
        "          if (v) break;\n          if (++polls > kMaxPolls) __trap();",
        "          if (v) break;\n          (void)polls;",
        "error", "not bounded"),
    # combiner_stream reads a cache plane before it writes it.
    "read_before_write": (
        TOKENIZE, "combiner_stream",
        "  const int seg = wg / windows, win = wg % windows;",
        "  const int seg = wg / windows + 0 * static_cast<int>(c_pk[0]), "
        "win = wg % windows;",
        "warning", "before it first writes"),
}


@pytest.mark.parametrize("case", list(DOCTORED))
def test_doctored_kernel_fails(case):
    path, kernel, old, new, severity, phrase = DOCTORED[case]
    text = _text(path)
    assert text.count(old) == 1, case
    cert = kernelrace.certify_source(path, text.replace(old, new))
    issues = [i for i in cert[kernel] if phrase in i.message]
    assert issues, cert[kernel]
    assert issues[0].severity == severity
    assert issues[0].location.startswith("mapreduce_tpu_torch/csrc/")
    others = {k: v for k, v in cert.items() if v and k != kernel}
    assert not others, others


def test_a_kernel_without_a_protocol_is_an_error():
    protocols = dict(plans.PROTOCOLS)
    del protocols["combiner_stream"]
    cert = kernelrace.certify_source(TOKENIZE, protocols=protocols)
    assert [i.message for i in cert["combiner_stream"]] \
        == ["no declared cross-block protocol"]
    found = kernelrace.certify_sources({**kernelrace.certificate(),
                                        "combiner_stream": cert[
                                            "combiner_stream"]})
    assert [f.severity for f in found
            if f.message.startswith("combiner_stream")] == ["error"]


def test_pass_certifies_the_kernels_a_model_launches():
    job = models_mod.build_model("wordcount_combiner", device=CPU)
    report = analysis.analyze_job(job, "wordcount_combiner", device=CPU,
                                  passes=[kernelrace.KernelRacePass()])
    assert [f.severity for f in report.findings] == ["info"] * 3
    assert [f.message.split(":")[0] for f in report.findings] == [
        "combiner_stream", "combiner_fold_keys", "combiner_fold_merge"]
    xla = analysis.analyze_job(models_mod.build_model("wordcount", device=CPU),
                               "wordcount", device=CPU,
                               passes=[kernelrace.KernelRacePass()])
    assert xla.findings == []


def test_cli_certifies_the_sources_once(capsys):
    from mapreduce_tpu_torch.analysis import cli as acli

    assert acli.main(["grep", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("kernel-race <kernels>.sources") == len(plans.PROTOCOLS)
    assert core.ERROR.upper() not in out.split("graphcheck: analyzed")[1]
