"""The port's grep family against the JAX package's, on the CPU.

The same seeded buffers go through both packages and every field is
compared exactly as uint32: the match masks, the row summaries (matches,
segments with a match, has-newline, first and last segment matched) and
the whole-buffer counts for literal and class patterns, patterns with
newlines, a pattern longer than the data and one of 256 bytes; the 64-bit
carry; the error messages and job identities; streamed ``grep_file`` and
``grep_file_multi`` over a 3-file corpus at 4 KB chunks, superstep 2 and
window 2 against the JAX executor on one device and a Python ``re``
oracle; a pattern with a space over a separator-free run longer than a
chunk at several chunk sizes (the chunk-join envelope, which equals the
JAX package's only if both cut the corpus at the same places); and the
bare ``map_chunk`` sequence.  Tolerance zero: this is integer counting.
"""

import collections
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import grep as jgrep
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import grep
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.parallel import mapreduce as mr
from mapreduce_tpu_torch.runtime import executor

LITERALS = [b"a", b"ab", b"\n", b"\na", b"a\n", b"b\nx", b"a a", b"x" * 40]
CLASSES = [b"[ab]", b"a.b", b"[^ \n]x", rb"\.[a-c]", b"[a-b][\n ]"]


def _buf(seed: int, n: int, alphabet: bytes = b"ab\n x.\t") -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    data = alpha[rng.integers(0, len(alpha), n)]
    data[n - int(rng.integers(1, 24)):] = 0  # a NUL-padded tail
    return data


def _both(spec: bytes, syntax: str):
    return jgrep.compile_pattern(spec, syntax), \
        grep.compile_pattern(spec, syntax)


@pytest.mark.parametrize("syntax,spec", [("literal", p) for p in LITERALS]
                         + [("class", p) for p in CLASSES])
def test_match_mask_and_chunk_counts_equal_jax(syntax, spec):
    """The match mask and ``count_matches_in_chunk`` on three buffers."""
    jp, pp = _both(spec, syntax)
    for seed, n in ((0, 128), (1, 384), (2, 1024)):
        data = _buf(seed, n)
        want = np.asarray(jgrep._match_mask(jnp.asarray(data), jp))
        got = grep._match_mask(torch.from_numpy(data), pp).numpy()
        np.testing.assert_array_equal(got, want)
        w = jgrep.count_matches_in_chunk(jnp.asarray(data), jp)
        g = grep.count_matches_in_chunk(torch.from_numpy(data), pp)
        for f in jgrep.GrepState._fields:
            assert int(getattr(g, f)) == int(np.asarray(getattr(w, f))), f


@pytest.mark.parametrize("seed", range(4))
def test_row_summary_multi_equals_jax(seed):
    """All patterns in one pass, ``[P]`` summaries, field by field; one
    buffer with no newline and one with no match among them."""
    specs = LITERALS + [b"zz"]
    jps = [jgrep.compile_pattern(p) for p in specs]
    pps = [grep.compile_pattern(p) for p in specs]
    alphabet = b"ab x" if seed == 3 else b"ab\n x.\t"
    data = _buf(seed + 10, 128 * (seed + 1), alphabet)
    want = jgrep._row_summary_multi(jnp.asarray(data), jps)
    got = grep._row_summary_multi(torch.from_numpy(data), pps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
    wstate = jgrep._whole_buffer_state(jnp.asarray(data), jps)
    gstate = grep._whole_buffer_state(torch.from_numpy(data), pps)
    for w, g in zip(wstate, gstate):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


def test_long_and_oversized_patterns():
    """A pattern longer than the data matches nothing; a 256-byte one
    matches where JAX says; 257 bytes and a NUL are refused."""
    data = b"hi\n"
    assert grep.grep_bytes(data, b"this-pattern-is-longer-than-the-data",
                           device="cpu")[1:] == (0, 0)
    pat = bytes(b"ab"[i % 2] for i in range(256))
    corpus = b"x " + pat + b"ab\n" + pat[:200] + b"\n" + pat + b"\n"
    want = jgrep.grep_bytes(corpus, pat)
    assert grep.grep_bytes(corpus, pat, device="cpu") == want
    assert want.matches == 3 and want.lines == 2


@pytest.mark.parametrize("bad,syntax", [
    (b"", "literal"), (b"a" * 257, "literal"), (b"a\x00", "literal"),
    (b"[abc", "class"), (b"[]x", "class"), (b"a\\", "class"),
    (b"[z-a]", "class"), (b"[\x00-\x05]", "class"), (b".", "regex"),
    (b"." * 257, "class")])
def test_refusals_equal_jax(bad, syntax):
    with pytest.raises(ValueError) as want:
        jgrep.GrepJob(bad, syntax)
    with pytest.raises(ValueError) as got:
        grep.GrepJob(bad, syntax, device="cpu")
    assert str(got.value) == str(want.value)


def test_identities_equal_jax():
    cases = [([b"the"], "literal"), ([b"w.x"], "class"),
             ([b"w.x"], "literal"),
             ([b"a", b"b\n", b"[0-9]"], "literal"),
             ([b"[a-c]x", b"y", b"z", b"q"], "class")]
    for pats, syntax in cases:
        if len(pats) == 1:
            want = jgrep.GrepJob(pats[0], syntax).identity()
            got = grep.GrepJob(pats[0], syntax, device="cpu").identity()
        else:
            want = jgrep.MultiGrepJob(pats, syntax).identity()
            got = grep.MultiGrepJob(pats, syntax, device="cpu").identity()
        assert got == want
    assert grep.GrepJob(b"w.x", device="cpu").identity() \
        != grep.GrepJob(b"w.x", "class", device="cpu").identity()


def test_64bit_carry_accumulation():
    """A count past 2**32 carries into the high word, in merge and in
    combine (a one-byte pattern on a large corpus gets there)."""
    job = grep.GrepJob(b"x", device="cpu")
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    near = grep.GrepState(t(0xFFFFFFF0), t(0), t(0xFFFFFFF0), t(0), t(0))
    other = grep.GrepState(t(0x20), t(0), t(0x20), t(0), t(0))
    merged = job.merge(near, other)
    assert grep._state_result(b"x", merged)[1:] == (0xFFFFFFF0 + 0x20,) * 2
    jnear = jgrep.GrepState(*(jnp.uint32(int(v)) for v in near))
    jother = jgrep.GrepState(*(jnp.uint32(int(v)) for v in other))
    want = jgrep.GrepJob(b"x").merge(jnear, jother)
    for w, g in zip(want, merged):
        assert int(g) == int(np.asarray(w))
    upd = job.map_chunk(torch.from_numpy(np.frombuffer(b"x x\nx " * 32,
                                                       np.uint8).copy()), 0)
    combined = job.combine(near, upd)
    jupd = jgrep.GrepJob(b"x").map_chunk(
        jnp.asarray(np.frombuffer(b"x x\nx " * 32, np.uint8)), 0)
    for w, g in zip(jgrep.GrepJob(b"x").combine(jnear, jupd), combined):
        assert int(g) == int(np.asarray(w))
    assert int(combined.matches_hi) == 1


def test_combine_leaves_its_inputs_alone():
    """The replay's anchor holds the state by reference: a combine must
    not write into it."""
    job = grep.MultiGrepJob([b"a", b"b"], device="cpu")
    state = job.init_state()
    before = [x.clone() for x in state]
    upd = job.map_chunk_sharded(torch.from_numpy(_buf(3, 256)), 0)
    job.combine(job.combine(state, upd), upd)
    job.on_input_boundary(state)
    for b, x in zip(before, state):
        assert torch.equal(b, x)


def _rows(corpus: bytes, row_bytes: int):
    """Rows cut at separators, as the reader cuts them, each padded."""
    off = 0
    while off < len(corpus):
        hi = min(off + row_bytes, len(corpus))
        if hi < len(corpus):
            while hi > off and corpus[hi - 1] not in b" \n\t\r":
                hi -= 1
        row = np.frombuffer(corpus[off:hi], dtype=np.uint8)
        off = hi
        yield tok_ops.pad_to(row, max(128, -(-row.shape[0] // 128) * 128))


def occurrences(data: bytes, pat: bytes) -> int:
    return sum(1 for i in range(len(data) - len(pat) + 1)
               if data[i: i + len(pat)] == pat)


def matching_lines(data: bytes, pat: bytes) -> int:
    return sum(1 for line in data.split(b"\n") if pat in line)


@pytest.mark.parametrize("multi", [False, True])
def test_bare_map_chunk_sequence_exact_lines(multi):
    """Rows driven by hand through ``map_chunk`` + ``combine`` (no step
    axis): exact lines for lines spanning rows, as in the JAX package."""
    corpus = (b"MATCH " + b"x " * 100 + b"MATCH\n" + b"plain\n"
              + b"a " * 60 + b"MATCH " + b"b " * 90 + b"\nAB " + b"q " * 200
              + b"CD\nAB CD\n")
    pats = [b"MATCH", b"AB", b"CD", b"zz"] if multi else [b"MATCH"]
    job = grep.MultiGrepJob(pats, device="cpu") if multi \
        else grep.GrepJob(pats[0], device="cpu")
    for row_bytes in (128, 256):
        state = job.init_state()
        for row in _rows(corpus, row_bytes):
            state = job.combine(state, job.map_chunk(torch.from_numpy(row),
                                                     0))
        got = grep._multi_results(pats, state) if multi \
            else [grep._state_result(pats[0], state)]
        for r, p in zip(got, pats):
            assert (r.matches, r.lines) == (occurrences(corpus, p),
                                            matching_lines(corpus, p)), p


def test_one_card_sharded_map_equals_the_single_row_update():
    """On one card the streamed map's seam correction over the step's
    gathered summaries (a leading axis of 1) is the single-row transfer;
    with more rows it is the JAX package's prefix composition."""
    pats = [b"a", b"\n", b"b\nx"]
    job = grep.MultiGrepJob(pats, device="cpu")
    for seed in range(6):
        chunk = torch.from_numpy(_buf(seed + 20, 256))
        one = job.map_chunk_sharded(chunk, seed)
        single = job.map_chunk(chunk, seed)
        for a, b in zip(one, single):
            assert torch.equal(a, b)
    # Three rows of one step, corrected per device, against the JAX
    # formula run on the same gathered block.
    summ = [grep._row_summary_multi(torch.from_numpy(_buf(s, 256)), [
        grep.compile_pattern(p) for p in pats]) for s in (30, 31, 32)]
    gathered = torch.stack([torch.stack([s[2], s[3], s[4]]) for s in summ])
    for d in range(3):
        got = grep._seam_corrected_update(*summ[d], gathered, d)
        g_all = jnp.asarray(gathered.numpy().astype(np.uint32))
        a_row = jnp.where(g_all[:, 0] > 0, g_all[:, 2], g_all[:, 1])
        b_row = (g_all[:, 0] == 0).astype(jnp.uint32)
        a_incl, b_incl = jax.lax.associative_scan(
            jgrep._compose_transfer, (a_row, b_row), axis=0)
        c_d = a_incl[d - 1] if d else jnp.zeros_like(a_row[0])
        b_ex = b_incl[d - 1] if d else jnp.ones_like(b_row[0])
        m, seg, nl, fm, lm = (jnp.asarray(x.numpy().astype(np.uint32))
                              for x in summ[d])
        np.testing.assert_array_equal(
            got.lines.numpy().astype(np.uint32), np.asarray(seg - (fm & c_d)))
        np.testing.assert_array_equal(
            got.delta.numpy().astype(np.uint32),
            np.asarray(fm & b_ex & (jnp.uint32(1) - c_d)))
        np.testing.assert_array_equal(got.blk_a.numpy(), np.asarray(a_incl[-1]))
        np.testing.assert_array_equal(got.blk_b.numpy(), np.asarray(b_incl[-1]))


CHUNK = 4096
JSTREAM = JConfig(backend="pallas", map_impl="split", combiner="off",
                  pallas_max_token=8, chunk_bytes=CHUNK, superstep=2,
                  inflight_groups=2)
STREAM = convert.config_from_dict(dataclasses.asdict(JSTREAM))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three files: one with a line far longer than a chunk (matches in
    several chunks of it), one without a trailing newline that ends in a
    match (the carry must reset at the next file), one of Zipf words."""
    rng = np.random.default_rng(9)
    words = [b"the", b"cat", b"w1", b"w12", b"zq", b"a1b2", b"[x]"]
    seps = [b" ", b"\n", b"\t", b"  ", b" \r\n"]

    def text(n):
        return b"".join(words[int(i)] + seps[int(j)] for i, j in zip(
            rng.zipf(1.5, n) % len(words), rng.integers(0, len(seps), n)))

    d = tmp_path_factory.mktemp("grep")
    a = (text(900) + b"MATCH " + b"w " * 3000 + b"MATCH the end\n"
         + text(700) + b"x MATCH")
    b = b"MATCH first line\n" + text(300)
    c = text(1500) + b"\n"
    paths = []
    for name, data in (("a", a), ("b", b), ("c", c)):
        p = d / f"{name}.txt"
        p.write_bytes(data)
        paths.append(str(p))
    return paths


def _re_oracle(paths, regex: bytes):
    """Overlapping matches and matching lines, file by file (no match or
    line crosses a file)."""
    m = ln = 0
    for p in paths:
        data = open(p, "rb").read()
        m += sum(1 for _ in re.finditer(b"(?=" + regex + b")", data,
                                        re.DOTALL))
        ln += sum(1 for line in data.split(b"\n")
                  if re.search(regex, line, re.DOTALL))
    return m, ln


def test_streamed_grep_file_equals_jax_and_re(corpus):
    """One pattern, four literal patterns in one pass (two with a
    newline) and three class patterns in one pass, against the JAX
    executor on one device and the ``re`` oracle."""
    want = jgrep.grep_file(corpus, b"MATCH", JSTREAM, mesh=data_mesh(1))
    got = grep.grep_file(corpus, b"MATCH", STREAM, device="cpu")
    assert got == want
    assert (got.matches, got.lines) == _re_oracle(corpus, b"MATCH")
    pats = [b"the", b"w1", b"1\n", b"\nw"]
    want = jgrep.grep_file_multi(corpus, pats, JSTREAM, mesh=data_mesh(1))
    got = grep.grep_file_multi(corpus, pats, STREAM, device="cpu")
    assert got == want
    for r, p in zip(got, pats):
        m, ln = _re_oracle(corpus, re.escape(p))
        if b"\n" in p:
            # No match across a chunk join (the envelope), and a line
            # holds no newline: the oracle bounds the matches only.
            assert 0 < r.matches <= m, p
        else:
            assert (r.matches, r.lines) == (m, ln), p
    cls = [b"w[0-9]", b"[a-z][0-9][a-z]", rb"\[.\]"]
    want = jgrep.grep_file_multi(corpus, cls, JSTREAM, mesh=data_mesh(1),
                                 syntax="class")
    got = grep.grep_file_multi(corpus, cls, STREAM, device="cpu",
                               syntax="class")
    assert got == want
    for r, (spec, regex) in zip(got, [(cls[0], rb"w[0-9]"),
                                      (cls[1], rb"[a-z][0-9][a-z]"),
                                      (cls[2], rb"\[[^\n\x00]\]")]):
        assert (r.matches, r.lines) == _re_oracle(corpus, regex), spec


@pytest.mark.parametrize("chunk", [2304, 4096, 8192])
def test_separator_pattern_at_several_chunk_sizes(tmp_path, chunk):
    """A pattern with a space never matches across a chunk join (the
    documented envelope), so equal counts need the port's chunker to cut
    where the JAX reader cuts: a separator-free run longer than a chunk
    (force-split) and space-separated pairs around every join."""
    p = tmp_path / "sep.txt"
    p.write_bytes(b"ab cd " * 900 + b"r" * (chunk + 500) + b" ab cd\n"
                  + b"ab  cd ab cd\n" * 300)
    jcfg = dataclasses.replace(JSTREAM, chunk_bytes=chunk)
    cfg = dataclasses.replace(STREAM, chunk_bytes=chunk)
    for pat in (b"ab cd", b"d a", b"r a"):
        want = jgrep.grep_file(str(p), pat, jcfg, mesh=data_mesh(1))
        got = grep.grep_file(str(p), pat, cfg, device="cpu")
        assert got == want, (pat, chunk)
    assert got.matches > 0


def test_file_seam_resets_the_carry_after_a_resume(tmp_path, monkeypatch):
    """The carry resets at a file boundary, also when a run resumes from a
    snapshot taken right at the seam (the JAX package's case)."""
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(b"x MATCH")  # unterminated matching line
    b.write_bytes(b"MATCH y\n")
    paths = [str(a), str(b)]
    cfg = dataclasses.replace(STREAM, chunk_bytes=128, backend="xla")
    full = grep.grep_file(paths, b"MATCH", cfg, device="cpu")
    assert full[1:] == (2, 2)
    ck = str(tmp_path / "ck.npz")
    original = mr.Engine.step
    fired = []

    def crash(self, state, chunk, step_index):
        if step_index == 1 and not fired:
            fired.append(step_index)
            raise RuntimeError("crash at the file seam")
        return original(self, state, chunk, step_index)

    monkeypatch.setattr(mr.Engine, "step", crash)
    with pytest.raises(RuntimeError, match="file seam"):
        grep.grep_file(paths, b"MATCH", cfg, device="cpu",
                       checkpoint_path=ck, checkpoint_every=1)
    monkeypatch.undo()
    assert fired
    resumed = grep.grep_file(paths, b"MATCH", cfg, device="cpu",
                             checkpoint_path=ck, checkpoint_every=1)
    assert resumed == full


def test_streamed_grep_reads_the_host_never(corpus, monkeypatch):
    """No ``host_read`` span in a streamed grep: the map, the seam
    correction and the combine stay on the device."""
    reads = collections.Counter()
    real = wc.span

    def counting(name, timer=None):
        reads[name] += 1
        return real(name, timer)

    monkeypatch.setattr(wc, "span", counting)
    r = grep.grep_file_multi(corpus, [b"the", b"\n"], STREAM, device="cpu")
    assert r[0].matches > 0 and reads["host_read"] == 0
    counted = executor.count_file(corpus, STREAM, device="cpu")
    assert reads["host_read"] == len(counted.run.bases)  # the count works


def test_grep_bytes_multi_equals_jax():
    data = _buf(40, 3000).tobytes().rstrip(b"\x00") + b" tail"
    pats = [b"a", b"ab", b"\n", b"x\n", b" ."]
    want = jgrep.grep_bytes_multi(data, pats)
    assert grep.grep_bytes_multi(data, pats, device="cpu") == want
    cls = [b"[ab].", b"\\..", b"[^a]b"]
    want = jgrep.grep_bytes_multi(data, cls, "class")
    assert grep.grep_bytes_multi(data, cls, "class", device="cpu") == want
