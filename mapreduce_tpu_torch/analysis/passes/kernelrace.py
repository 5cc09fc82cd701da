"""Pass: each CUDA kernel's cross-block protocol, certified from its source.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.kernelrace` (pass id
``kernel-race``).  A TPU grid runs its iterations in order, and the JAX
pass checks that a ref revisited across iterations is written only by
read-modify-write or under a guard.  A CUDA grid runs its blocks in any
order and at once, so what must hold is each kernel's protocol between
blocks.  A dynamic race checker needs the CUDA sanitizer at run time;
this pass is a static certificate of the sources, which runs anywhere:
every
``__global__`` function of ``csrc/*.cu`` against its declaration in
``ops/cuda/plans.py:PROTOCOLS``, which names each global buffer it writes
and its kind (:data:`...plans.BUFFER_KINDS`: block-disjoint rows, a target
every block shares, look-back status words, a ticket, or a one-block
grid).  A scan of each kernel body (and of the device helpers it calls,
through the pointers it passes them) checks that:

* every store or atomic goes to a declared buffer, and to a ``shared`` or
  ``ticket`` buffer only as an atomic, or (``shared``) as a plain store
  the protocol declares one block makes (``Protocol.one_block``: the
  buffer and subscript the chunk's last tile or window, or the last CTA,
  writes): any other plain store to a shared target is a blind write, an
  ERROR, as the JAX pass's unguarded write to a revisited ref.  Which
  block a condition picks is declared, not read from the source;
* a kernel with status words or a ticket has its launcher (``mr_*``) clear
  them with ``cudaMemsetAsync`` before the launch, or tag them with an
  epoch the launcher checks: stale words from an earlier call would let a
  look-back read another call's prefix (ERROR);
* every loop that polls a status word (a ``volatile`` read) counts its
  polls against a bound and traps past it, so a fault ends the launch
  instead of hanging the card (ERROR);
* a block-disjoint or one-block buffer read before the kernel first
  writes it is a WARNING (the JAX pass's read before a guarded
  initialization).

Also held: each kernel's ``KernelSpec.source`` line is its ``__global__``
line, and every ``__global__`` has a spec and a protocol.  The dynamic
half runs on the card (``chip_smoke.py`` phase 15): each kernel's probe
eight times, half of them beside a concurrent kernel on another stream so
that blocks start out of order, every output bit-identical to the plain
version's.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re

from mapreduce_tpu_torch.analysis import core, trace
from mapreduce_tpu_torch.ops.cuda import plans

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_REPO = os.path.dirname(os.path.dirname(CSRC))

_BOUNDED_POLL = re.compile(r"\+\+\s*\w+\s*>\s*\w+")


@dataclasses.dataclass(frozen=True)
class Function:
    """One function definition of a source: its kind (``global``,
    ``device`` or ``host``), name, ``(name, declaration)`` parameters, body
    text (braces included), body offset in the file and the line of its
    ``__global__``/``__device__``/``extern`` keyword."""

    kind: str
    name: str
    params: tuple
    body: str
    offset: int
    line: int

    def buffers(self) -> set:
        """Parameters a store can reach: pointers and pointer tables."""
        return {n for n, decl in self.params
                if "*" in decl or "TablePlanes" in decl}


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError(f"unbalanced {open_} at {i}")


def _strip_comments(text: str) -> str:
    """Comments blanked out, offsets and lines kept."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


_HEAD = re.compile(r'^(__global__|__device__|extern "C")', re.M)


def parse(text: str) -> dict:
    """Every function definition that follows a ``__global__``,
    ``__device__`` or ``extern "C"`` keyword, by name (a later definition
    of a name replaces an earlier)."""
    text = _strip_comments(text)
    out = {}
    for m in _HEAD.finditer(text):
        kind = {"__global__": "global", "__device__": "device"}.get(
            m.group(1), "host")
        i = m.end()
        name = None
        while True:
            n = re.compile(r"(\w+)\s*\(").search(text, i)
            if n is None:
                break
            if n.group(1) == "__launch_bounds__":
                i = _match(text, n.end() - 1, "(", ")")
                continue
            name, p0 = n.group(1), n.end() - 1
            break
        if name is None:
            continue
        p1 = _match(text, p0, "(", ")")
        rest = text[p1:]
        stripped = rest.lstrip()
        if not stripped.startswith("{"):
            continue  # a declaration
        b0 = p1 + len(rest) - len(stripped)
        b1 = _match(text, b0, "{", "}")
        params = []
        for decl in _split_args(text[p0 + 1:p1 - 1]):
            ident = re.findall(r"\w+", decl.split("=")[0])
            if ident:
                params.append((ident[-1], decl.strip()))
        out[name] = Function(kind, name, tuple(params), text[b0:b1], b0,
                             text.count("\n", 0, m.start()) + 1)
    return out


def _split_args(s: str) -> list:
    """Top-level comma-separated pieces of an argument list."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([<{":
            depth += 1
        elif ch in ")]>}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


_ALIAS = re.compile(
    r"\s*(?:const\s+)?(volatile\s+)?[\w:<>, ]*?\*+\s*(?:const\s+)?"
    r"(?:__restrict__\s+)?(\w+)\s*=\s*(.+)$", re.S)


def _statements(body: str):
    """``(start, end)`` of each stretch between ``;``, ``{`` and ``}``."""
    start = 0
    for m in re.finditer(r"[;{}]", body):
        yield start, m.start()
        start = m.end()


def aliases(fn: Function) -> tuple[dict, set, list]:
    """``({local pointer: the buffer parameter it points into}, {volatile
    aliases}, [(start, end) of the alias declarations])``."""
    bufs = fn.buffers()
    out, vol, spans = {}, set(), []
    for a, b in _statements(fn.body):
        m = _ALIAS.match(fn.body, a, b)
        if m is None:
            continue
        name, rhs = m.group(2), m.group(3)
        for ident in re.findall(r"\b\w+\b", rhs):
            base = ident if ident in bufs else out.get(ident)
            if base is not None:
                out[name] = base
                if m.group(1):
                    vol.add(name)
                spans.append((a, b))
                break
    return out, vol, spans


@dataclasses.dataclass(frozen=True)
class Store:
    buffer: str  # the kernel parameter written
    atomic: bool
    offset: int  # in the body
    subscript: str = ""  # a plain store's index, as written
    via: str = ""  # the helper that stores, if any


_ASSIGN = re.compile(
    r"(?<![\w.>])(\*\s*)?(\w+)\s*((?:\[(?:[^\[\]]|\[[^\]]*\])*\]|\.\w+|"
    r"->\w+)*)\s*(?:[-+*/|&^]|<<|>>)?=(?!=)")
_ATOMIC = re.compile(r"\batomic\w+\s*\(\s*(?:reinterpret_cast\s*<[^>]*>"
                     r"\s*\(\s*)?&?\s*(\w+)")


def _is_declaration(body: str, start: int, deref: bool) -> bool:
    before = body[:start].rstrip()
    if deref:
        return False
    if before.endswith("*") or before.endswith("&"):
        return bool(re.search(r"[\w>]\s*[*&]+$", before))
    return bool(re.search(r"[\w>]$", before)) and not re.search(
        r"\b(return|else)$", before)


def _calls(fn: Function, name: str):
    return re.finditer(rf"\b{name}\s*(?:<[^>()]*>)?\s*\(", fn.body)


def stores(fn: Function, functions: dict, _memo=None) -> list:
    """Every store and atomic of ``fn`` (and of the device helpers it
    calls) to one of its buffer parameters."""
    memo = {} if _memo is None else _memo
    if fn.name in memo:
        return memo[fn.name]
    memo[fn.name] = []  # a recursive call sees no stores
    bufs = fn.buffers()
    alias, _, spans = aliases(fn)

    def base(ident):
        return ident if ident in bufs else alias.get(ident)

    out = []
    for m in _ASSIGN.finditer(fn.body):
        b = base(m.group(2))
        if b is None or _is_declaration(fn.body, m.start(2),
                                        bool(m.group(1))):
            continue
        if not m.group(1) and not m.group(3):
            continue  # the pointer itself reassigned, not a store
        if any(s <= m.start() < e for s, e in spans):
            continue
        sub = re.fullmatch(r"\s*\[(.*)\]\s*", m.group(3) or "", re.S)
        out.append(Store(b, False, m.start(),
                         sub.group(1).strip() if sub else ""))
    for m in _ATOMIC.finditer(fn.body):
        b = base(m.group(1))
        if b is not None:
            out.append(Store(b, True, m.start()))
    # Helpers: what each writes through its pointer parameters.
    for name, helper in functions.items():
        if helper.kind != "device" or name == fn.name:
            continue
        calls = list(_calls(fn, name))
        if not calls:
            continue
        inner = stores(helper, functions, memo)
        positions = {p: i for i, (p, _) in enumerate(helper.params)}
        for m in calls:
            args = _split_args(fn.body[m.end():_match(
                fn.body, m.end() - 1, "(", ")") - 1])
            for s in inner:
                i = positions.get(s.buffer)
                if i is None or i >= len(args):
                    continue
                ident = re.findall(r"\b[A-Za-z_]\w*", args[i])
                b = base(ident[0]) if ident else None
                if b is not None:
                    out.append(Store(b, s.atomic, m.start(), via=name))
    memo[fn.name] = sorted(out, key=lambda s: s.offset)
    return memo[fn.name]


def _loops(body: str):
    """``(header, loop text)`` of every ``while``/``for`` loop."""
    for m in re.finditer(r"\b(while|for)\s*\(", body):
        h1 = _match(body, m.end() - 1, "(", ")")
        rest = body[h1:]
        k = h1 + len(rest) - len(rest.lstrip())
        end = _match(body, k, "{", "}") if body[k:k + 1] == "{" \
            else body.find(";", k) + 1
        yield body[m.start():h1], body[m.start():end]


@dataclasses.dataclass(frozen=True)
class Issue:
    severity: str
    kernel: str
    message: str
    location: str
    hint: str = ""


def _loc(path: str, text: str, offset: int) -> str:
    return f"{os.path.relpath(path, _REPO)}:{text.count(chr(10), 0, offset) + 1}"


def certify_source(path: str, text: str | None = None,
                   protocols: dict | None = None) -> dict:
    """``{kernel: [Issue, ...]}`` for every ``__global__`` function of one
    source, held to ``protocols`` (default :data:`...plans.PROTOCOLS`); an
    empty list is a certified kernel."""
    if text is None:
        with open(path) as f:
            text = f.read()
    protocols = plans.PROTOCOLS if protocols is None else protocols
    functions = parse(text)
    out: dict = {}
    for fn in functions.values():
        if fn.kind != "global":
            continue
        issues: list = []
        out[fn.name] = issues
        here = f"{os.path.relpath(path, _REPO)}:{fn.line}"
        proto = protocols.get(fn.name)
        if proto is None:
            issues.append(Issue(core.ERROR, fn.name,
                                "no declared cross-block protocol", here,
                                "declare its buffers in ops/cuda/plans.py:"
                                "PROTOCOLS"))
            continue
        spec = plans.KERNELS.get(fn.name)
        if spec is None or spec.source != here:
            issues.append(Issue(
                core.ERROR, fn.name,
                f"its KernelSpec source is "
                f"{spec.source if spec else None}, not {here}", here,
                "update ops/cuda/plans.py:KERNELS"))
        found = stores(fn, functions)
        written = {s.buffer for s in found}
        for s in found:
            kind = proto.kind(s.buffer)
            where = _loc(path, text, fn.offset + s.offset)
            what = f"{'an atomic' if s.atomic else 'a store'} to " \
                f"{s.buffer!r}" + (f" (through {s.via})" if s.via else "")
            if kind is None:
                issues.append(Issue(
                    core.ERROR, fn.name,
                    f"{what} outside its declaration: no block-sharing "
                    "kind is declared for that buffer", where,
                    "declare the buffer in ops/cuda/plans.py:PROTOCOLS"))
            elif kind == "ticket" and not s.atomic:
                issues.append(Issue(
                    core.ERROR, fn.name,
                    f"blind write: {what}, a ticket every block takes "
                    "from (only atomics may touch it)", where))
            elif kind == "shared" and not s.atomic \
                    and not proto.stored_by_one_block(s.buffer, s.subscript):
                issues.append(Issue(
                    core.ERROR, fn.name,
                    f"blind write: {what}, a target every block shares, "
                    "and not a store its protocol gives one block", where,
                    "use an atomic, or write it from one block and declare "
                    "it in the protocol's one_block"))
        for buf, kind in proto.buffers:
            if buf not in written:
                issues.append(Issue(
                    core.WARNING, fn.name,
                    f"declares {buf!r} ({kind}) but never writes it", here,
                    "drop the stale declaration"))
        issues.extend(_read_before_write(path, text, fn, proto, found))
        issues.extend(_status_issues(path, functions, fn, proto))
        for f in [fn] + [functions[h] for h in functions
                         if functions[h].kind == "device"
                         and any(True for _ in _calls(fn, h))]:
            _, vol, _ = aliases(f)
            polled = vol | {b for b, k in proto.buffers
                            if k == "status" and f is fn}
            for header, loop in _loops(f.body):
                if not any(re.search(rf"\b{v}\s*\[", loop) for v in polled):
                    continue
                if "__trap" not in loop or not _BOUNDED_POLL.search(loop):
                    issues.append(Issue(
                        core.ERROR, fn.name,
                        f"a poll loop of {f.name} ({header.strip()}) is "
                        "not bounded: a lost status word hangs the card",
                        _loc(path, text, f.offset + f.body.find(loop)),
                        "count the polls and __trap() past a bound"))
    return out


def _read_before_write(path, text, fn, proto, found) -> list:
    alias, _, spans = aliases(fn)
    out = []
    for buf, kind in proto.buffers:
        if kind not in ("disjoint", "one-cta"):
            continue
        first = next((s.offset for s in found if s.buffer == buf), None)
        if first is None:
            continue
        names = {buf} | {a for a, b in alias.items() if b == buf}
        for m in re.finditer(r"\b(\w+)\s*\[", fn.body[:first]):
            if m.group(1) in names and not any(s <= m.start() < e
                                               for s, e in spans):
                out.append(Issue(
                    core.WARNING, fn.name,
                    f"reads {buf!r} before it first writes it: blocks see "
                    "whatever an earlier call left there",
                    _loc(path, text, fn.offset + m.start()),
                    "declare it read-modify-write, or initialise it first"))
                break
    return out


def _status_issues(path, functions, fn, proto) -> list:
    if not any(k in ("status", "ticket") for _, k in proto.buffers):
        return []
    launcher = functions.get(proto.launcher)
    here = f"{os.path.relpath(path, _REPO)}:{fn.line}"
    if launcher is None:
        return [Issue(core.ERROR, fn.name,
                      f"its launcher {proto.launcher} is not in the source",
                      here)]
    if proto.zeroed:
        zero = re.search(rf"cudaMemsetAsync\s*\(\s*{proto.zeroed}\b",
                         launcher.body)
        launch = re.search(rf"\b{fn.name}\s*<<<", launcher.body)
        if zero is None or (launch is not None
                            and zero.start() > launch.start()):
            return [Issue(
                core.ERROR, fn.name,
                f"{proto.launcher} does not clear {proto.zeroed!r} (its "
                "status words and ticket) before the launch: a call can "
                "read the last call's look-back words", here,
                "cudaMemsetAsync the work buffer in the launcher")]
        return []
    if proto.epoch:
        checked = re.search(rf"\b{proto.epoch}\s*[<>]", launcher.body)
        compared = re.search(rf"!=\s*{proto.epoch}\b|\b{proto.epoch}\s*!=",
                             fn.body)
        if checked and compared:
            return []
        return [Issue(
            core.ERROR, fn.name,
            f"status words tagged by {proto.epoch!r}, but the launcher "
            "does not check it or the poll does not compare it", here)]
    return [Issue(core.ERROR, fn.name,
                  "status words or a ticket, but neither zeroed nor "
                  "epoch-tagged once a call", here,
                  "declare zeroed= or epoch= in ops/cuda/plans.py")]


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


@functools.lru_cache(maxsize=None)
def _certified(paths: tuple) -> dict:
    out = {}
    for p in paths:
        out.update(certify_source(p))
    return out


def certificate() -> dict:
    """``{kernel: [Issue, ...]}`` over every shipped source (memoized)."""
    return _certified(tuple(sources()))


def _finding(issue: Issue, model: str, hook: str) -> core.Finding:
    return core.Finding(severity=issue.severity,
                        pass_id=KernelRacePass.pass_id, model=model,
                        hook=hook, message=f"{issue.kernel}: "
                        f"{issue.message}", location=issue.location,
                        hint=issue.hint)


def certify_sources(cert: dict | None = None) -> list:
    """The certificate as findings of the ``<kernels>`` model: each issue,
    each certified kernel as one INFO, and an ERROR for a declared
    protocol no source defines."""
    cert = certificate() if cert is None else cert
    out = []
    for kernel, issues in sorted(cert.items()):
        out.extend(_finding(i, "<kernels>", "sources") for i in issues)
        if not issues:
            out.append(core.Finding(
                severity=core.INFO, pass_id=KernelRacePass.pass_id,
                model="<kernels>", hook="sources",
                message=f"{kernel}: cross-block protocol certified "
                        f"({_summary(plans.PROTOCOLS[kernel])})",
                location=plans.KERNELS[kernel].source))
    for kernel in sorted(set(plans.PROTOCOLS) - set(cert)):
        out.append(core.Finding(
            severity=core.ERROR, pass_id=KernelRacePass.pass_id,
            model="<kernels>", hook="sources",
            message=f"{kernel}: declared in ops/cuda/plans.py:PROTOCOLS "
                    "but defined in no source",
            hint="drop the stale declaration"))
    return out


def _summary(proto) -> str:
    kinds: dict = {}
    for buf, kind in proto.buffers:
        kinds.setdefault(kind, []).append(buf)
    text = "; ".join(f"{k}: {', '.join(v)}" for k, v in kinds.items())
    if proto.one_block:
        text += "; stored by one block: " + ", ".join(
            f"{b}[{i}]" if i else b for b, i in proto.one_block)
    if proto.zeroed:
        text += f"; {proto.zeroed} cleared by {proto.launcher}"
    if proto.epoch:
        text += f"; status tagged by {proto.epoch}"
    return text


@core.register_pass
class KernelRacePass:
    pass_id = "kernel-race"
    description = ("each launched CUDA kernel's cross-block protocol "
                   "(disjoint rows, atomic shared targets, look-back "
                   "status cleared or epoch-tagged once a call, bounded "
                   "polls) certified from its source")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        cert = certificate()
        out: list[core.Finding] = []
        for hook, traced in ctx.engine_traces.items():
            if isinstance(traced, trace.TraceFailure):
                continue
            seen: set = set()
            for node in traced.kernels:
                for launch in (node.plan.launches if node.plan else ()):
                    kernel = launch.kernel
                    if kernel in seen:
                        continue
                    seen.add(kernel)
                    issues = cert.get(kernel)
                    if issues is None:
                        out.append(core.Finding(
                            severity=core.ERROR, pass_id=self.pass_id,
                            model=ctx.model, hook=hook,
                            message=f"{kernel}: launched, but defined in "
                                    "no source under csrc/"))
                    elif issues:
                        out.extend(_finding(i, ctx.model, hook)
                                   for i in issues)
                    else:
                        out.append(core.Finding(
                            severity=core.INFO, pass_id=self.pass_id,
                            model=ctx.model, hook=hook,
                            message=f"{kernel}: cross-block protocol "
                                    "certified",
                            location=plans.KERNELS[kernel].source))
        return out
