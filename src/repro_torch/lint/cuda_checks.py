"""CUDA source checks: the port's own kernel contracts (the counterpart of
the reference's ``pallas_checks.py``).

The port's kernels are CUDA C++ in ``csrc/`` (``.cu`` launchers, ``.cuh``
shared device code), compiled with nvcc and bound with ctypes
(``kernels/_build.py``). This pass reads those sources as text — a light
scan that strips comments and strings, finds function definitions by
their braces, and resolves calls by name within a translation unit (a
``.cu`` plus the ``.cuh`` files it includes) — and checks:

  * ``cuda-fp32-atomic`` — no floating-point ``atomicAdd`` /
    ``atomicAdd_block`` / ``atomicAdd_system`` (a target not shown to be
    an integer counts as floating) and no ``red.*`` / ``atom.*`` add on
    ``.f32`` / ``.f64`` / ``.f16`` / ``.bf16`` in inline PTX: the order of
    such adds changes run to run, and kill-and-resume is bitwise;
  * ``cuda-launcher-contract`` — every ``extern "C"`` function that
    reaches a kernel launch takes a stream and returns an error code;
    every ``<<<…>>>`` passes a stream parameter of its function as its
    fourth argument (the default stream would break graph capture and
    serialize against the caller's stream); every launch is followed, in
    its function, by ``cudaGetLastError()`` (``kernels/_build.py``: the
    launcher returns it);
  * ``cuda-launcher-alloc-sync`` — no ``cudaMalloc*``, ``cudaFree*``,
    synchronous ``cudaMemcpy*`` / ``cudaMemset*``, or
    ``cudaDeviceSynchronize`` / ``cudaStreamSynchronize`` /
    ``cudaEventSynchronize``: a launcher allocates nothing and never
    waits (``_build.py``), or it could not be captured in a graph;
  * ``cuda-int-index`` — an offset into a pointer parameter of a
    ``__global__`` kernel (``p[...]`` or ``p + ...``, and pointers
    derived from one) that multiplies two non-literal 32-bit ints before
    any ``size_t`` / ``int64_t`` cast: it wraps past 2^31 elements, which
    the serve cut's 4 x 1048576 x 8 rows come within a factor of 64 of;
  * ``cuda-vector-alignment`` — an ``extern "C"`` launcher that reaches a
    16-byte access (a ``float4`` / ``uint4`` / ``int4`` / ``double2``
    reinterpret, ``cp.async`` of 16 bytes or a bulk copy) without testing
    a pointer's address for alignment (``reinterpret_cast<uintptr_t>(p) %
    16``, or a helper such as ``misaligned16`` that does): a misaligned
    view faults on the card instead of being refused;
  * ``cuda-smem-budget`` — a kernel's ``__shared__`` arrays of literal
    size above the 48 KiB a block gets without opting in, or a literal
    dynamic shared memory size above the H100's 227 KiB a block;
  * ``kernel-fallback`` (Python) — an ``except`` body in ``repro_torch/``
    (tests excluded) that calls into ``kernels/ref.py``: a CUDA tensor
    gets its kernel or an error, never a quiet fall back to the plain
    version (the counterpart of ``pallas-interpret-hardcoded``).
"""

from __future__ import annotations

import ast
import bisect
import math
import re
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                                   call_name, is_test_path)

STATIC_SMEM_BYTES = 48 * 1024          # without cudaFuncSetAttribute
BLOCK_SMEM_BYTES = 227 * 1024          # H100, per block, opted in

_CONTROL = {"if", "for", "while", "switch", "catch", "return", "sizeof",
            "defined", "alignas", "alignof", "decltype", "static_assert",
            "__launch_bounds__", "asm", "volatile"}
_DEFAULT_STREAMS = {"0", "nullptr", "NULL", "cudaStreamLegacy",
                    "cudaStreamPerThread", "cudaStreamDefault"}
_FLOAT_TYPES = r"(?:float|double|half|__half|__half2|__nv_bfloat16|" \
               r"__nv_bfloat162|bf16|float2|float4)"
_INT_TYPES = r"(?:int|unsigned|unsigned\s+int|uint32_t|int32_t|" \
             r"unsigned\s+long\s+long|long\s+long|size_t|int64_t|" \
             r"uint64_t|unsigned\s+long|long)"
_INT32 = re.compile(r"^(?:const\s+)?(?:int|unsigned|unsigned\s+int|"
                    r"uint32_t|int32_t|short|unsigned\s+short)$")
_INT64 = re.compile(r"^(?:const\s+)?(?:size_t|int64_t|uint64_t|ptrdiff_t|"
                    r"long\s+long|long|unsigned\s+long\s+long|"
                    r"unsigned\s+long|intptr_t|uintptr_t)$")
_CAST64 = re.compile(r"^(?:\(\s*(?:size_t|int64_t|uint64_t|ptrdiff_t|"
                     r"long\s+long|long|unsigned\s+long\s+long)\s*\)|"
                     r"static_cast<\s*(?:size_t|int64_t|uint64_t|ptrdiff_t|"
                     r"long\s+long|long)\s*>|"
                     r"(?:size_t|int64_t|uint64_t|ptrdiff_t)\s*\()")
_BUILTIN_INT = re.compile(r"^(?:threadIdx|blockIdx|blockDim|gridDim)"
                          r"\.[xyz]$")
_ATOMIC_RE = re.compile(r"\batomicAdd(?:_block|_system)?\s*\(")
_PTX_FADD_RE = re.compile(r"\b(?:red|atom)(?:\.\w+)*\.add(?:\.\w+)*?"
                          r"\.(?:f32|f64|f16|bf16|f16x2|bf16x2)\b")
_ALLOC_SYNC_RE = re.compile(
    r"\b(cudaMalloc\w*|cudaFree\w*|cudaMemcpy\w*|cudaMemset\w*|"
    r"cudaHostAlloc|cudaDeviceSynchronize|cudaStreamSynchronize|"
    r"cudaEventSynchronize)\s*\(")
_VEC16_RE = re.compile(
    r"reinterpret_cast<\s*(?:const\s+)?(?:float4|uint4|int4|double2|"
    r"longlong2|ulonglong2)\s*\*\s*>|"
    r"\(\s*(?:const\s+)?(?:float4|uint4|int4|double2)\s*\*\s*\)|"
    r"cp\.async\.bulk|cp\.async\.(?:ca|cg)\.shared\.global[^\"]*?\b16\b")
_ALIGN_TEST_RE = re.compile(
    r"(?:reinterpret_cast<\s*(?:const\s+)?(?:u?intptr_t|size_t|uint64_t|"
    r"unsigned\s+long\s+long)\s*>|\(\s*u?intptr_t\s*\))\s*\(?\s*\w+\s*\)?"
    r"\s*(?:%|&)")
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_TARGS = r"<[\w\s,:*&]*(?:<[\w\s,:*&]*>[\w\s,:*&]*)*>"   # template args
_SIZES = {"char": 1, "int8_t": 1, "uint8_t": 1, "bool": 1,
          "short": 2, "half": 2, "__half": 2, "__nv_bfloat16": 2,
          "bf16": 2, "uint16_t": 2, "int16_t": 2,
          "float": 4, "int": 4, "unsigned": 4, "uint32_t": 4, "int32_t": 4,
          "double": 8, "uint64_t": 8, "int64_t": 8, "size_t": 8,
          "float2": 8, "float4": 16, "uint4": 16, "int4": 16}


# ---------------------------------------------------------------------------
# a light C++ scan
# ---------------------------------------------------------------------------

def _blank(source: str, strings: bool) -> str:
    """``source`` with comments (and, if ``strings``, string and char
    literal contents) replaced by spaces; newlines and offsets kept."""
    out = list(source)
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [ch if ch == "\n" else " " for ch in source[i:j]]
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c:
                j += 2 if source[j] == "\\" else 1
            if strings:
                out[i + 1:j] = [ch if ch == "\n" else " "
                                for ch in source[i + 1:j]]
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index of the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j
    return len(text) - 1


def _match_back(text: str, i: int, open_: str, close: str) -> int:
    """Index of the bracket opening the one closed at ``i``."""
    depth = 0
    for j in range(i, -1, -1):
        if text[j] == close:
            depth += 1
        elif text[j] == open_:
            depth -= 1
            if depth == 0:
                return j
    return 0


def _split_top(text: str, sep: str = ",") -> List[str]:
    """``text`` split at ``sep`` outside (), [], {} and <>."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts]


class Param(NamedTuple):
    type: str
    name: str
    pointer: bool


class Function(NamedTuple):
    name: str
    namespace: str
    params: Tuple[Param, ...]
    prefix: str          # the declaration before the name
    start: int           # offset of the name
    body: Tuple[int, int]  # offsets of the braces
    module: "CudaSource"

    @property
    def is_global(self) -> bool:
        return "__global__" in self.prefix

    @property
    def is_device(self) -> bool:
        return "__device__" in self.prefix and "__host__" not in self.prefix

    @property
    def is_extern_c(self) -> bool:
        return bool(re.search(r'\bextern\s*"', self.prefix))

    @property
    def is_host(self) -> bool:
        return not self.is_global and not self.is_device

    @property
    def return_type(self) -> str:
        words = re.sub(r'extern\s*"\s*"|template\s*<[^>]*>|inline|static|'
                       r"__forceinline__|__host__|__launch_bounds__\s*\([^)]*"
                       r"\)", " ", self.prefix).split()
        return " ".join(words)

    def text(self, code: bool = False) -> str:
        src = self.module.code if code else self.module.bare
        return src[self.body[0]:self.body[1] + 1]

    def line(self) -> int:
        return self.module.line_of(self.start)


def _params(text: str) -> Tuple[Param, ...]:
    out = []
    for p in _split_top(text):
        p = re.sub(r"=.*$", "", p).strip()     # default values
        if not p or p == "void":
            continue
        m = re.match(r"^(.*?)([A-Za-z_]\w*)\s*(\[[^\]]*\])?$", p, re.S)
        if not m:
            continue
        typ = " ".join(m.group(1).replace("__restrict__", " ").split())
        out.append(Param(typ.rstrip("&* ").strip(), m.group(2),
                         "*" in typ or bool(m.group(3))))
    return tuple(out)


class CudaSource:
    """A CUDA source as scanned text: its functions, by name."""

    def __init__(self, module: Module):
        self.module = module
        self.path = module.path
        self.code = _blank(module.source, strings=False)   # strings kept
        self.bare = _blank(module.source, strings=True)
        self._line_starts = [0] + [i + 1 for i, c in
                                   enumerate(module.source) if c == "\n"]
        self.functions: List[Function] = self._functions()

    def line_of(self, offset: int) -> int:
        return bisect.bisect_right(self._line_starts, offset)

    def _namespaces(self) -> List[Tuple[int, int, str]]:
        out = []
        for m in re.finditer(r"\bnamespace\s*([A-Za-z_]\w*)?\s*\{",
                             self.bare):
            open_ = m.end() - 1
            out.append((open_, _match(self.bare, open_, "{", "}"),
                        m.group(1) or ""))
        return out

    def _functions(self) -> List[Function]:
        text = self.bare
        spaces = self._namespaces()
        out: List[Function] = []
        i = 0
        while True:
            i = text.find("{", i)
            if i < 0:
                break
            j = i - 1
            while j >= 0 and text[j].isspace():
                j -= 1
            tail = re.search(r"\)\s*(?:const|noexcept|override)?\s*$",
                             text[max(0, j - 20):j + 1])
            if not tail:
                i += 1
                continue
            close = text.rfind(")", 0, j + 1)
            open_ = _match_back(text, close, "(", ")")
            k = open_ - 1
            while k >= 0 and text[k].isspace():
                k -= 1
            m = re.search(r"([A-Za-z_]\w*)$", text[max(0, k - 80):k + 1])
            if not m or m.group(1) in _CONTROL:
                i += 1
                continue
            name = m.group(1)
            start = k + 1 - len(name)
            cut = max(text.rfind(";", 0, start), text.rfind("}", 0, start),
                      text.rfind("{", 0, start),
                      text.rfind("\n#", 0, start), 0)
            cut += text[cut] in ";{}"
            prefix = self.code[cut:start]
            decl = re.sub(r"__launch_bounds__\s*\([^)]*\)\s*$", "",
                          text[cut:start].rstrip())
            if decl.rstrip().endswith((")", "]", "=", ",", ":", "(")) \
                    or re.search(r"\b(?:return|new)\s*$", decl):
                i += 1
                continue
            end = _match(text, i, "{", "}")
            ns = ""
            for a, b, nsname in spaces:
                if a < start < b and nsname:
                    ns = nsname
            out.append(Function(name, ns, _params(text[open_ + 1:close]),
                                " ".join(prefix.split()), start, (i, end),
                                self))
            i = end + 1
        return out


class Launch(NamedTuple):
    kernel: str
    config: List[str]
    offset: int          # of the kernel's name
    end: int             # of the statement's ';'


def _launches(src: CudaSource, lo: int = 0, hi: Optional[int] = None
              ) -> List[Launch]:
    text = src.bare
    hi = len(text) if hi is None else hi
    out = []
    for m in re.finditer(r"<<<", text[lo:hi]):
        at = lo + m.start()
        close = text.find(">>>", at)
        config = _split_top(text[at + 3:close])
        before = text[max(0, at - 200):at]
        name = re.search(r"([A-Za-z_][\w:]*)\s*(?:" + _TARGS + r")?\s*$",
                         before)
        end = text.find(";", close)
        out.append(Launch(name.group(1) if name else "?", config,
                          at - len(before) + (name.start() if name else 0),
                          end if end >= 0 else hi))
    return out


_CALL_RE = re.compile(r"\b([A-Za-z_]\w*(?:::[A-Za-z_]\w*)*)\s*"
                      r"(?:" + _TARGS + r")?\s*\(")


class Unit:
    """A translation unit: a source and the sources it includes."""

    def __init__(self, sources: List[CudaSource]):
        self.sources = sources
        self.by_name: Dict[str, List[Function]] = {}
        for s in sources:
            for fn in s.functions:
                self.by_name.setdefault(fn.name, []).append(fn)

    def resolve(self, name: str, caller: Function) -> List[Function]:
        if "::" in name:
            ns, _, short = name.rpartition("::")
            ns = ns.split("::")[-1]
            return [f for f in self.by_name.get(short, [])
                    if f.namespace == ns or ns == "repro_torch"]
        cands = self.by_name.get(name, [])
        same = [f for f in cands if f.namespace == caller.namespace]
        return same or cands

    def edges(self, fn: Function) -> Tuple[List[Function], List[Function]]:
        """(functions ``fn`` calls, kernels ``fn`` launches)."""
        body = fn.text()
        launched = {l.kernel for l in _launches(fn.module, fn.body[0],
                                                fn.body[1] + 1)}
        calls, kernels = [], []
        for m in _CALL_RE.finditer(body):
            name = m.group(1)
            if name in _CONTROL or name == fn.name:
                continue
            calls += [f for f in self.resolve(name, fn) if f is not fn]
        for k in launched:
            kernels += [f for f in self.resolve(k, fn) if f.is_global]
        return calls, kernels

    def reach(self, fn: Function, host_only: bool = False
              ) -> List[Function]:
        seen, todo = [], [fn]
        while todo:
            f = todo.pop()
            if f in seen:
                continue
            seen.append(f)
            calls, kernels = self.edges(f)
            todo += [c for c in calls if not host_only or c.is_host]
            if not host_only:
                todo += kernels
        return seen


def _int_kinds(fn: Function) -> Dict[str, str]:
    """name -> "int32" / "int64" for fn's integer parameters and locals."""
    kinds: Dict[str, str] = {}
    for p in fn.params:
        if not p.pointer:
            if _INT32.match(p.type):
                kinds[p.name] = "int32"
            elif _INT64.match(p.type):
                kinds[p.name] = "int64"
    body = fn.text()
    for m in re.finditer(r"(?:^|[;{(]\s*)((?:const\s+)?" + _INT_TYPES +
                         r")\s+([^;()]*(?:\([^;]*?\))?[^;]*);", body, re.M):
        typ = " ".join(m.group(1).split())
        kind = "int32" if _INT32.match(typ) else \
            "int64" if _INT64.match(typ) else None
        if kind is None:
            continue
        for decl in _split_top(m.group(2)):
            nm = re.match(r"^([A-Za-z_]\w*)\b(?!\s*\()", decl)
            if nm and not decl.startswith("*"):
                kinds.setdefault(nm.group(1), kind)
    return kinds


def _pointers(fn: Function) -> Set[str]:
    """fn's pointer parameters and the local pointers derived from them."""
    ptrs = {p.name for p in fn.params if p.pointer}
    body = fn.text()
    changed = True
    while changed:
        changed = False
        for m in re.finditer(r"\*\s*(?:__restrict__\s*)?([A-Za-z_]\w*)\s*="
                             r"\s*([^;]*);", body):
            base = re.match(r"^\(?\s*(?:static_cast<[^>]*>\s*\()?\s*"
                            r"([A-Za-z_]\w*)", m.group(2))
            if base and base.group(1) in ptrs and m.group(1) not in ptrs:
                ptrs.add(m.group(1))
                changed = True
    return ptrs


def _factor_kind(f: str, kinds: Dict[str, str]) -> str:
    """"int32", "int64" or "other" (a literal, constant or unknown)."""
    f = f.strip()
    while f[:1] in "+-!~" and f:
        f = f[1:].strip()
    if _CAST64.match(f):
        return "int64"
    if re.match(r"^\(\s*(?:int|unsigned|uint32_t|int32_t)\s*\)", f) or \
            re.match(r"^static_cast<\s*(?:int|unsigned|uint32_t)\s*>", f):
        return "int32"
    if f.startswith("(") and _match(f, 0, "(", ")") == len(f) - 1:
        return _expr_kind(f[1:-1], kinds)[0]
    if _BUILTIN_INT.match(f):
        return "int32"
    if re.match(r"^[A-Za-z_]\w*$", f):
        return {"int32": "int32", "int64": "int64"}.get(kinds.get(f),
                                                         "other")
    return "other"


def _split_ops(text: str, ops: str) -> List[Tuple[str, str]]:
    """(operator before, operand) pairs of ``text`` split at top-level
    binary ``ops``."""
    parts, depth, cur, op = [], 0, [], ""
    prev = ""
    for i, ch in enumerate(text):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        binary = prev and prev not in "+-*/%(<>=&|^!~?:,"
        if ch in ops and depth == 0 and binary \
                and text[i - 1:i + 1] not in ("->",) \
                and text[i:i + 2] not in ("->",):
            parts.append((op, "".join(cur)))
            cur, op = [], ch
        else:
            cur.append(ch)
        if not ch.isspace():
            prev = ch
    parts.append((op, "".join(cur)))
    return parts


def _expr_kind(text: str, kinds: Dict[str, str]) -> Tuple[str, bool]:
    """(kind of the expression, whether it multiplies two non-literal
    32-bit ints before widening)."""
    bad = False
    kind_sum = "other"
    for _, term in _split_ops(text, "+-"):
        acc = None
        for op, factor in _split_ops(term, "*/%"):
            if not factor.strip():
                continue
            inner = factor.strip()
            if inner.startswith("(") and _match(inner, 0, "(", ")") \
                    == len(inner) - 1:
                bad |= _expr_kind(inner[1:-1], kinds)[1]
            k = _factor_kind(factor, kinds)
            if acc is None:
                acc = k
            elif op == "*" and acc == "int32" and k == "int32":
                bad = True
            elif "int64" in (acc, k):
                acc = "int64"
            elif "int32" in (acc, k):
                acc = "int32"
        if acc == "int64" or kind_sum == "int64":
            kind_sum = "int64"
        elif acc == "int32":
            kind_sum = "int32"
    return kind_sum, bad


def _offset_exprs(body: str, ptrs: Set[str]) -> Iterable[Tuple[int, str]]:
    """(offset in body, index expression) of every ``p[...]`` and
    ``p + ...`` with ``p`` in ``ptrs``."""
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*(\[|\+(?![+=]))", body):
        if m.group(1) not in ptrs:
            continue
        if m.group(2) == "[":
            close = _match(body, m.end() - 1, "[", "]")
            yield m.start(), body[m.end():close]
        else:
            j, depth = m.end(), 0
            while j < len(body):
                ch = body[j]
                if ch in "([{":
                    depth += 1
                elif ch in ")]}":
                    if depth == 0:
                        break
                    depth -= 1
                elif ch in ",;?:" and depth == 0:
                    break
                j += 1
            yield m.start(), body[m.end():j]


def _shared_bytes(fn: Function) -> Optional[int]:
    """Bytes of fn's ``__shared__`` arrays, where every one is literal."""
    total = 0
    found = False
    for m in re.finditer(r"__shared__\s+(?:alignas\(\d+\)\s+)?"
                         r"([A-Za-z_]\w*)\s+([^;]*);", fn.text()):
        if m.group(1) == "extern":
            continue
        size = _SIZES.get(m.group(1))
        for decl in _split_top(m.group(2)):
            dims = re.findall(r"\[([^\]]*)\]", decl)
            if not dims:
                continue
            found = True
            n = 1
            for d in dims:
                if not re.match(r"^\s*\d+(\s*\*\s*\d+)*\s*$", d):
                    return None
                n *= math.prod(int(v) for v in re.findall(r"\d+", d))
            if size is None:
                return None
            total += n * size
    return total if found else None


def _ref_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(module aliases of kernels/ref.py, function names imported from
    it) in this file."""
    modules, funcs = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                if a.name == "ref" and (mod.endswith("kernels")
                                        or (node.level and not mod)):
                    modules.add(a.asname or "ref")
                elif mod.endswith("kernels.ref") or \
                        (node.level and mod == "ref"):
                    funcs.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("kernels.ref"):
                    modules.add(a.asname or a.name)
    return modules, funcs


class CudaPass(LintPass):
    name = "cuda"
    reads = ("python", "cuda")
    rules = {
        "cuda-fp32-atomic":
            "floating-point atomicAdd / red.add in a CUDA source: the sum's "
            "order changes run to run (kill-and-resume is bitwise)",
        "cuda-launcher-contract":
            "extern \"C\" launcher without a stream or an error return, a "
            "<<<>>> launch not on its function's stream parameter, or a "
            "launch not followed by cudaGetLastError()",
        "cuda-launcher-alloc-sync":
            "cudaMalloc/cudaFree/synchronous cudaMemcpy/cudaMemset/"
            "*Synchronize in a CUDA source (a launcher allocates nothing "
            "and never waits)",
        "cuda-int-index":
            "pointer offset in a kernel multiplying two non-literal 32-bit "
            "ints before a size_t/int64_t cast",
        "cuda-vector-alignment":
            "extern \"C\" launcher reaching a 16-byte access (float4/uint4/"
            "cp.async 16/bulk copy) without testing a pointer's alignment",
        "cuda-smem-budget":
            "literal __shared__ arrays above 48 KiB a block, or a literal "
            "dynamic shared size above the H100's 227 KiB",
        "kernel-fallback":
            "except body in repro_torch/ calling into kernels/ref.py: a "
            "CUDA tensor gets its kernel or an error, never the plain "
            "version",
    }

    def __init__(self):
        self._sources: Dict[str, Module] = {}
        self._scanned: Dict[str, CudaSource] = {}

    def collect(self, module: Module, ctx: LintContext) -> None:
        if module.kind == "cuda":
            self._sources[str(Path(module.path))] = module

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if module.kind == "python":
            yield from self._check_fallback(module)
            return
        src = self._scan(module)
        yield from self._check_atomics(src)
        yield from self._check_alloc_sync(src)
        yield from self._check_launches(src)
        yield from self._check_index(src)
        yield from self._check_smem(src)
        if module.path.endswith(".cu"):
            yield from self._check_launchers(src, Unit(self._unit(src)))

    # ---- translation units -------------------------------------------------

    def _scan(self, module: Module) -> CudaSource:
        key = str(Path(module.path))
        if key not in self._scanned:
            self._scanned[key] = CudaSource(module)
        return self._scanned[key]

    def _unit(self, src: CudaSource) -> List[CudaSource]:
        out, todo = [], [src]
        while todo:
            s = todo.pop()
            if any(o.path == s.path for o in out):
                continue
            out.append(s)
            for inc in _INCLUDE_RE.findall(s.module.source):
                path = str(Path(s.path).parent / inc)
                mod = self._sources.get(str(Path(path)))
                if mod is None and Path(path).is_file():
                    mod = Module(path, Path(path).read_text(encoding="utf-8"))
                    self._sources[str(Path(path))] = mod
                if mod is not None:
                    todo.append(self._scan(mod))
        return out

    # ---- rules -------------------------------------------------------------

    def _check_atomics(self, src: CudaSource) -> Iterable[Finding]:
        for m in _ATOMIC_RE.finditer(src.bare):
            close = _match(src.bare, m.end() - 1, "(", ")")
            target = _split_top(src.bare[m.end():close])[0]
            if re.search(r"\b" + _FLOAT_TYPES + r"\b", target):
                floating = True
            else:
                base = re.search(r"[A-Za-z_]\w*", target)
                floating = True
                if base:
                    name = base.group(0)
                    if re.search(r"\b" + _INT_TYPES + r"\s*\*?\s*"
                                 r"(?:__restrict__\s*)?\b" + name + r"\b",
                                 src.bare):
                        floating = False
            if floating:
                yield self.finding(
                    src.module, src.line_of(m.start()), "cuda-fp32-atomic",
                    f"{m.group(0).rstrip('( ')} on {target!r}, which is "
                    "not shown to be an integer: floating-point atomic "
                    "adds land in another order each run, so a run is not "
                    "bitwise repeatable — sum in a fixed order (per-block "
                    "partials, then a reduction)")
        for m in _PTX_FADD_RE.finditer(src.code):
            yield self.finding(
                src.module, src.line_of(m.start()), "cuda-fp32-atomic",
                f"inline PTX {m.group(0)!r}: a floating-point atomic add "
                "lands in another order each run")

    def _check_alloc_sync(self, src: CudaSource) -> Iterable[Finding]:
        for m in _ALLOC_SYNC_RE.finditer(src.bare):
            name = m.group(1)
            if name.startswith(("cudaMemcpy", "cudaMemset")) \
                    and name.endswith("Async"):
                continue
            yield self.finding(
                src.module, src.line_of(m.start()),
                "cuda-launcher-alloc-sync",
                f"{name}() in a CUDA source: a launcher allocates nothing "
                "(the caller passes scratch) and never waits on the card, "
                "so that a step can be captured in a CUDA graph")

    def _check_launches(self, src: CudaSource) -> Iterable[Finding]:
        for fn in src.functions:
            launches = _launches(src, fn.body[0], fn.body[1] + 1)
            # the parameters, and locals cast from one
            # (cudaStream_t s = static_cast<cudaStream_t>(stream))
            stream_params = {p.name for p in fn.params} | set(re.findall(
                r"cudaStream_t\s+([A-Za-z_]\w*)\s*=", fn.text()))
            for i, l in enumerate(launches):
                line = src.line_of(l.offset)
                if len(l.config) < 4:
                    yield self.finding(
                        src.module, line, "cuda-launcher-contract",
                        f"{l.kernel}<<<...>>> passes no stream: it runs on "
                        "the default stream, which serializes against the "
                        "caller's stream and breaks graph capture — pass "
                        "the launcher's stream as the fourth argument")
                else:
                    arg = re.sub(r"^(?:static_cast<\s*cudaStream_t\s*>|"
                                 r"\(\s*cudaStream_t\s*\))\s*", "",
                                 l.config[3]).strip("() ")
                    if arg in _DEFAULT_STREAMS or arg not in stream_params:
                        yield self.finding(
                            src.module, line, "cuda-launcher-contract",
                            f"{l.kernel}<<<...>>> launches on {arg!r}, not "
                            f"on a stream parameter of {fn.name!r}: the "
                            "caller's stream must reach every launch")
                # up to the next launch in the same block, else to the
                # function's end (a launch in another branch is not next)
                block_end = _match(src.bare, src.bare.rfind(
                    "{", fn.body[0], l.offset), "{", "}")
                nxt = fn.body[1]
                if i + 1 < len(launches) \
                        and launches[i + 1].offset < block_end:
                    nxt = launches[i + 1].offset
                if "cudaGetLastError" not in src.bare[l.end:nxt]:
                    yield self.finding(
                        src.module, line, "cuda-launcher-contract",
                        f"{l.kernel}<<<...>>> is not followed by "
                        "cudaGetLastError(): a launch that failed goes "
                        "unreported to the Python wrapper")

    def _check_launchers(self, src: CudaSource,
                         unit: Unit) -> Iterable[Finding]:
        vec16 = {id(f) for s in unit.sources for f in s.functions
                 if _VEC16_RE.search(f.text(code=True))}
        for fn in src.functions:
            if not fn.is_extern_c:
                continue
            reached = unit.reach(fn)
            if not any(_launches(f.module, f.body[0], f.body[1] + 1)
                       for f in reached):
                continue        # a query (occupancy), not a launcher
            if not any("cudaStream_t" in p.type or "stream" in p.name
                       for p in fn.params):
                yield self.finding(
                    src.module, fn.line(), "cuda-launcher-contract",
                    f"launcher {fn.name!r} takes no stream: its kernels "
                    "would run on the default stream")
            if re.search(r"\bvoid$", fn.return_type):
                yield self.finding(
                    src.module, fn.line(), "cuda-launcher-contract",
                    f"launcher {fn.name!r} returns void: it must return "
                    "cudaGetLastError() so the wrapper can raise")
            if any(id(f) in vec16 for f in reached):
                host = unit.reach(fn, host_only=True)
                if not any(_ALIGN_TEST_RE.search(f.text()) for f in host):
                    yield self.finding(
                        src.module, fn.line(), "cuda-vector-alignment",
                        f"launcher {fn.name!r} reaches a 16-byte access "
                        "(float4/uint4 or a bulk copy) but tests no "
                        "pointer's alignment: refuse a misaligned pointer "
                        "(reinterpret_cast<uintptr_t>(p) % 16) instead of "
                        "faulting on the card")

    def _check_index(self, src: CudaSource) -> Iterable[Finding]:
        for fn in src.functions:
            if not fn.is_global:
                continue
            kinds = _int_kinds(fn)
            ptrs = _pointers(fn)
            body = fn.text()
            for off, expr in _offset_exprs(body, ptrs):
                if _expr_kind(expr, kinds)[1]:
                    yield self.finding(
                        src.module, src.line_of(fn.body[0] + off),
                        "cuda-int-index",
                        f"offset {' '.join(expr.split())!r} multiplies two "
                        "32-bit ints before any size_t cast: it wraps past "
                        "2^31 elements — cast the first factor, "
                        "(size_t)a * b")

    def _check_smem(self, src: CudaSource) -> Iterable[Finding]:
        for fn in src.functions:
            if fn.is_global:
                nbytes = _shared_bytes(fn)
                if nbytes is not None and nbytes > STATIC_SMEM_BYTES:
                    yield self.finding(
                        src.module, fn.line(), "cuda-smem-budget",
                        f"kernel {fn.name!r} declares {nbytes} bytes of "
                        f"__shared__ arrays, above the "
                        f"{STATIC_SMEM_BYTES // 1024} KiB a block gets "
                        "statically — use dynamic shared memory and "
                        "cudaFuncSetAttribute")
        for l in _launches(src):
            if len(l.config) >= 3 and re.match(r"^\d+$", l.config[2]) \
                    and int(l.config[2]) > BLOCK_SMEM_BYTES:
                yield self.finding(
                    src.module, src.line_of(l.offset), "cuda-smem-budget",
                    f"{l.kernel}<<<...>>> asks for {l.config[2]} bytes of "
                    f"dynamic shared memory, above the H100's "
                    f"{BLOCK_SMEM_BYTES // 1024} KiB a block")

    def _check_fallback(self, module: Module) -> Iterable[Finding]:
        if is_test_path(module.path) or not re.search(
                r"(^|[/\\])repro_torch[/\\]", module.path):
            return
        modules, funcs = _ref_names(module.tree)
        if not modules and not funcs:
            return
        for handler in ast.walk(module.tree):
            if not isinstance(handler, ast.ExceptHandler):
                continue
            for node in ast.walk(ast.Module(body=handler.body,
                                            type_ignores=[])):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node) or ""
                head = name.rsplit(".", 1)[0] if "." in name else ""
                if name in funcs or head in modules \
                        or ".ref." in f".{name}":
                    yield self.finding(
                        module, node, "kernel-fallback",
                        f"{name}() in an except body falls back to the "
                        "plain version when the kernel fails: a CUDA tensor "
                        "gets its kernel or an error, so a broken build or "
                        "launch cannot pass unseen")
