"""torch.autograd.Function contract checker (the port's custom VJPs).

The reference's ``jax.custom_vjp`` primals become ``autograd.Function``
subclasses in the port (``core/correction.py``, ``core/compressors.py``).
For every class in a module whose bases name ``Function``
(``torch.autograd.Function``, ``autograd.Function``):

  * ``forward`` and ``backward`` (and ``setup_context``, where present)
    are ``@staticmethod``s — autograd calls them on the class;
  * ``backward`` exists — without it the first backward pass raises;
  * ``backward`` takes ``ctx`` plus one gradient per output of
    ``forward``, where every ``return`` of ``forward`` is a literal tuple
    (a single non-tuple output takes one gradient);
  * every literal tuple ``backward`` returns has one entry per input of
    ``forward`` after ``ctx`` (all of forward's parameters, where the
    class has a ``setup_context``), ``None`` for the inputs that take no
    gradient.

Arity is checked only where it is statically decidable (no ``*args``,
no starred tuple entries). That integer and bool inputs get ``None`` is a
runtime property: ``repro_torch.lint.dispatch.integer_gradient_violations``
checks it by running the real backward (used in tests).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                                   dotted_name)


def _is_function_class(cls: ast.ClassDef) -> bool:
    return any((dotted_name(b) or "").split(".")[-1] == "Function"
               for b in cls.bases)


def _is_staticmethod(fn) -> bool:
    return any(dotted_name(d) in ("staticmethod", "builtins.staticmethod")
               for d in fn.decorator_list)


def _n_params(fn) -> Optional[int]:
    if fn.args.vararg or fn.args.kwarg:
        return None
    return len(fn.args.posonlyargs) + len(fn.args.args) \
        + len(fn.args.kwonlyargs)


def _tuple_returns(fn) -> List[Tuple[ast.Return, Optional[int]]]:
    """(return node, tuple length or None where starred) for every literal
    tuple return in ``fn`` (not descending into nested defs)."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple):
            starred = any(isinstance(e, ast.Starred)
                          for e in node.value.elts)
            out.append((node, None if starred else len(node.value.elts)))
        stack.extend(ast.iter_child_nodes(node))
    return out


def _returns(fn) -> List[ast.Return]:
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _n_outputs(forward) -> Optional[int]:
    """forward's output count where every return agrees on it: a literal
    tuple's length, or 1 for a value that is not a tuple, a name or a
    call (either could be a tuple)."""
    counts = set()
    for ret in _returns(forward):
        v = ret.value
        if isinstance(v, ast.Tuple):
            if any(isinstance(e, ast.Starred) for e in v.elts):
                return None
            counts.add(len(v.elts))
        elif v is None or isinstance(v, (ast.Name, ast.Call, ast.IfExp,
                                         ast.Subscript, ast.Attribute)):
            return None
        else:
            counts.add(1)
    return counts.pop() if len(counts) == 1 else None


class AutogradFunctionPass(LintPass):
    name = "autograd-function"
    rules = {
        "autograd-staticmethod":
            "autograd.Function forward/backward/setup_context is not a "
            "@staticmethod",
        "autograd-missing-backward":
            "autograd.Function subclass without a backward",
        "autograd-bwd-arity":
            "autograd.Function backward does not take ctx plus one "
            "gradient per forward output",
        "autograd-bwd-return-arity":
            "autograd.Function backward must return one entry per forward "
            "input (None where the input takes no gradient)",
    }

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef) \
                    or not _is_function_class(cls):
                continue
            methods = {n.name: n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            forward = methods.get("forward")
            backward = methods.get("backward")
            for name in ("forward", "backward", "setup_context"):
                fn = methods.get(name)
                if fn is not None and not _is_staticmethod(fn):
                    yield self.finding(
                        module, fn, "autograd-staticmethod",
                        f"{cls.name}.{name} is not a @staticmethod: "
                        "autograd calls it on the class, so ctx lands in "
                        "self's place and every argument shifts by one")
            if forward is None:
                continue        # a base class of other Functions
            if backward is None:
                yield self.finding(
                    module, cls, "autograd-missing-backward",
                    f"autograd.Function {cls.name!r} has a forward and no "
                    "backward — differentiating it raises")
                continue
            n_out = _n_outputs(forward)
            n_bwd = _n_params(backward)
            if n_out is not None and n_bwd is not None \
                    and n_bwd != n_out + 1:
                yield self.finding(
                    module, backward, "autograd-bwd-arity",
                    f"{cls.name}.backward takes {n_bwd} parameters; "
                    f"forward returns {n_out} output(s), so it must take "
                    f"ctx plus {n_out} gradient(s)")
            n_fwd = _n_params(forward)
            if n_fwd is None:
                continue
            n_in = n_fwd if "setup_context" in methods else n_fwd - 1
            for ret, n in _tuple_returns(backward):
                if n is not None and n != n_in:
                    yield self.finding(
                        module, ret, "autograd-bwd-return-arity",
                        f"{cls.name}.backward returns {n} gradient(s) but "
                        f"forward takes {n_in} input(s) after ctx — one "
                        "entry per input, None where it takes no gradient")
