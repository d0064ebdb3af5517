"""Runtime DSL compiler: a textual prob-model language → staged models.

The port of ``fugue_tpu/dsl/compiler.py``. The tokenizer, the AST classes
and the recursive-descent ``Parser`` are the JAX package's, unchanged: the
same grammar, the same addresses and the same ``DSLError``s. The evaluator
folds a program into an ordinary effectful model closure over the port's
``core.distributions`` and ``core.model``, so a compiled program stages like
any hand-written model and runs through every engine.

Surface syntax (one statement per ``;`` or newline)::

    let mu <- sample("mu", normal(0.0, 2.0));
    let s  <- sample("s", lognormal(0.0, 1.0));
    for i in 0..n {
        observe(("y", i), normal(mu, s), data[i]);
    }
    factor(0.0);
    return mu

- 17 distribution constructors by lowercase name (normal, uniform,
  lognormal, exponential, bernoulli, categorical, beta, gamma, binomial,
  poisson, studentt, cauchy, laplace, weibull, chisquared, inversegamma,
  discreteuniform), and halfnormal, halfcauchy, geometric,
  negativebinomial and bernoulli_logits;
- addresses: a string literal, or a tuple ``("name", i)`` → ``name#i``;
- the data environment binds free identifiers (scalars, arrays) at build
  time; ``x[i]`` indexes arrays;
- builtins: exp, log, sqrt, abs, pow, min, max, len, sum, mean, logaddexp.

Where tensors differ from JAX arrays:

- ``build(data, device=...)`` places every data array on the model's
  device: float arrays in ``settings.real_dtype()``, integer arrays in
  ``settings.int_dtype()``, boolean arrays as ``torch.bool``.
- The builtins take Python numbers (``exp(0.0)``) by making them tensors
  on the device first; ``exp``, ``log``, ``sqrt`` and ``mean`` of an integer
  array give a real result, as their ``jnp`` counterparts do.
- An index is clamped into range, as JAX clamps it (a negative index counts
  from the end first): on the card an out-of-range index would otherwise
  fire a device-side assert, and a sampled discrete site used as an index,
  ``mu[z]``, is not checked on the host.
- An address index that is not a concrete integer (``int()`` of a tensor
  batched by ``torch.func.vmap`` raises ``RuntimeError`` where JAX raises
  ``TypeError``) is the same ``DSLError``, "address index must be a
  concrete integer".
- A soft runtime error is collected once per message until
  ``take_warnings()`` drains it. JAX's jit cache replays a traced program
  without Python, so it records a warning once per trace; the port replays
  the model in Python on every batched evaluation.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import settings
from ..core import distributions as dist_mod
from ..core.address import addr
from ..core.model import factor, observe, sample
from ..errors import ErrorCode, FugueError


class DSLError(FugueError):
    """Parse/compile error in a DSL program."""


def _err(msg: str, **ctx) -> DSLError:
    return DSLError(ErrorCode.NOT_STAGEABLE, msg, ctx)


DISTRIBUTIONS = {
    "normal": dist_mod.Normal,
    "uniform": dist_mod.Uniform,
    "lognormal": dist_mod.LogNormal,
    "exponential": dist_mod.Exponential,
    "bernoulli": dist_mod.Bernoulli,
    "categorical": lambda *a: dist_mod.Categorical(probs=a[0]),
    "beta": dist_mod.Beta,
    "gamma": dist_mod.Gamma,
    "binomial": dist_mod.Binomial,
    "poisson": dist_mod.Poisson,
    "studentt": dist_mod.StudentT,
    "cauchy": dist_mod.Cauchy,
    "laplace": dist_mod.Laplace,
    "weibull": dist_mod.Weibull,
    "chisquared": dist_mod.ChiSquared,
    "inversegamma": dist_mod.InverseGamma,
    "discreteuniform": dist_mod.DiscreteUniform,
    # beyond-parity extras (core.distributions EXTRA_DISTRIBUTIONS)
    "halfnormal": dist_mod.HalfNormal,
    "halfcauchy": dist_mod.HalfCauchy,
    "geometric": dist_mod.Geometric,
    "negativebinomial": dist_mod.NegativeBinomial,
    "bernoulli_logits": dist_mod.BernoulliLogits,
}


def as_data(v, device):
    """A data value as the model sees it: lists, tuples and numpy arrays
    become tensors on ``device`` (float → ``settings.real_dtype()``, integer
    → ``settings.int_dtype()``, bool → ``torch.bool``); other values (Python
    numbers, tensors) stay as they are."""
    if not isinstance(v, (list, tuple, np.ndarray)):
        return v
    a = np.asarray(v)
    if a.dtype.kind == "b":
        dtype = torch.bool
    elif a.dtype.kind in "iu":
        dtype = settings.int_dtype()
    else:
        dtype = settings.real_dtype()
    return torch.as_tensor(a, dtype=dtype, device=device)


def builtins(device) -> Dict[str, Callable]:
    """The DSL's builtin functions for a model on ``device``."""

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, bool):
            dtype = torch.bool
        elif isinstance(x, int):
            dtype = settings.int_dtype()
        else:
            dtype = settings.real_dtype()
        return torch.full((), x, dtype=dtype, device=device)  # a fill, no copy

    def real(x):
        x = tensor(x)
        return x if x.is_floating_point() else x.to(settings.real_dtype())

    return {
        "exp": lambda x: torch.exp(real(x)),
        "log": lambda x: torch.log(real(x)),
        "sqrt": lambda x: torch.sqrt(real(x)),
        "abs": lambda x: torch.abs(tensor(x)),
        "pow": lambda x, y: torch.pow(tensor(x), tensor(y)),
        "min": lambda x, y: torch.minimum(tensor(x), tensor(y)),
        "max": lambda x, y: torch.maximum(tensor(x), tensor(y)),
        "len": lambda x: tensor(x).shape[0],
        "sum": lambda x: torch.sum(tensor(x)),
        "mean": lambda x: torch.mean(real(x)),
        "logaddexp": lambda x, y: torch.logaddexp(real(x), real(y)),
    }


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<num>\d+\.(?!\.)\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<arrow><-)
  | (?P<range>\.\.)
  | (?P<op>==|!=|<=|>=|[-+*/%(){}\[\],;<>=])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str
    value: str
    pos: int


def tokenize(src: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise _err(f"unexpected character {src[i]!r}", position=i)
        kind = m.lastgroup
        if kind != "ws":
            out.append(Token(kind, m.group(), i))
        i = m.end()
    out.append(Token("eof", "", len(src)))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Num:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Var:
    name: str


@dataclass
class BinOp:
    op: str
    left: Any
    right: Any


@dataclass
class Neg:
    operand: Any


@dataclass
class Call:
    name: str
    args: List[Any]


@dataclass
class Index:
    base: Any
    index: Any


@dataclass
class AddrExpr:
    name: str
    indices: List[Any] = field(default_factory=list)


@dataclass
class DistExpr:
    name: str
    args: List[Any]


@dataclass
class LetSample:
    var: str
    address: AddrExpr
    dist: DistExpr


@dataclass
class LetPure:
    var: str
    expr: Any


@dataclass
class Observe:
    address: AddrExpr
    dist: DistExpr
    value: Any


@dataclass
class Factor:
    expr: Any


@dataclass
class For:
    var: str
    start: Any
    stop: Any
    body: List[Any]


@dataclass
class Return:
    expr: Any


# ---------------------------------------------------------------------------
# Parser (recursive descent)
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> Token:
        t = self.next()
        if t.value != value:
            raise _err(f"expected {value!r}, found {t.value!r}", position=t.pos)
        return t

    def accept(self, value: str) -> bool:
        if self.peek().value == value:
            self.next()
            return True
        return False

    # -- program ------------------------------------------------------------

    def parse_program(self) -> List[Any]:
        stmts: List[Any] = []
        while self.peek().kind != "eof":
            stmts.append(self.parse_stmt())
            self.accept(";")
        return stmts

    def parse_block(self) -> List[Any]:
        self.expect("{")
        body: List[Any] = []
        while self.peek().value != "}":
            body.append(self.parse_stmt())
            self.accept(";")
        self.expect("}")
        return body

    def parse_stmt(self) -> Any:
        t = self.peek()
        if t.value == "let":
            self.next()
            name = self.next()
            if name.kind != "ident":
                raise _err("expected identifier after let", position=name.pos)
            if self.accept("<-"):
                self.expect("sample")
                self.expect("(")
                address = self.parse_addr()
                self.expect(",")
                dist = self.parse_dist()
                self.expect(")")
                return LetSample(name.value, address, dist)
            self.expect("=")
            return LetPure(name.value, self.parse_expr())
        if t.value == "observe":
            self.next()
            self.expect("(")
            address = self.parse_addr()
            self.expect(",")
            dist = self.parse_dist()
            self.expect(",")
            value = self.parse_expr()
            self.expect(")")
            return Observe(address, dist, value)
        if t.value == "factor":
            self.next()
            self.expect("(")
            e = self.parse_expr()
            self.expect(")")
            return Factor(e)
        if t.value == "for":
            self.next()
            var = self.next()
            self.expect("in")
            start = self.parse_expr()
            self.expect("..")
            stop = self.parse_expr()
            body = self.parse_block()
            return For(var.value, start, stop, body)
        if t.value == "return":
            self.next()
            return Return(self.parse_expr())
        raise _err(f"unexpected token {t.value!r}", position=t.pos)

    def parse_addr(self) -> AddrExpr:
        t = self.peek()
        if t.kind == "str":
            self.next()
            return AddrExpr(name=t.value[1:-1])
        if t.value == "(":
            self.next()
            name = self.next()
            if name.kind != "str":
                raise _err("address tuple must start with a string", position=name.pos)
            indices = []
            while self.accept(","):
                indices.append(self.parse_expr())
            self.expect(")")
            return AddrExpr(name=name.value[1:-1], indices=indices)
        raise _err("expected address (string or tuple)", position=t.pos)

    def parse_dist(self) -> DistExpr:
        t = self.next()
        name = t.value.lower()
        if name not in DISTRIBUTIONS:
            raise _err(f"unknown distribution {t.value!r}", position=t.pos)
        self.expect("(")
        args = []
        if self.peek().value != ")":
            args.append(self.parse_expr())
            while self.accept(","):
                args.append(self.parse_expr())
        self.expect(")")
        return DistExpr(name, args)

    # -- expressions (precedence climbing) ----------------------------------

    def parse_expr(self) -> Any:
        return self.parse_cmp()

    def parse_cmp(self) -> Any:
        left = self.parse_add()
        while self.peek().value in ("<", ">", "<=", ">=", "==", "!="):
            op = self.next().value
            left = BinOp(op, left, self.parse_add())
        return left

    def parse_add(self) -> Any:
        left = self.parse_mul()
        while self.peek().value in ("+", "-"):
            op = self.next().value
            left = BinOp(op, left, self.parse_mul())
        return left

    def parse_mul(self) -> Any:
        left = self.parse_unary()
        while self.peek().value in ("*", "/", "%"):
            op = self.next().value
            left = BinOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> Any:
        if self.accept("-"):
            return Neg(self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Any:
        e = self.parse_atom()
        while self.peek().value == "[":
            self.next()
            idx = self.parse_expr()
            self.expect("]")
            e = Index(e, idx)
        return e

    def parse_atom(self) -> Any:
        t = self.next()
        if t.kind == "num":
            return Num(float(t.value))
        if t.kind == "str":
            return Str(t.value[1:-1])
        if t.value == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.kind == "ident":
            if self.peek().value == "(":
                self.next()
                args = []
                if self.peek().value != ")":
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                self.expect(")")
                return Call(t.value, args)
            return Var(t.value)
        raise _err(f"unexpected token {t.value!r} in expression", position=t.pos)


# ---------------------------------------------------------------------------
# Evaluator → effectful model closure
# ---------------------------------------------------------------------------


def _index(base, idx, device):
    """``base[idx]`` with JAX's index rule: a negative index counts from the
    end, then the index is clamped into [0, len - 1]. Python numbers and
    integer tensors (a sampled discrete site) index alike; a real tensor is
    no index (JAX raises ``TypeError``)."""
    base = base if isinstance(base, torch.Tensor) else torch.as_tensor(base, device=device)
    n = base.shape[0] if base.dim() else 0
    if not isinstance(idx, torch.Tensor):
        i = int(idx)
        return base[min(max(i + n if i < 0 else i, 0), n - 1)]
    if idx.is_floating_point() or idx.is_complex():
        raise TypeError(f"Indexer must have integer or boolean type, got indexer with type "
                        f"{idx.dtype}")
    if idx.dtype == torch.bool:
        return base[idx]
    idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return base[idx]


class CompiledModel:
    """A compiled DSL program.

    ``compile(source)`` parses once; ``build(data, device=...)`` binds the
    data environment on ``device`` and returns a model closure for ``stage``
    or any engine. Soft runtime errors during execution degrade the trace to
    ``factor(-inf)`` plus a collected warning; ``take_warnings()`` drains
    them.
    """

    def __init__(self, stmts: List[Any], source: str):
        self.stmts = stmts
        self.source = source
        self._warnings: List[str] = []

    @staticmethod
    def compile(source: str) -> "CompiledModel":
        return CompiledModel(Parser(tokenize(source)).parse_program(), source)

    def take_warnings(self) -> List[str]:
        out = self._warnings
        self._warnings = []
        return out

    def _warn(self, message: str) -> None:
        if message not in self._warnings:  # once until drained
            self._warnings.append(message)

    def build(self, data: Optional[Dict[str, Any]] = None, *, device="cuda"):
        """Bind the data environment, its arrays on ``device`` → model
        closure. Stage it on the same device."""
        device = torch.device(device)
        base_env: Dict[str, Any] = dict(builtins(device))
        for k, v in (data or {}).items():
            base_env[k] = as_data(v, device)

        def model():
            env = dict(base_env)
            result = None
            try:
                for stmt in self.stmts:
                    result = self._exec(stmt, env, device)
                    if isinstance(stmt, Return):
                        break
            except DSLError as e:
                # DSL-level runtime failures (unbound names, bad indices)
                # degrade softly
                self._warn(f"runtime error: {e}")
                factor(-math.inf)
            except FugueError:
                raise  # model-structure errors (duplicate address, ...) stay hard
            except Exception as e:  # other soft errors → -inf weight + warning
                self._warn(f"runtime error: {type(e).__name__}: {e}")
                factor(-math.inf)
            return result

        return model

    # -- execution ----------------------------------------------------------

    def _exec(self, stmt, env, device):
        if isinstance(stmt, LetSample):
            a = self._eval_addr(stmt.address, env, device)
            d = self._eval_dist(stmt.dist, env, device)
            env[stmt.var] = sample(a, d)
            return None
        if isinstance(stmt, LetPure):
            env[stmt.var] = self._eval(stmt.expr, env, device)
            return None
        if isinstance(stmt, Observe):
            a = self._eval_addr(stmt.address, env, device)
            d = self._eval_dist(stmt.dist, env, device)
            v = self._eval(stmt.value, env, device)
            if d.support.kind == "boolean":
                v = (v.to(torch.bool) if isinstance(v, torch.Tensor)
                     else torch.full((), bool(v), dtype=torch.bool, device=device))
            observe(a, d, v)
            return None
        if isinstance(stmt, Factor):
            factor(self._eval(stmt.expr, env, device))
            return None
        if isinstance(stmt, For):
            start = int(self._eval(stmt.start, env, device))
            stop = int(self._eval(stmt.stop, env, device))
            result = None
            for i in range(start, stop):
                env[stmt.var] = i
                for s in stmt.body:
                    result = self._exec(s, env, device)
            return result
        if isinstance(stmt, Return):
            return self._eval(stmt.expr, env, device)
        raise _err(f"unknown statement {stmt!r}")

    def _eval_addr(self, a: AddrExpr, env, device) -> str:
        indices = [self._eval(i, env, device) for i in a.indices]
        idx = []
        for v in indices:
            try:
                idx.append(int(v))
            except (TypeError, RuntimeError):  # RuntimeError: a vmap-batched tensor
                raise _err("address index must be a concrete integer")
        return addr(a.name, *idx)

    def _eval_dist(self, d: DistExpr, env, device):
        args = [self._eval(a, env, device) for a in d.args]
        return DISTRIBUTIONS[d.name](*args)

    def _eval(self, e, env, device):
        if isinstance(e, Num):
            return e.value
        if isinstance(e, Str):
            return e.value
        if isinstance(e, Var):
            if e.name not in env:
                raise _err(f"unbound identifier {e.name!r}")
            return env[e.name]
        if isinstance(e, Neg):
            return -self._eval(e.operand, env, device)
        if isinstance(e, BinOp):
            l = self._eval(e.left, env, device)
            r = self._eval(e.right, env, device)
            if e.op == "+":
                return l + r
            if e.op == "-":
                return l - r
            if e.op == "*":
                return l * r
            if e.op == "/":
                return l / r
            if e.op == "%":
                return l % r
            if e.op == "<":
                return l < r
            if e.op == ">":
                return l > r
            if e.op == "<=":
                return l <= r
            if e.op == ">=":
                return l >= r
            if e.op == "==":
                return l == r
            if e.op == "!=":
                return l != r
        if isinstance(e, Call):
            if e.name not in env or not callable(env[e.name]):
                raise _err(f"unknown function {e.name!r}")
            return env[e.name](*[self._eval(a, env, device) for a in e.args])
        if isinstance(e, Index):
            return _index(self._eval(e.base, env, device), self._eval(e.index, env, device),
                          device)
        raise _err(f"unknown expression {e!r}")


def compile_model(source: str) -> CompiledModel:
    """Module-level convenience: ``CompiledModel.compile(source)``."""
    return CompiledModel.compile(source)
