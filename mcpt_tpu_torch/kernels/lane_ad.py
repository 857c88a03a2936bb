"""Reverse mode of per-lane float32 programs, written once and run two ways:
as PyTorch ops over all lanes (the backward kernels' plain versions) and as
CUDA C++ for one lane a thread (the body of `csrc/wavefront_bwd.cu`).

A program is traced from the plain version's own forward code: the functions
of `wavefront_ref` (and the BSDF, env and light functions they call) run on
`Val`s, which record every torch function and operator as an `Op` on a
`Tape` (`__torch_function__`). `reverse` appends the adjoint of each op, last
op first, with the rules of PyTorch's autograd formulas (derivatives.yaml):
the subgradient of `clamp` (1 inside the closed interval), `abs` (sign, 0 at
0), `maximum` (half each on a tie), `where` (the taken branch only), float64
`sqrt` rounded once, and so on; a value used several times sums its adjoints
in the order the reverse sweep meets them. `replay` runs a tape with torch
tensors (each op the very torch call the forward made), `cuda_body` prints it
as C++ statements with PyTorch's CUDA semantics (a Python-scalar divisor is a
multiplication by its float reciprocal, torch's NaN rules for clamp and
maximum), so that the kernel and its plain version round alike, bit for bit,
when nvcc builds it with `-fmad=false` and no fast math.

Kinds of value: "f" float32, "b" bool, "i" int64 (per lane); "pf" and "pi"
scalar parameters, float and int, which torch sees as Python numbers; "f64"
only between the two casts of the float64 sqrt.
"""

import math
import operator
from typing import NamedTuple

import numpy as np
import torch

_LANE = ("f", "b", "i")


class Table:
    """A table a program reads rows of with `torch.take` (the env map): its
    name in the C++ code."""

    def __init__(self, name: str):
        self.name = name

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return Val.__torch_function__(func, types, args, kwargs)


class Op(NamedTuple):
    out: int  # the value's id
    name: str
    args: tuple  # Val, Python number or Table each
    kind: str


class Tape:
    """Ops in the order they ran; `inputs[name]` and `params[name]` are the
    program's free values."""

    def __init__(self):
        self.ops = []
        self.inputs = {}
        self.params = {}
        self.n = 0

    def _new(self, kind):
        v = Val(self, self.n, kind)
        self.n += 1
        return v

    def input(self, name, kind="f"):
        v = self._new(kind)
        self.inputs[name] = v
        return v

    def param(self, name, kind="pf"):
        v = self._new(kind)
        self.params[name] = v
        return v

    def op(self, name, args, kind):
        v = self._new(kind)
        self.ops.append(Op(v.id, name, tuple(args), kind))
        return v


def _kind(x):
    if isinstance(x, Val):
        return x.kind
    if isinstance(x, bool):
        return "cb"
    return "ci" if isinstance(x, int) else "cf"


def _arith_kind(a, b):
    ka, kb = _kind(a), _kind(b)
    if "f64" in (ka, kb):
        raise NotImplementedError("float64 arithmetic beyond the sqrt casts")
    if "f" in (ka, kb):
        return "f"
    if "i" in (ka, kb):
        if "cf" in (ka, kb) or "pf" in (ka, kb):
            return "f"
        return "i"
    return "pf" if "pf" in (ka, kb) or "cf" in (ka, kb) else "pi"


def _tape(*xs):
    for x in xs:
        if isinstance(x, Val):
            return x.tape
    raise TypeError("no traced value among the arguments")


_TORCH = {
    torch.abs: "abs", torch.cos: "cos", torch.sin: "sin", torch.acos: "acos",
    torch.floor: "floor", torch.trunc: "trunc",
}


class Val:
    """A traced value (see the module docstring for its kinds)."""

    __slots__ = ("tape", "id", "kind")

    def __init__(self, tape, id_, kind):
        self.tape, self.id, self.kind = tape, id_, kind

    __hash__ = object.__hash__

    def __bool__(self):
        raise TypeError("a traced value has no truth value: use torch.where")

    def _bin(self, name, other, swap=False):
        a, b = (other, self) if swap else (self, other)
        if name in ("lt", "le", "gt", "ge", "eq", "ne", "and", "or"):
            return self.tape.op(name, (a, b), "b")
        return self.tape.op(name, (a, b), _arith_kind(a, b))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __eq__(self, o): return self._bin("eq", o)  # noqa: E704
    def __ne__(self, o): return self._bin("ne", o)  # noqa: E704
    def __and__(self, o): return self._bin("and", o)
    def __or__(self, o): return self._bin("or", o)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        # torch's Tensor.__rtruediv__: self.reciprocal() * other
        return self.tape.op("recip", (self,), "f") * o

    def __neg__(self):
        return self.tape.op("neg", (self,), self.kind)

    def __invert__(self):
        return self.tape.op("not", (self,), "b")

    def to(self, dtype):
        if dtype == torch.float64 and self.kind == "f":
            return Val(self.tape, self.id, "f64")  # exact: the same value
        if dtype == torch.float32 and self.kind == "f64s":
            return self.tape.op("sqrt32", (Val(self.tape, self.id, "f"),), "f")
        if dtype == torch.int64 and self.kind == "f":
            return self.tape.op("to_i", (self,), "i")
        raise NotImplementedError(f"to({dtype}) of a {self.kind} value")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tape = _tape(*args, *kwargs.values())
        if func is torch.sqrt and args[0].kind == "f64":
            return Val(tape, args[0].id, "f64s")  # only `.to(float32)` may follow
        if func in _TORCH:
            (x,) = args
            return tape.op(_TORCH[func], (x,), x.kind)
        if func is torch.where:
            c, a, b = args
            ka, kb = _kind(a), _kind(b)
            kind = "b" if "b" in (ka, kb) or "cb" in (ka, kb) else (
                "i" if "i" in (ka, kb) and "f" not in (ka, kb) else "f")
            return tape.op("where", (c, a, b), kind)
        if func is torch.clamp:
            x = args[0]
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            return tape.op("clamp", (x, lo, hi), x.kind)
        if func is torch.clamp_min:
            return tape.op("clamp_min", (args[0], args[1]), args[0].kind)
        if func is torch.maximum:
            return tape.op("maximum", args, "f")
        if func is torch.atan2:
            return tape.op("atan2", args, "f")
        if func is torch.remainder:
            return tape.op("rem", args, "i")
        if func is torch.take:
            return tape.op("take", args, "f")
        if func in (torch.full_like, torch.zeros_like):
            like = args[0]
            value = 0 if func is torch.zeros_like else args[1]
            return tape.op("full", (value,), like.kind if like.kind in _LANE else "f")
        raise NotImplementedError(f"no trace of {getattr(func, '__name__', func)}")


# ---------------------------------------------------------------------------
# Reverse mode
# ---------------------------------------------------------------------------


def _is_f(x):
    return isinstance(x, Val) and x.kind == "f"


def reverse(tape, seeds):
    """Append to `tape` the adjoint of its ops for the output seeds `seeds`,
    a list of (output Val, seed Val) taken in order. Returns {input name:
    adjoint Val} for the float inputs that receive one."""
    n_fwd = len(tape.ops)
    adj = {}

    def acc(x, g):
        if not _is_f(x):
            return
        adj[x.id] = g if x.id not in adj else adj[x.id] + g

    for out, seed in seeds:
        acc(out, seed)
    for op in reversed(tape.ops[:n_fwd]):
        g = adj.get(op.out)
        if g is None or op.kind != "f":
            continue
        a = op.args
        name = op.name
        if name == "add":
            acc(a[0], g)
            acc(a[1], g)
        elif name == "sub":
            acc(a[0], g)
            acc(a[1], -g)
        elif name == "mul":
            acc(a[0], g * a[1])
            acc(a[1], g * a[0])
        elif name == "div":
            acc(a[0], g / a[1])
            if _is_f(a[1]):
                acc(a[1], -g * ((a[0] / a[1]) / a[1]))
        elif name == "recip":
            r = Val(tape, op.out, "f")
            acc(a[0], -g * (r * r))
        elif name == "neg":
            acc(a[0], -g)
        elif name == "where":
            acc(a[1], torch.where(a[0], g, 0.0))
            acc(a[2], torch.where(a[0], 0.0, g))
        elif name == "clamp":
            x, lo, hi = a
            inside = None
            for m in ([] if lo is None else [x >= lo]) + ([] if hi is None else [x <= hi]):
                inside = m if inside is None else inside & m
            acc(x, torch.where(inside, g, 0.0))
        elif name == "clamp_min":
            acc(a[0], torch.where(a[0] >= a[1], g, 0.0))
        elif name == "maximum":
            x, y = a
            h = torch.where(x == y, g / 2.0, g)
            acc(x, torch.where(x < y, 0.0, h))
            acc(y, torch.where(x > y, 0.0, h))
        elif name == "abs":
            acc(a[0], g * tape.op("sign", (a[0],), "f"))
        elif name == "cos":
            acc(a[0], g * -torch.sin(a[0]))
        elif name == "sin":
            acc(a[0], g * torch.cos(a[0]))
        elif name == "atan2":
            y, x = a
            r = tape.op("recip", (y * y + x * x,), "f")
            acc(y, g * x * r)
            acc(x, g * -y * r)
        elif name == "acos":
            s = tape.op("sqrt32", (-a[0] * a[0] + 1.0,), "f")
            acc(a[0], g * -tape.op("recip", (s,), "f"))
        elif name == "sqrt32":
            acc(a[0], tape.op("dsqrt", (g, a[0]), "f"))
        elif name in ("floor", "trunc", "full", "take"):
            pass
        else:
            raise NotImplementedError(f"no adjoint of {name}")
    return {n: adj[v.id] for n, v in tape.inputs.items() if v.id in adj}


def live_ops(tape, wanted):
    """The ops that the values `wanted` depend on, in tape order."""
    need = {v.id for v in wanted}
    keep = []
    for op in reversed(tape.ops):
        if op.out in need:
            keep.append(op)
            need.update(x.id for x in op.args if isinstance(x, Val))
    return keep[::-1]


# ---------------------------------------------------------------------------
# The plain version: the tape's ops as torch calls
# ---------------------------------------------------------------------------

_BIN = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul, "div": operator.truediv,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "eq": operator.eq, "ne": operator.ne, "and": operator.and_, "or": operator.or_,
}
_UN = {
    "abs": torch.abs, "cos": torch.cos, "sin": torch.sin, "acos": torch.acos,
    "floor": torch.floor, "trunc": torch.trunc, "recip": torch.reciprocal,
    "sign": torch.sign, "neg": operator.neg, "not": operator.invert,
}
_DTYPE = {"f": torch.float32, "b": torch.bool, "i": torch.int64}


def replay(ops, env, like, tables=None):
    """Run `ops` with torch: `env` maps value ids to tensors (lanes) or
    Python numbers (parameters) and receives every result; `like`, a float
    tensor of the lanes' shape, shapes the constants; `tables` maps a
    Table's name to its tensor."""

    def get(x):
        if isinstance(x, Val):
            return env[x.id]
        if isinstance(x, Table):
            return tables[x.name]
        return x

    for op in ops:
        a = [get(x) for x in op.args]
        n = op.name
        if n in _BIN:
            r = _BIN[n](a[0], a[1])
        elif n in _UN:
            r = _UN[n](a[0])
        elif n == "where":
            r = torch.where(*a)
        elif n == "clamp":
            r = torch.clamp(a[0], a[1], a[2])
        elif n == "clamp_min":
            r = torch.clamp_min(a[0], a[1])
        elif n == "maximum":
            r = torch.maximum(a[0], a[1])
        elif n == "atan2":
            r = torch.atan2(a[0], a[1])
        elif n == "sqrt32":
            r = torch.sqrt(a[0].to(torch.float64)).to(torch.float32)
        elif n == "dsqrt":
            r = (a[0].to(torch.float64) / (2 * torch.sqrt(a[1].to(torch.float64)))).to(
                torch.float32)
        elif n == "to_i":
            r = a[0].to(torch.int64)
        elif n == "rem":
            r = torch.remainder(a[0], a[1])
        elif n == "take":
            r = torch.take(a[0], a[1])
        elif n == "full":
            r = torch.full_like(like, a[0], dtype=_DTYPE[op.kind])
        else:
            raise NotImplementedError(n)
        env[op.out] = r
    return env


# ---------------------------------------------------------------------------
# The kernel: the tape's ops as CUDA C++
# ---------------------------------------------------------------------------

CTYPE = {"f": "float", "b": "bool", "i": "long long", "pf": "double", "pi": "long long"}
_COP = {"add": "+", "sub": "-", "mul": "*", "lt": "<", "le": "<=", "gt": ">", "ge": ">=",
        "eq": "==", "ne": "!=", "and": "&&", "or": "||"}
_CFN = {"abs": "fabsf", "cos": "cosf", "sin": "sinf", "acos": "acosf", "floor": "floorf",
        "trunc": "truncf", "sqrt32": "sqrtf", "atan2": "atan2f"}


def f32_literal(x) -> str:
    """A float's float32 rounding as an exact C++ literal."""
    v = float(np.float32(x))
    if math.isinf(v):
        return "INFINITY" if v > 0 else "-INFINITY"
    return f"{v.hex()}f"


def spill_slots(segments, reach=32):
    """Where the values of a function body go: `segments` lists its ops in
    order, each segment a list of ops or a set of value ids read at that
    point. A value read more than `reach` ops after it is made lives in a
    per-thread array (slots reused once their value is dead) instead of a
    register: a reverse mode keeps its forward's values until their
    adjoints, and thousands of long-lived registers stall ptxas. Returns
    ({value id: C++ lvalue}, {C++ type: slots})."""
    made, last, kind, at = {}, {}, {}, 0
    for seg in segments:
        if isinstance(seg, (set, frozenset)):
            for i in seg:
                last[i] = at
            continue
        for op in seg:
            for x in op.args:
                if isinstance(x, Val):
                    last[x.id] = at
            made[op.out], kind[op.out] = at, op.kind
            at += 1
    spill = sorted((i for i in made if last.get(i, made[i]) - made[i] > reach), key=made.get)
    free, where, n = {}, {}, {}
    ending = []  # (last use, type, slot), for reuse
    for i in spill:
        ct = CTYPE[kind[i]]
        ending.sort()
        while ending and ending[0][0] < made[i]:
            _, t, k = ending.pop(0)
            free.setdefault(t, []).append(k)
        pool = free.setdefault(ct, [])
        k = pool.pop() if pool else n.setdefault(ct, 0)
        if k == n.get(ct, 0):
            n[ct] = k + 1
        arr = {"float": "F", "bool": "B", "long long": "I"}[ct]
        where[i] = f"{arr}[{k}]"
        ending.append((last[i], ct, k))
    return where, n


def cuda_body(ops, names, spill=None):
    """C++ statements for `ops`, one `const` local a value, named `v<id>`,
    or a store to its slot in `spill` (`spill_slots`); `names` maps value
    ids of inputs and parameters to C++ expressions."""
    lines = []
    spill = spill or {}

    def ref(x, want="f"):
        if isinstance(x, Val):
            return names.get(x.id) or spill.get(x.id) or f"v{x.id}"
        if isinstance(x, Table):
            return names.get(x.name, x.name)
        if isinstance(x, bool):
            return "true" if x else "false"
        if want == "i" or (isinstance(x, int) and want not in ("f",)):
            return f"{int(x)}LL"
        return f32_literal(x)

    for op in ops:
        a = op.args
        n = op.name
        k = op.kind
        # the C++ type the operands meet in: float if any is float
        ks = [_kind(x) for x in a]
        fctx = "f" if any(q in ("f", "cf", "pf") for q in ks) else "i"
        if n in _COP:
            ctx = "f" if n in ("add", "sub", "mul") and k == "f" else fctx
            if n in ("and", "or"):
                ctx = "b"
            lhs, rhs = ref(a[0], ctx), ref(a[1], ctx)
            if ctx == "f":
                lhs = f"static_cast<float>({lhs})" if ks[0] in ("pi", "i", "ci") else lhs
                rhs = f"static_cast<float>({rhs})" if ks[1] in ("pi", "i", "ci") else rhs
            e = f"{lhs} {_COP[n]} {rhs}"
        elif n == "div":
            if _kind(a[1]) in ("f",):
                e = f"{ref(a[0])} / {ref(a[1])}"
            else:  # torch on CUDA: times the float reciprocal of a scalar divisor
                e = f"{ref(a[0])} * (1.0f / static_cast<float>({ref(a[1])}))"
        elif n == "recip":
            e = f"1.0f / {ref(a[0])}"
        elif n == "neg":
            e = f"-{ref(a[0], 'i' if k == 'i' else 'f')}"
        elif n == "not":
            e = f"!{ref(a[0])}"
        elif n in _CFN:
            e = f"{_CFN[n]}({', '.join(ref(x) for x in a)})"
        elif n == "sign":
            x = ref(a[0])
            e = f"({x} > 0.0f ? 1.0f : ({x} < 0.0f ? -1.0f : 0.0f))"
        elif n == "dsqrt":
            e = (f"static_cast<float>(static_cast<double>({ref(a[0])}) / "
                 f"(2.0 * sqrt(static_cast<double>({ref(a[1])}))))")
        elif n == "where":
            e = f"{ref(a[0])} ? {ref(a[1], k)} : {ref(a[2], k)}"
        elif n == "clamp" and k == "i":
            x = ref(a[0], "i")
            lo = "" if a[1] is None else ref(a[1], "i")
            hi = "" if a[2] is None else ref(a[2], "i")
            e = x
            if lo:
                e = f"max({e}, static_cast<long long>({lo}))"
            if hi:
                e = f"min({e}, static_cast<long long>({hi}))"
        elif n == "clamp":
            lo = "-INFINITY" if a[1] is None else ref(a[1])
            hi = "INFINITY" if a[2] is None else ref(a[2])
            e = f"ad_clamp({ref(a[0])}, {lo}, {hi})"
        elif n == "clamp_min":
            e = f"ad_clamp_min({ref(a[0])}, {ref(a[1])})"
        elif n == "maximum":
            e = f"ad_maximum({ref(a[0])}, {ref(a[1])})"
        elif n == "to_i":
            e = f"static_cast<long long>({ref(a[0])})"
        elif n == "rem":
            e = f"ad_rem({ref(a[0], 'i')}, static_cast<long long>({ref(a[1], 'i')}))"
        elif n == "take":
            e = f"ad_take({ref(a[0])}, {ref(a[1], 'i')})"
        elif n == "full":
            e = ref(a[0], k) if k != "b" else ("true" if a[0] else "false")
            if k == "f" and isinstance(a[0], Val):
                e = f"static_cast<float>({e})"
        else:
            raise NotImplementedError(n)
        if op.out in spill:
            lines.append(f"{spill[op.out]} = {e};")
        else:
            lines.append(f"const {CTYPE[k]} v{op.out} = {e};")
    return lines


def slot_arrays(n, opaque):
    """Declarations of `spill_slots`' arrays, reached through pointers
    offset by `opaque`, a zero the compiler cannot see (so it keeps them in
    memory rather than splitting them into registers)."""
    out = []
    for ct, arr in (("float", "F"), ("bool", "B"), ("long long", "I")):
        if n.get(ct):
            out.append(f"{ct} {arr.lower()}_slots[{n[ct]}];")
            out.append(f"{ct}* const {arr} = {arr.lower()}_slots + {opaque};")
    return out
