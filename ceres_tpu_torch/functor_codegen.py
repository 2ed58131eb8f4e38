"""The functor -> CUDA generator of kernel B1's generic instantiation.

Port of the role of `ceres_tpu/pallas_eval.py` `_scalar_full_jaxpr`
(:275-320) and `lane_eval` (:95-267): a cost functor written in PyTorch for
ONE residual block is traced once (`make_fx` over `functionalize`, on fake
[size]-shaped parameters and per-block data, down to aten), and every aten
op is scalarized on its tiny shapes into straight-line C++ that is generic
in two scalar types: T (a parameter-dependent value: `Jet<S, N>` in the
Jacobian instantiation, S in the residual-only one) and S (float or double:
data, constants and everything computed from them alone). The loss's `rho`
and each manifold's `plus_jacobian` are traced the same way, as functions
of S only. `csrc/eval_generic.cuh` is the hand-written kernel template the
emitted code plugs into.

What the lowering does, as `lane_eval` does on the TPU:
- every value is a numpy object array of scalar references of the
  tensor's shape; view, reshape, slice, select, stack, cat, scatter and
  index ops with constant indices only move references and emit nothing;
- an op whose inputs are all constants runs once, here, in PyTorch, and
  its result is a constant (e.g. the taps of a filter cast to the working
  dtype); creation ops (`zeros_like`, `eye`, ...) are constants too;
- every float constant a parameter-dependent op reads becomes one slot of
  a constant buffer passed to the kernel (JAX's `_pack_const`), in order of
  use, so functors that differ only in their constants (the K filters of a
  Fields-of-Experts prior) share one source and one build;
- `dot`, `mv`, `mm`, `bmm`, `addmm` and `linalg_cross` expand into
  multiply-adds (`_expand_dot_lane`, :74-92); reductions over dims sum in
  index order.
An op with no rule, data-dependent control flow (the fake trace cannot
guard on a value), integer data, data of rank > 2 or a float dtype other
than the working one raises `Ineligible`: the group then takes the
torch.func path, as `group_kernel` (:586-618) returns None. The decision
comes from the trace alone, the same on the CPU and on the card.

A functor that carries its own Jacobian rule (autodiff.RuleFunctor) is
never differentiated through its primal: an analytic rule becomes one node
of the trace (`rule_call`), lowered as the inlined custom_jvp rule of
JAX's lane interpreter runs (pallas_eval.py:47-57, 295): the rule's fn and
jac on the inputs' values in S, and per output a "rule" value whose
tangent is sum_k jac[:, k] x_k.v, also where the rule sits inside a larger
functor (a scaled or conditioned cost function); a numeric-diff rule
raises `Ineligible`, as group_kernel returns None for it.

`run_ir` evaluates the emitted IR in Python with the same dual-number rules
as the CUDA `Jet` (tests hold it against torch.func); it is never on the
solve's path.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch


class Ineligible(Exception):
    """The functor (or its loss or manifold) cannot be generated."""


# ---------------------------------------------------------------------- #
# functors with their own Jacobian rule (autodiff.RuleFunctor)
# ---------------------------------------------------------------------- #
# make_fx inlines an autograd.Function's forward, so a traced rule would
# look exactly like its primal. While `_trace` runs, a RuleFunctor called
# by the functor asks `generating()` and, for an analytic rule, calls
# `rule_call`: one node of the trace (the custom op below, whose fake
# version runs the primal for its shape), which `_Lowering.op_rule_call`
# lowers as the inlined custom_jvp rule of JAX's lane interpreter
# (pallas_eval._CALL_PRIMS): fn and jac on the inputs' values, then one
# "rule" value per output with tangent sum_k jac[:, k] x_k.v.

_GENERATING = [0]
_RULES: dict = {}  # id -> RuleFunctor, for the rule nodes of the traces being lowered
_RULE_OP = []


def generating() -> bool:
    """True while the generator traces a functor."""
    return _GENERATING[0] > 0


def _rule_op():
    """The custom op `ceres_tpu_torch::rule_call`, defined on first use."""
    if not _RULE_OP:

        @torch.library.custom_op("ceres_tpu_torch::rule_call", mutates_args=())
        def rule_call_op(args: list[torch.Tensor], key: int, k: int) -> torch.Tensor:
            rule = _RULES[key]
            return rule.fn(tuple(args[:k]), tuple(args[k:])).clone()

        @rule_call_op.register_fake
        def _(args, key, k):
            rule = _RULES[key]
            return torch.empty_like(rule.fn(tuple(args[:k]), tuple(args[k:])))

        _RULE_OP.append(rule_call_op)
    return _RULE_OP[0]


def rule_call(rule, params, data):
    """The trace's node for an analytic rule applied to (params, data)."""
    _RULES[id(rule)] = rule
    return _rule_op()(list(params) + list(data), id(rule), len(params))


# ---------------------------------------------------------------------- #
# references and the IR
# ---------------------------------------------------------------------- #
# A reference is a tuple: ("v", i) an emitted variable, ("c", k) constant
# slot k, ("x", i) input parameter scalar i, ("d", i) data scalar i,
# ("s", 0) the loss argument, ("b", bool) a boolean literal.


class Fn:
    """One emitted function: a list of (var, op, args) in order, the kind
    of every variable ("T", "S" or "B") and the kinds of its inputs."""

    def __init__(self, consts, input_kinds):
        self.consts = consts  # the group's shared list of slot values
        self.input_kinds = input_kinds  # {"x": "T", "d": "S", ...}
        self.code = []
        self.kinds = []

    def kind(self, ref):
        tag = ref[0]
        if tag == "v":
            return self.kinds[ref[1]]
        if tag == "b":
            return "B"
        if tag == "c":
            return "S"
        return self.input_kinds[tag]

    def const(self, value):
        if isinstance(value, (bool, np.bool_)):
            return ("b", bool(value))
        self.consts.append(float(value))
        return ("c", len(self.consts) - 1)

    def emit(self, op, args, kind):
        self.code.append((len(self.kinds), op, tuple(args)))
        self.kinds.append(kind)
        return ("v", len(self.kinds) - 1)

    # -- scalar ops ------------------------------------------------------ #

    def _float_kind(self, refs):
        kinds = [self.kind(r) for r in refs]
        if "B" in kinds:
            raise Ineligible("arithmetic on a boolean")
        return "T" if "T" in kinds else "S"

    def arith(self, op, *refs):
        return self.emit(op, refs, self._float_kind(refs))

    def cmp(self, op, a, b):
        self._float_kind((a, b))
        return self.emit(op, (a, b), "B")

    def logic(self, op, *refs):
        if any(self.kind(r) != "B" for r in refs):
            raise Ineligible(f"{op} on a non-boolean")
        return self.emit(op, refs, "B")

    def sel(self, c, a, b):
        if self.kind(c) != "B":
            raise Ineligible("where on a non-boolean condition")
        ka, kb = self.kind(a), self.kind(b)
        if ka == kb == "B":
            return self.emit("bsel", (c, a, b), "B")
        return self.emit("sel", (c, a, b), self._float_kind((a, b)))

    def to_float(self, r):
        """A boolean as 0 or 1 in S; a float as itself."""
        return self.emit("b2f", (r,), "S") if self.kind(r) == "B" else r


# elementwise ops and their IR names (all arguments floats)
_UNARY = {
    "neg": "neg", "sqrt": "sqrt", "rsqrt": "rsqrt", "exp": "exp", "expm1": "expm1",
    "log": "log", "log1p": "log1p", "sin": "sin", "cos": "cos", "tan": "tan",
    "asin": "asin", "acos": "acos", "atan": "atan", "sinh": "sinh", "cosh": "cosh",
    "tanh": "tanh", "abs": "abs", "reciprocal": "recip",
}
# non-differentiable float results (of S kind even on a T argument)
_STEP = {"sign": "sign", "sgn": "sign", "floor": "floor", "ceil": "ceil", "round": "round",
         "trunc": "trunc"}
_PREDICATES = {"isnan": "isnan", "isinf": "isinf", "isfinite": "isfinite"}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div", "atan2": "atan2",
           "maximum": "max", "minimum": "min"}
_COMPARE = {"gt": "gt", "ge": "ge", "lt": "lt", "le": "le", "eq": "eq", "ne": "ne"}
_LOGIC = {"logical_and": "and", "logical_or": "or", "logical_xor": "xor",
          "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor"}
# ops whose result depends on the input's shape only: constants
_CREATION_LIKE = {"zeros_like", "ones_like", "full_like", "empty_like", "new_zeros", "new_ones",
                  "new_full", "new_empty"}
_VIEW_COPIES = {"alias", "clone", "contiguous", "detach", "lift_fresh_copy", "lift_fresh",
                "alias_copy", "detach_copy"}


# ---------------------------------------------------------------------- #
# lowering an fx graph of aten ops to the IR
# ---------------------------------------------------------------------- #


class _Sym:
    """A traced value: an object array of references and its dtype."""

    __slots__ = ("a", "dtype")

    def __init__(self, a, dtype):
        self.a = a
        self.dtype = dtype


def _obj(shape):
    return np.empty(shape, dtype=object)


def _map(f, *arrays):
    arrays = np.broadcast_arrays(*arrays)
    out = _obj(arrays[0].shape)
    for idx in np.ndindex(out.shape):
        out[idx] = f(*(a[idx] for a in arrays))
    return out


class _Lowering:
    def __init__(self, fn: Fn, dtype):
        self.fn = fn
        self.dtype = dtype
        self._const_refs = {}

    # -- values ---------------------------------------------------------- #

    def refs(self, v):
        """An object array of references for a value (a _Sym, a constant
        tensor or a Python scalar); constants take their slots once."""
        if isinstance(v, _Sym):
            return v.a
        if isinstance(v, torch.Tensor):
            key = id(v)
            if key not in self._const_refs:
                vals = v.detach().cpu()
                out = _obj(tuple(vals.shape))
                flat = vals.reshape(-1).tolist()
                for i, idx in enumerate(np.ndindex(out.shape)):
                    out[idx] = self.fn.const(flat[i])
                self._const_refs[key] = (out, v)  # v kept alive: ids stay unique
            return self._const_refs[key][0]
        if isinstance(v, bool):
            return _scalar_obj(("b", v))
        if isinstance(v, (int, float)):
            return _scalar_obj(self.fn.const(v))
        raise Ineligible(f"unsupported operand {type(v).__name__}")

    def sym(self, a, dtype):
        if dtype.is_floating_point and dtype != self.dtype:
            raise Ineligible(f"a {dtype} value in a {self.dtype} trace")
        if not (dtype.is_floating_point or dtype == torch.bool):
            raise Ineligible(f"a non-constant {dtype} value")
        return _Sym(a, dtype)

    # -- the graph ------------------------------------------------------- #

    def run(self, gm, inputs):
        env = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(inputs):
            raise Ineligible("unexpected trace inputs")
        for n, v in zip(placeholders, inputs):
            env[n] = v
        out = None
        for n in gm.graph.nodes:
            if n.op == "placeholder":
                continue
            if n.op == "get_attr":
                env[n] = getattr(gm, n.target)
            elif n.op == "call_function":
                args = _tree_map(lambda a: env[a] if isinstance(a, torch.fx.Node) else a, n.args)
                kwargs = _tree_map(
                    lambda a: env[a] if isinstance(a, torch.fx.Node) else a, n.kwargs
                )
                env[n] = self.call(n, args, kwargs)
            elif n.op == "output":
                out = _tree_map(lambda a: env[a] if isinstance(a, torch.fx.Node) else a, n.args[0])
            else:
                raise Ineligible(f"graph node {n.op}")
        return out

    def call(self, node, args, kwargs):
        target = node.target
        if target is operator.getitem:
            return args[0][args[1]]
        if not isinstance(target, torch._ops.OpOverload):
            raise Ineligible(f"no rule for {target}")
        name = target.overloadpacket.__name__
        if name.endswith("_") and not name.startswith("__"):
            raise Ineligible(f"in-place op {name}")
        leaves = _leaves((args, kwargs))
        fake = node.meta.get("val")
        if name in _CREATION_LIKE:
            # the result depends on the input's shape only: run the op on
            # zeros of that shape
            args, kwargs = _tree_map(
                lambda a: torch.zeros(a.a.shape, dtype=a.dtype) if isinstance(a, _Sym) else a,
                (args, kwargs),
            )
            return target(*args, **kwargs)
        if not any(isinstance(a, _Sym) for a in leaves):
            try:
                return target(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - any failure: no rule
                raise Ineligible(f"constant {name}: {exc}") from exc
        handler = getattr(self, "op_" + name, None)
        try:
            if handler is not None:
                return handler(args, kwargs, fake)
            if name in _UNARY or name in _STEP or name in _PREDICATES:
                return self._unary(name, args[0], fake)
            if name in _BINARY or name in _COMPARE or name in _LOGIC:
                return self._binary(name, args, kwargs, fake)
        except (IndexError, TypeError, ValueError) as exc:
            # an overload whose arguments a rule does not read (never an
            # error, as group_kernel: the group takes torch.func)
            raise Ineligible(f"aten.{name}: {exc}") from exc
        raise Ineligible(f"no rule for aten.{name}")

    def _result(self, a, fake):
        if not isinstance(a, np.ndarray):  # numpy returns a lone element as itself
            a = _scalar_obj(a)
        return self.sym(a.reshape(tuple(fake.shape)), fake.dtype)

    # -- elementwise ---------------------------------------------------- #

    def _unary(self, name, x, fake):
        fn = self.fn
        a = self.refs(x)
        if name in _UNARY:
            op = _UNARY[name]
            return self._result(_map(lambda r: fn.arith(op, fn.to_float(r)), a), fake)
        if name in _STEP:
            op = _STEP[name]
            return self._result(_map(lambda r: fn.emit(op, (fn.to_float(r),), "S"), a), fake)
        op = _PREDICATES[name]
        return self._result(_map(lambda r: fn.emit(op, (fn.to_float(r),), "B"), a), fake)

    def _binary(self, name, args, kwargs, fake):
        fn = self.fn
        a, b = self.refs(args[0]), self.refs(args[1])
        alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
        if alpha != 1:
            b = _map(lambda r: fn.arith("mul", fn.to_float(r), fn.const(alpha)), b)
        if name == "div" and kwargs.get("rounding_mode") is not None:
            raise Ineligible("div with a rounding mode")
        if name in _BINARY:
            op = _BINARY[name]
            out = _map(lambda x, y: fn.arith(op, fn.to_float(x), fn.to_float(y)), a, b)
        elif name in _COMPARE:
            op = _COMPARE[name]
            out = _map(lambda x, y: fn.cmp(op, fn.to_float(x), fn.to_float(y)), a, b)
        else:
            op = _LOGIC[name]
            out = _map(lambda x, y: fn.logic(op, x, y), a, b)
        return self._result(out, fake)

    def op_rsub(self, args, kwargs, fake):
        alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
        return self._binary("sub", (args[1], args[0], alpha), {}, fake)

    def op_pow(self, args, kwargs, fake):
        fn = self.fn
        base, exp = args[0], args[1]
        if isinstance(exp, (int, float)) and not isinstance(exp, bool):
            a = self.refs(base)
            if float(exp) == int(exp) and abs(exp) <= 64:
                e = int(exp)
                return self._result(_map(lambda r: fn.emit("ipow", (r, ("i", e)), fn.kind(r)), a),
                                    fake)
            c = fn.const(exp)
            return self._result(_map(lambda r: fn.arith("powc", r, c), a), fake)
        a, b = self.refs(base), self.refs(exp)
        return self._result(_map(lambda x, y: fn.arith("pow", x, y), a, b), fake)

    def op_logical_not(self, args, kwargs, fake):
        fn = self.fn
        return self._result(_map(lambda r: fn.logic("not", r), self.refs(args[0])), fake)

    op_bitwise_not = op_logical_not

    def op_where(self, args, kwargs, fake):
        fn = self.fn
        c, a, b = (self.refs(x) for x in args)
        return self._result(_map(fn.sel, c, a, b), fake)

    def op_masked_fill(self, args, kwargs, fake):
        return self.op_where((args[1], args[2], args[0]), {}, fake)

    def _clamp(self, x, lo, hi, fake):
        """clamp as torch writes it (NaN stays NaN): the value passes where
        it is not below lo (not above hi), else the bound."""
        fn = self.fn
        out = self.refs(x)
        if lo is not None:
            out = _map(lambda r, b: fn.sel(fn.cmp("lt", r, b), b, r), out, self.refs(lo))
        if hi is not None:
            out = _map(lambda r, b: fn.sel(fn.cmp("gt", r, b), b, r), out, self.refs(hi))
        return self._result(out, fake)

    def op_clamp(self, args, kwargs, fake):
        lo = kwargs.get("min", args[1] if len(args) > 1 else None)
        hi = kwargs.get("max", args[2] if len(args) > 2 else None)
        return self._clamp(args[0], lo, hi, fake)

    def op_clamp_min(self, args, kwargs, fake):
        return self._clamp(args[0], args[1], None, fake)

    def op_clamp_max(self, args, kwargs, fake):
        return self._clamp(args[0], None, args[1], fake)

    def op__to_copy(self, args, kwargs, fake):
        src = args[0]
        if fake.dtype == src.dtype:
            return src
        if src.dtype == torch.bool and fake.dtype == self.dtype:
            return self._result(_map(self.fn.to_float, src.a), fake)
        raise Ineligible(f"cast {src.dtype} -> {fake.dtype}")

    def op_to(self, args, kwargs, fake):
        return self.op__to_copy(args, kwargs, fake)

    def op_fill(self, args, kwargs, fake):
        v = self.refs(args[1]).reshape(())
        return self._result(np.broadcast_to(v, tuple(fake.shape)), fake)

    # -- moves ----------------------------------------------------------- #

    def _same(self, args, kwargs, fake):
        return args[0] if isinstance(args[0], _Sym) else self._result(self.refs(args[0]), fake)

    def op_view(self, args, kwargs, fake):
        return self._result(self.refs(args[0]).reshape(tuple(fake.shape)), fake)

    op_reshape = op_view
    op__unsafe_view = op_view
    op_view_copy = op_view
    op_unsqueeze = op_view
    op_unsqueeze_copy = op_view
    op_squeeze = op_view
    op_squeeze_copy = op_view
    op_flatten = op_view

    def op_select(self, args, kwargs, fake):
        a = self.refs(args[0])
        dim, idx = args[1] % a.ndim, args[2]
        return self._result(np.take(a, idx, axis=dim), fake)

    op_select_copy = op_select

    def op_slice(self, args, kwargs, fake):
        a = self.refs(args[0])
        dim = (args[1] if len(args) > 1 else 0) % a.ndim
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        sl = [slice(None)] * a.ndim
        sl[dim] = slice(start, end, step)
        return self._result(a[tuple(sl)], fake)

    op_slice_copy = op_slice

    def op_permute(self, args, kwargs, fake):
        return self._result(np.transpose(self.refs(args[0]), args[1]), fake)

    op_permute_copy = op_permute

    def op_t(self, args, kwargs, fake):
        return self._result(self.refs(args[0]).T, fake)

    op_t_copy = op_t

    def op_transpose(self, args, kwargs, fake):
        return self._result(np.swapaxes(self.refs(args[0]), args[1], args[2]), fake)

    op_transpose_copy = op_transpose

    def op_expand(self, args, kwargs, fake):
        return self._result(np.broadcast_to(self.refs(args[0]), tuple(fake.shape)), fake)

    op_expand_copy = op_expand

    def op_flip(self, args, kwargs, fake):
        return self._result(np.flip(self.refs(args[0]), axis=tuple(args[1])), fake)

    def op_cat(self, args, kwargs, fake):
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        parts = [self.refs(t) for t in args[0] if tuple(_shape(t)) != (0,)]
        return self._result(np.concatenate(parts, axis=dim % len(fake.shape)), fake)

    def op_stack(self, args, kwargs, fake):
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        return self._result(np.stack([self.refs(t) for t in args[0]], axis=dim % len(fake.shape)),
                            fake)

    def _split(self, a, sizes, dim, fakes):
        dim %= a.ndim
        cuts = np.cumsum(sizes)[:-1]
        return [self._result(p, f) for p, f in zip(np.split(a, cuts, axis=dim), fakes)]

    def op_unbind(self, args, kwargs, fake):
        a = self.refs(args[0])
        dim = (args[1] if len(args) > 1 else 0) % a.ndim
        return [self._result(np.take(a, i, axis=dim), f) for i, f in enumerate(fake)]

    op_unbind_copy = op_unbind

    def op_split(self, args, kwargs, fake):
        a = self.refs(args[0])
        dim = args[2] if len(args) > 2 else 0
        return self._split(a, [f.shape[dim] for f in fake], dim, fake)

    op_split_copy = op_split
    op_split_with_sizes = op_split
    op_split_with_sizes_copy = op_split

    def op_index(self, args, kwargs, fake):
        a = self.refs(args[0])
        idx = []
        for i in args[1]:
            if i is None:
                idx.append(slice(None))
            elif isinstance(i, torch.Tensor) and not i.dtype.is_floating_point:
                idx.append(i.cpu().numpy())
            else:
                raise Ineligible("index with a non-constant index")
        return self._result(a[tuple(idx)], fake)

    def op_select_scatter(self, args, kwargs, fake):
        base = self.refs(args[0])
        sl = [slice(None)] * base.ndim
        sl[args[2] % base.ndim] = args[3]
        return self._result(_scatter(base, tuple(sl), self.refs(args[1])), fake)

    def op_slice_scatter(self, args, kwargs, fake):
        base = self.refs(args[0])
        sl = [slice(None)] * base.ndim
        sl[(args[2] if len(args) > 2 else 0) % base.ndim] = slice(
            args[3] if len(args) > 3 else None, args[4] if len(args) > 4 else None,
            args[5] if len(args) > 5 else 1)
        return self._result(_scatter(base, tuple(sl), self.refs(args[1])), fake)

    def op_index_put(self, args, kwargs, fake):
        if (args[3] if len(args) > 3 else kwargs.get("accumulate", False)):
            raise Ineligible("index_put with accumulate")
        idx = []
        for i in args[1]:
            if i is None:
                idx.append(slice(None))
            elif isinstance(i, torch.Tensor):
                idx.append(i.cpu().numpy())
            else:
                raise Ineligible("index_put with a non-constant index")
        return self._result(_scatter(self.refs(args[0]), tuple(idx), self.refs(args[2])), fake)

    def op_copy(self, args, kwargs, fake):
        return self._result(np.broadcast_to(self.refs(args[1]), tuple(fake.shape)), fake)

    def op_rule_call(self, args, kwargs, fake):
        """An analytic rule's node: its fn and jac lowered on the inputs'
        values (in S), then each output a "rule" value whose tangent is the
        sum over the parameter inputs of jac[i, k] x_k.v (the data get no
        tangent, as JAX's rules drop theirs)."""
        fn = self.fn
        vals, key, k = args[0], args[1], args[2]
        rule = _RULES[key]
        refs = [self.refs(v) for v in vals]
        vrefs = [_map(lambda r: fn.emit("val", (r,), "S") if fn.kind(r) == "T" else r, a)
                 for a in refs]
        dtypes = [v.dtype for v in vals]

        def value_and_jacobians(*xs):
            p, d = tuple(xs[:k]), tuple(xs[k:])
            out = rule.fn(p, d)
            r = int(out.shape[0]) if out.ndim else 1
            return out, tuple(rule.jacobians(p, d, r))

        out, jacs = _lower(fn, value_and_jacobians,
                           [torch.zeros(a.shape, dtype=dt) for a, dt in zip(vrefs, dtypes)],
                           [_Sym(a, dt) for a, dt in zip(vrefs, dtypes)], self.dtype)
        out = self.refs(out).reshape(-1)
        jacs = [self.refs(j).reshape(out.size, -1) for j in jacs]
        res = _obj(out.shape)
        for i in range(out.size):
            pairs = []
            for p in range(k):
                for j, x in enumerate(refs[p].reshape(-1)):
                    if fn.kind(x) == "T":
                        pairs += [fn.to_float(jacs[p][i, j]), x]
            res[i] = fn.emit("rule", (fn.to_float(out[i]), *pairs), "T") if pairs else out[i]
        return self._result(res, fake)

    # -- reductions and contractions ------------------------------------ #

    def _sum_refs(self, refs):
        fn = self.fn
        refs = [fn.to_float(r) for r in refs]
        if not refs:
            return fn.const(0.0)
        acc = refs[0]
        for r in refs[1:]:
            acc = fn.arith("add", acc, r)
        return acc

    def _reduce(self, x, dims, keepdim, combine, fake):
        a = self.refs(x)
        if dims is None or len(dims) == 0:
            dims = tuple(range(a.ndim))
        dims = tuple(sorted(d % a.ndim for d in dims)) if a.ndim else ()
        keep = [d for d in range(a.ndim) if d not in dims]
        moved = np.transpose(a, keep + list(dims)) if a.ndim else a
        lead = moved.shape[: len(keep)]
        flat = moved.reshape(lead + (-1,)) if a.ndim else moved.reshape(1)
        out = _obj(lead)
        for idx in np.ndindex(lead):
            out[idx] = combine(list(flat[idx]))
        return self._result(out, fake)

    def op_sum(self, args, kwargs, fake):
        dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
        keepdim = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
        return self._reduce(args[0], dims, keepdim, self._sum_refs, fake)

    def op_mean(self, args, kwargs, fake):
        dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
        keepdim = kwargs.get("keepdim", args[2] if len(args) > 2 else False)

        def mean(refs):
            return self.fn.arith("div", self._sum_refs(refs), self.fn.const(len(refs)))

        return self._reduce(args[0], dims, keepdim, mean, fake)

    def op_prod(self, args, kwargs, fake):
        dims = [args[1]] if len(args) > 1 else None
        fn = self.fn

        def prod(refs):
            acc = fn.to_float(refs[0])
            for r in refs[1:]:
                acc = fn.arith("mul", acc, fn.to_float(r))
            return acc

        return self._reduce(args[0], dims, False, prod, fake)

    def op_linalg_vector_norm(self, args, kwargs, fake):
        ord_ = kwargs.get("ord", args[1] if len(args) > 1 else 2)
        if ord_ != 2:
            raise Ineligible("vector norm of an order other than 2")
        dims = kwargs.get("dim", args[2] if len(args) > 2 else None)
        fn = self.fn

        def norm(refs):
            return fn.arith("sqrt", self._sum_refs([fn.arith("mul", r, r) for r in refs]))

        return self._reduce(args[0], dims, False, norm, fake)

    def _dot(self, xs, ys):
        return self._sum_refs([self.fn.arith("mul", x, y) for x, y in zip(xs, ys)])

    def op_dot(self, args, kwargs, fake):
        a, b = self.refs(args[0]), self.refs(args[1])
        return self._result(self._dot(list(a), list(b)), fake)

    op_vdot = op_dot

    def op_mv(self, args, kwargs, fake):
        m, v = self.refs(args[0]), self.refs(args[1])
        out = _obj((m.shape[0],))
        for i in range(m.shape[0]):
            out[i] = self._dot(list(m[i]), list(v))
        return self._result(out, fake)

    def _mm(self, a, b):
        out = _obj((a.shape[0], b.shape[1]))
        for i in range(a.shape[0]):
            for j in range(b.shape[1]):
                out[i, j] = self._dot(list(a[i]), list(b[:, j]))
        return out

    def op_mm(self, args, kwargs, fake):
        return self._result(self._mm(self.refs(args[0]), self.refs(args[1])), fake)

    def op_bmm(self, args, kwargs, fake):
        a, b = self.refs(args[0]), self.refs(args[1])
        return self._result(np.stack([self._mm(a[k], b[k]) for k in range(a.shape[0])]), fake)

    def op_addmm(self, args, kwargs, fake):
        beta = kwargs.get("beta", 1)
        alpha = kwargs.get("alpha", 1)
        fn = self.fn
        prod = self._mm(self.refs(args[1]), self.refs(args[2]))
        if alpha != 1:
            prod = _map(lambda r: fn.arith("mul", r, fn.const(alpha)), prod)
        bias = self.refs(args[0])
        if beta != 1:
            bias = _map(lambda r: fn.arith("mul", r, fn.const(beta)), bias)
        return self._result(_map(lambda x, y: fn.arith("add", x, y), bias, prod), fake)

    def op_linalg_cross(self, args, kwargs, fake):
        fn = self.fn
        a, b = np.broadcast_arrays(self.refs(args[0]), self.refs(args[1]))
        dim = (kwargs.get("dim", args[2] if len(args) > 2 else -1)) % a.ndim
        a, b = np.moveaxis(a, dim, -1), np.moveaxis(b, dim, -1)
        out = _obj(a.shape)
        for idx in np.ndindex(a.shape[:-1]):
            x, y = a[idx], b[idx]
            for k, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
                out[idx + (k,)] = fn.arith(
                    "sub", fn.arith("mul", x[i], y[j]), fn.arith("mul", x[j], y[i])
                )
        return self._result(np.moveaxis(out, -1, dim), fake)


for _name in _VIEW_COPIES:
    setattr(_Lowering, "op_" + _name, _Lowering._same)
del _name


def _scatter(base, index, src):
    """A copy of `base` with src (broadcast) written at base[index],
    element by element (numpy would store a 0-d array as one element)."""
    out = base.copy()
    pos = np.asarray(np.arange(out.size).reshape(out.shape)[index])
    src = np.broadcast_to(src, pos.shape)
    flat = out.reshape(-1)
    for idx in np.ndindex(pos.shape):
        flat[pos[idx]] = src[idx]
    return out


def _scalar_obj(ref):
    out = _obj(())
    out[()] = ref
    return out


def _shape(v):
    if isinstance(v, _Sym):
        return v.a.shape
    return tuple(v.shape)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _tree_map(f, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def _trace(f, examples):
    """make_fx of f over fake tensors, views and mutations removed."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize

    _GENERATING[0] += 1
    try:
        gm = make_fx(
            functionalize(f, remove="mutations_and_views"),
            tracing_mode="fake",
            _allow_non_fake_inputs=True,
        )(*examples)
    except Ineligible:
        raise
    except Exception as exc:  # noqa: BLE001 - data-dependent control flow, ...
        raise Ineligible(f"trace failed: {type(exc).__name__}: {exc}") from exc
    finally:
        _GENERATING[0] -= 1
    # forward-mode AD (torch.func.jacfwd of a plus) leaves shape checks on
    # meta tensors whose results nothing reads
    gm.graph.eliminate_dead_code()
    return gm


def _lower(fn: Fn, f, examples, inputs, dtype):
    held = set(_RULES)
    try:
        return _Lowering(fn, dtype).run(_trace(f, examples), inputs)
    finally:
        for key in set(_RULES) - held:  # the rules this trace registered
            del _RULES[key]


def _plus_jacobian_of(manifold):
    # a closure: make_fx counts a lambda's default arguments as inputs
    return lambda x: manifold.plus_jacobian(x)


def _input_array(tag, start, shape):
    """The references (tag, start), (tag, start + 1), ... in `shape`."""
    out = _obj(tuple(shape))
    for i, idx in enumerate(np.ndindex(out.shape)):
        out[idx] = (tag, start + i)
    return out


# ---------------------------------------------------------------------- #
# the group program
# ---------------------------------------------------------------------- #


class GroupProgram:
    """The generated evaluation of one signature group in one dtype: the
    IR of its functor, its manifolds' plus-Jacobians and its loss, the
    constant slots, and the C++ source (which holds no constant value)."""

    def __init__(self, meta, data_shapes, dtype, apply_loss):
        self.dtype = dtype
        self.r = int(meta.cost_function.num_residuals)
        self.sizes = tuple(int(pm.size) for pm in meta.positions)
        self.tangents = tuple(int(pm.tangent_size) for pm in meta.positions)
        self.manifolds = tuple(pm.manifold for pm in meta.positions)
        self.data_shapes = tuple(tuple(s) for s in data_shapes)
        self.data_sizes = tuple(int(np.prod(s)) if len(s) else 1 for s in self.data_shapes)
        self.aoff = tuple(int(v) for v in np.concatenate([[0], np.cumsum(self.sizes)])[:-1])
        self.toff = tuple(int(v) for v in np.concatenate([[0], np.cumsum(self.tangents)])[:-1])
        self.doff = tuple(int(v) for v in np.concatenate([[0], np.cumsum(self.data_sizes)])[:-1])
        self.num_tangent = sum(self.tangents)
        self.consts = []
        loss = meta.loss if apply_loss else None
        self.has_loss = loss is not None

        # the functor: x (T) and d (S) inputs -> [r] outputs
        self.functor = Fn(self.consts, {"x": "T", "d": "S"})
        xs = [_input_array("x", a, (s,)) for a, s in zip(self.aoff, self.sizes)]
        ds = [_input_array("d", o, sh) for o, sh in zip(self.doff, self.data_shapes)]
        k = len(self.sizes)
        ex = [torch.zeros(s, dtype=dtype) for s in self.sizes] + [
            torch.zeros(sh, dtype=dtype) for sh in self.data_shapes
        ]
        cf = meta.cost_function.fn

        def functor(*args):
            return cf(tuple(args[:k]), tuple(args[k:]))

        inputs = [_Sym(x, dtype) for x in xs] + [_Sym(d, dtype) for d in ds]
        out = _lower(self.functor, functor, ex, inputs, dtype)
        self.out = self._outputs(self.functor, out, (self.r,), "functor")
        # the functor carries an analytic rule: its tangents are the rule's
        self.has_rule = any(op == "rule" for _, op, _ in self.functor.code)

        # each manifold position's plus-Jacobian [size, tangent], of x (S)
        self.plus_jacobians = []
        for p, m in enumerate(self.manifolds):
            if m is None:
                self.plus_jacobians.append(None)
                continue
            f = Fn(self.consts, {"x": "S"})
            pj = _lower(f, _plus_jacobian_of(m), [torch.zeros(self.sizes[p], dtype=dtype)],
                        [_Sym(xs[p], dtype)], dtype)
            self.plus_jacobians.append(
                (f, self._outputs(f, pj, (self.sizes[p], self.tangents[p]), "plus_jacobian"))
            )

        # the loss: s (S) -> (rho0, rho1, rho2)
        self.rho = None
        if loss is not None:
            f = Fn(self.consts, {"s": "S"})
            rho = _lower(f, lambda s: tuple(loss.rho(s)), [torch.zeros((), dtype=dtype)],
                         [_Sym(_scalar_obj(("s", 0)), dtype)], dtype)
            if not isinstance(rho, (tuple, list)) or len(rho) != 3:
                raise Ineligible("rho must return three values")
            self.rho = (f, [self._outputs(f, v, (), "rho")[0] for v in rho])
        self.source = emit_source(self)
        # the launch's state, filled by eval_kernel.generic_evaluate: the
        # loaded entry point of this dtype, and on each card the constant
        # slots and the int32 ticket counter of the one-launch cost sum
        # (zeroed once; each launch's last block sets it back to 0)
        self.entry_point = None
        self.device_consts = {}
        self.device_tickets = {}

    @staticmethod
    def _outputs(fn, v, shape, what):
        """The references of an output value of `shape`, floats only."""
        if isinstance(v, _Sym):
            a = v.a
        elif isinstance(v, torch.Tensor):
            a = _Lowering(fn, v.dtype).refs(v)
        else:
            raise Ineligible(f"{what} returned {type(v).__name__}")
        if a.size != int(np.prod(shape)):
            raise Ineligible(f"{what} has shape {a.shape}, expected {shape}")
        refs = list(a.reshape(-1))
        for r in refs:
            if fn.kind(r) == "B":
                raise Ineligible(f"{what} returned a boolean")
        return refs


# ---------------------------------------------------------------------- #
# C++ emission
# ---------------------------------------------------------------------- #

_CPP_FUNCS = {
    "sqrt", "rsqrt", "exp", "expm1", "log", "log1p", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "abs", "recip", "atan2", "max", "min", "pow", "powc",
    "sign", "floor", "ceil", "round", "trunc", "isnan", "isinf", "isfinite",
}
_CPP_BIN = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
_CPP_CMP = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}


def _cpp_ref(fn: Fn, ref, want=None):
    tag, v = ref
    if tag == "v":
        s = f"v{v}"
    elif tag == "c":
        s = f"c[{v}]"
    elif tag == "b":
        s = "true" if v else "false"
    elif tag == "i":
        s = str(v)
    elif tag == "s":
        s = "s"
    else:
        s = f"{tag}[{v}]"
    if want == "T" and fn.kind(ref) == "S":
        return f"T({s})"
    return s


def _cpp_body(fn: Fn, indent="    "):
    lines = []
    for var, op, args in fn.code:
        kind = fn.kinds[var]
        kinds = [fn.kind(a) if a[0] != "i" else "I" for a in args]
        float_kind = "T" if "T" in kinds else "S"
        if op == "rule":
            # value args[0], tangent sum_k args[2k+1] * args[2k+2].v
            lines.append(f"{indent}T v{var} = ctt::rule_value<T>({_cpp_ref(fn, args[0])});")
            for jr, xr in zip(args[1::2], args[2::2]):
                lines.append(f"{indent}ctt::rule_add(v{var}, {_cpp_ref(fn, jr)}, "
                             f"{_cpp_ref(fn, xr)});")
            continue
        if op == "val":
            expr = f"ctt::val({_cpp_ref(fn, args[0])})"
        elif op in _CPP_BIN:
            a, b = (_cpp_ref(fn, x) for x in args)
            expr = f"{a} {_CPP_BIN[op]} {b}"
        elif op == "neg":
            expr = f"-{_cpp_ref(fn, args[0])}"
        elif op in _CPP_CMP:
            a, b = (f"ctt::val({_cpp_ref(fn, x)})" for x in args)
            expr = f"{a} {_CPP_CMP[op]} {b}"
        elif op == "and":
            expr = f"{_cpp_ref(fn, args[0])} && {_cpp_ref(fn, args[1])}"
        elif op == "or":
            expr = f"{_cpp_ref(fn, args[0])} || {_cpp_ref(fn, args[1])}"
        elif op == "xor":
            expr = f"{_cpp_ref(fn, args[0])} != {_cpp_ref(fn, args[1])}"
        elif op == "not":
            expr = f"!{_cpp_ref(fn, args[0])}"
        elif op in ("sel", "bsel"):
            want = "T" if kind == "T" else None
            c, a, b = _cpp_ref(fn, args[0]), _cpp_ref(fn, args[1], want), _cpp_ref(fn, args[2], want)
            expr = f"{c} ? {a} : {b}"
        elif op == "b2f":
            expr = f"{_cpp_ref(fn, args[0])} ? S(1) : S(0)"
        elif op == "ipow":
            expr = f"ctt::f_ipow({_cpp_ref(fn, args[0])}, {args[1][1]})"
        elif op in ("sign", "floor", "ceil", "round", "trunc", "isnan", "isinf", "isfinite"):
            expr = f"ctt::f_{op}(ctt::val({_cpp_ref(fn, args[0])}))"
        elif op == "powc":
            expr = f"ctt::f_powc({_cpp_ref(fn, args[0])}, {_cpp_ref(fn, args[1])})"
        elif op in _CPP_FUNCS:
            want = "T" if float_kind == "T" else None
            expr = f"ctt::f_{op}(" + ", ".join(_cpp_ref(fn, a, want) for a in args) + ")"
        else:
            raise Ineligible(f"no C++ rule for {op}")
        ctype = {"T": "T", "S": "S", "B": "bool"}[kind]
        lines.append(f"{indent}const {ctype} v{var} = {expr};")
    return lines


def _cpp_array(vals):
    return "{" + ", ".join(str(int(v)) for v in vals) + "}"


def emit_source(g: GroupProgram) -> str:
    """The generated translation unit: a struct G the template of
    csrc/eval_generic.cuh instantiates (constants as functions of the
    position or data index; seed, functor and rho as straight-line code)."""
    P, Q = len(g.sizes), len(g.data_sizes)
    L = []
    L.append("// Generated by ceres_tpu_torch/functor_codegen.py: one signature group's")
    L.append("// functor, plus-Jacobians and loss for the kernel template of")
    L.append("// eval_generic.cuh. It holds no constant value: those come in c[].")
    L.append('#include "eval_generic.cuh"')
    L.append("")
    L.append("struct G {")
    L.append(f"  static constexpr int kPos = {P}, kR = {g.r}, kN = {g.num_tangent}, "
             f"kA = {sum(g.sizes)}, kData = {Q}, kD = {sum(g.data_sizes)}, "
             f"kLoss = {int(g.has_loss)};")
    for name, vals in (("amb", g.sizes), ("tan", g.tangents), ("aoff", g.aoff),
                       ("toff", g.toff), ("manifold", [m is not None for m in g.manifolds])):
        L.append(f"  __host__ __device__ static constexpr int {name}(int p) {{ "
                 f"constexpr int v[] = {_cpp_array(vals)}; return v[p]; }}")
    for name, vals in (("dsize", g.data_sizes), ("doff", g.doff)):
        vals = vals or (0,)
        L.append(f"  __host__ __device__ static constexpr int {name}(int q) {{ "
                 f"constexpr int v[] = {_cpp_array(vals)}; return v[q]; }}")
    # the manifold positions' tangent columns: the plus-Jacobian of x
    L.append("  // dual part of each manifold position's parameters: its plus-Jacobian")
    L.append("  template <class J, class S>")
    L.append("  __device__ static void seed_manifolds(const S* x, const S* c, J* xj) {")
    for p, rec in enumerate(g.plus_jacobians):
        if rec is None:
            continue
        f, refs = rec
        L.append("    {")
        L += _cpp_body(f, "      ")
        t = g.tangents[p]
        for i, ref in enumerate(refs):
            j, k = divmod(i, t)
            L.append(f"      xj[{g.aoff[p] + j}].v[{g.toff[p] + k}] = {_cpp_ref(f, ref)};")
        L.append("    }")
    L.append("  }")
    L.append("  template <class T, class S>")
    L.append("  __device__ static void functor(const T* x, const S* d, const S* c, T* out) {")
    L += _cpp_body(g.functor)
    for i, ref in enumerate(g.out):
        L.append(f"    out[{i}] = {_cpp_ref(g.functor, ref, 'T')};")
    L.append("  }")
    L.append("  template <class S>")
    L.append("  __device__ static void rho(S s, const S* c, S* out) {")
    if g.rho is not None:
        f, refs = g.rho
        L += _cpp_body(f)
        for i, ref in enumerate(refs):
            L.append(f"    out[{i}] = {_cpp_ref(f, ref)};")
    L.append("  }")
    L.append("};")
    L.append("")
    L.append("CTT_EVAL_GENERIC_ENTRY(G)")
    return "\n".join(L) + "\n"


# ---------------------------------------------------------------------- #
# the IR in Python, with the dual-number rules of csrc/eval_generic.cuh
# ---------------------------------------------------------------------- #


class Dual:
    """Jet<S, N> of eval_generic.cuh in numpy: value a, tangent v [N]."""

    __slots__ = ("a", "v")

    def __init__(self, a, v):
        self.a = a
        self.v = v


def _val(x):
    return x.a if isinstance(x, Dual) else x


def _lift(x, n):
    return x if isinstance(x, Dual) else Dual(x, np.zeros(n))


def _chain(x, value, deriv):
    """value with tangent deriv * x.v (a scalar x has none)."""
    return Dual(value, deriv * x.v) if isinstance(x, Dual) else value


def _ev_binary(op, a, b, n):
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return {"add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
                "div": lambda: a / b}[op]()
    if op == "add":
        if not isinstance(a, Dual):
            return Dual(a + b.a, b.v.copy())
        if not isinstance(b, Dual):
            return Dual(a.a + b, a.v.copy())
        return Dual(a.a + b.a, a.v + b.v)
    if op == "sub":
        if not isinstance(a, Dual):
            return Dual(a - b.a, -b.v)
        if not isinstance(b, Dual):
            return Dual(a.a - b, a.v.copy())
        return Dual(a.a - b.a, a.v - b.v)
    if op == "mul":
        if not isinstance(a, Dual):
            return Dual(a * b.a, a * b.v)
        if not isinstance(b, Dual):
            return Dual(a.a * b, a.v * b)
        return Dual(a.a * b.a, a.v * b.a + a.a * b.v)
    # div: the value as a plain quotient, the tangent through 1 / b
    if not isinstance(b, Dual):
        return Dual(a.a / b, a.v * (1.0 / b))
    inv = 1.0 / b.a
    r = _val(a) / b.a
    av = a.v if isinstance(a, Dual) else np.zeros(n)
    return Dual(r, (av - r * b.v) * inv)


def _ev_func(op, args, n):
    x = args[0]
    a = _val(x)
    with np.errstate(all="ignore"):
        if op == "sqrt":
            r = np.sqrt(a)
            return _chain(x, r, 1.0 / (2.0 * r))
        if op == "rsqrt":
            r = 1.0 / np.sqrt(a)
            return _chain(x, r, -0.5 * r / a)
        if op == "exp":
            r = np.exp(a)
            return _chain(x, r, r)
        if op == "expm1":
            return _chain(x, np.expm1(a), np.exp(a))
        if op == "log":
            return _chain(x, np.log(a), 1.0 / a)
        if op == "log1p":
            return _chain(x, np.log1p(a), 1.0 / (1.0 + a))
        if op == "sin":
            return _chain(x, np.sin(a), np.cos(a))
        if op == "cos":
            return _chain(x, np.cos(a), -np.sin(a))
        if op == "tan":
            t = np.tan(a)
            return _chain(x, t, 1.0 + t * t)
        if op == "asin":
            return _chain(x, np.arcsin(a), 1.0 / np.sqrt(1.0 - a * a))
        if op == "acos":
            return _chain(x, np.arccos(a), -1.0 / np.sqrt(1.0 - a * a))
        if op == "atan":
            return _chain(x, np.arctan(a), 1.0 / (1.0 + a * a))
        if op == "sinh":
            return _chain(x, np.sinh(a), np.cosh(a))
        if op == "cosh":
            return _chain(x, np.cosh(a), np.sinh(a))
        if op == "tanh":
            t = np.tanh(a)
            return _chain(x, t, 1.0 - t * t)
        if op == "abs":
            return _chain(x, np.abs(a), np.sign(a))
        if op == "recip":
            r = 1.0 / a
            return _chain(x, r, -r * r)
        if op == "powc":
            e = args[1]
            return _chain(x, np.power(a, e), e * np.power(a, e - 1.0))
        if op == "ipow":
            e = args[1]
            r = _ipow(a, e)
            return _chain(x, r, e * _ipow(a, e - 1))
        if op in ("atan2", "max", "min", "pow"):
            y = args[1]
            b = _val(y)
            if not isinstance(x, Dual) and not isinstance(y, Dual):
                return {"atan2": np.arctan2, "max": _fmax, "min": _fmin, "pow": np.power}[op](a, b)
            x, y = _lift(x, n), _lift(y, n)
            if op == "atan2":
                inv = 1.0 / (a * a + b * b)
                return Dual(np.arctan2(a, b), (x.v * b - y.v * a) * inv)
            if op in ("max", "min"):
                w = 0.5 if a == b else float((a > b) if op == "max" else (a < b))
                r = _fmax(a, b) if op == "max" else _fmin(a, b)
                return Dual(r, y.v + w * (x.v - y.v))
            r = np.power(a, b)
            return Dual(r, b * np.power(a, b - 1.0) * x.v + r * np.log(a) * y.v)
    raise Ineligible(f"no Python rule for {op}")


def _fmax(a, b):
    return a if (a > b or math.isnan(a)) else (b if not math.isnan(b) else b)


def _fmin(a, b):
    return a if (a < b or math.isnan(a)) else b


def _ipow(a, e):
    if e == 0:
        return 1.0
    if e == 1:
        return a
    if e == 2:
        return a * a
    if e == 3:
        return a * a * a
    with np.errstate(all="ignore"):
        return float(np.power(a, float(e)))


def _ev(fn: Fn, env, n):
    for var, op, args in fn.code:
        xs = [_ev_ref(env, r) for r in args]
        if op in ("add", "sub", "mul", "div"):
            out = _ev_binary(op, xs[0], xs[1], n)
        elif op == "neg":
            x = xs[0]
            out = Dual(-x.a, -x.v) if isinstance(x, Dual) else -x
        elif op in _CPP_CMP:
            a, b = _val(xs[0]), _val(xs[1])
            out = {"gt": a > b, "ge": a >= b, "lt": a < b, "le": a <= b, "eq": a == b,
                   "ne": a != b}[op]
        elif op == "and":
            out = xs[0] and xs[1]
        elif op == "or":
            out = xs[0] or xs[1]
        elif op == "xor":
            out = xs[0] != xs[1]
        elif op == "not":
            out = not xs[0]
        elif op in ("sel", "bsel"):
            a, b = xs[1], xs[2]
            if fn.kinds[var] == "T":
                a, b = _lift(a, n), _lift(b, n)
            out = a if xs[0] else b
        elif op == "b2f":
            out = 1.0 if xs[0] else 0.0
        elif op == "val":
            out = _val(xs[0])
        elif op == "rule":
            out = _val(xs[0])
            if any(isinstance(x, Dual) for x in xs[2::2]):
                v = np.zeros(n)
                for j, x in zip(xs[1::2], xs[2::2]):
                    v = v + _val(j) * x.v
                out = Dual(out, v)
        elif op in ("sign", "floor", "ceil", "round", "trunc"):
            out = float({"sign": np.sign, "floor": np.floor, "ceil": np.ceil,
                         "round": np.round, "trunc": np.trunc}[op](_val(xs[0])))
        elif op in ("isnan", "isinf", "isfinite"):
            out = bool({"isnan": np.isnan, "isinf": np.isinf, "isfinite": np.isfinite}[op](
                _val(xs[0])))
        else:
            out = _ev_func(op, xs, n)
        env[("v", var)] = out


def _ev_ref(env, ref):
    if ref[0] in ("b", "i"):
        return ref[1]
    return env[ref]


def run_ir(g: GroupProgram, params, data, with_jacobian=True):
    """Evaluate the generated program for one block in float64 with the
    kernel's dual-number rules: params, data as lists of numpy arrays.
    Returns (residuals [r], [r, N] tangent-space Jacobian or None, rho
    (rho0, rho1, rho2) or None), before the Triggs correction."""
    n = g.num_tangent
    consts = np.asarray(g.consts, dtype=np.float64)
    x = np.concatenate([np.asarray(p, dtype=np.float64).reshape(-1) for p in params])
    d = (np.concatenate([np.asarray(v, dtype=np.float64).reshape(-1) for v in data])
         if data else np.zeros(0))
    env = {("c", k): float(v) for k, v in enumerate(consts)}
    for i, v in enumerate(d):
        env[("d", i)] = float(v)
    if with_jacobian:
        xj = [Dual(float(v), np.zeros(n)) for v in x]
        for p, rec in enumerate(g.plus_jacobians):
            if rec is None:
                for j in range(g.sizes[p]):
                    xj[g.aoff[p] + j].v[g.toff[p] + j] = 1.0
                continue
            f, refs = rec
            penv = dict(env)
            for i, v in enumerate(x):
                penv[("x", i)] = float(v)
            _ev(f, penv, n)
            for i, ref in enumerate(refs):
                j, k = divmod(i, g.tangents[p])
                xj[g.aoff[p] + j].v[g.toff[p] + k] = _ev_ref(penv, ref)
        for i, v in enumerate(xj):
            env[("x", i)] = v
    else:
        for i, v in enumerate(x):
            env[("x", i)] = float(v)
    _ev(g.functor, env, n)
    outs = [_lift(_ev_ref(env, r), n) if with_jacobian else _val(_ev_ref(env, r)) for r in g.out]
    res = np.array([_val(o) for o in outs])
    jac = np.stack([o.v for o in outs]) if with_jacobian else None
    rho = None
    if g.rho is not None:
        f, refs = g.rho
        renv = dict(env)
        renv[("s", 0)] = float(np.sum(res * res))
        _ev(f, renv, n)
        rho = tuple(float(_ev_ref(renv, r)) for r in refs)
    return res, jac, rho


# ---------------------------------------------------------------------- #
# the group's program, once per (dtype, apply_loss)
# ---------------------------------------------------------------------- #


def data_shapes(garr):
    """The per-block shapes of a group's data leaves, or Ineligible for
    integer data or data of rank > 2 ([n, ...] leaves, as group_kernel)."""
    shapes = []
    for d in garr["data"]:
        if d.ndim > 2:
            raise Ineligible("data of rank > 2")
        if not d.dtype.is_floating_point:
            raise Ineligible("integer data")
        shapes.append(tuple(d.shape[1:]))
    return shapes


def group_program(meta, garr, dtype, apply_loss):
    """The GroupProgram of a group (cached on its meta), or None when the
    group is not eligible (never an error, as JAX's group_kernel)."""
    cache = meta.__dict__.setdefault("_generic_programs", {})
    key = (dtype, bool(apply_loss))
    hit = cache.get(key)
    # a test may swap a group's loss or positions after a first evaluation:
    # the entry holds the objects it was traced from, so it is rebuilt then
    if hit is None or hit[0] is not meta.loss or hit[1] is not meta.positions:
        try:
            prog = GroupProgram(meta, data_shapes(garr), dtype, apply_loss)
        except Ineligible:
            prog = None
        hit = cache[key] = (meta.loss, meta.positions, prog)
    return hit[2]
