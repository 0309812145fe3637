"""Scalar-DAG lifting: per-element jaxprs as simplified scalar expression
graphs over lane vectors.

The fused lane-iteration kernel (fused_iter_kernel.py) runs one scenario
per GPU thread, so every matrix entry of a stage is one ``(BL,)`` lane
vector.  The model's stage derivatives come from JAX AD (``jax.linearize``
applied to one-hot basis rows), whose jaxprs do dense vector arithmetic
against tangents that are almost entirely structural zeros, and recompute
shared primal subexpressions across several traces.

This module interprets the jaxpr with every array held as a numpy *object
array of scalar nodes* (a hash-consed expression DAG).  Constants are plain
Python scalars, so

* ``mul(x, 0) → 0``, ``mul(x, 1) → x``, ``add(x, 0) → x``, ... fold at
  build time — the one-hot jvp structure evaporates;
* reshape/transpose/slice/broadcast/concatenate become free index
  bookkeeping on the object arrays;
* hash-consing dedupes at scalar granularity across all the concatenated AD
  traces (primal, jvp columns, raw costs).

Emission then maps each surviving node to ONE elementwise op on a lane
vector.  :func:`scalar_lift` raises :class:`NotImplementedError` for
jaxprs it cannot scalarize.

Structural-zero caveat: folding ``mul(x, 0) → 0`` and ``div(0, x) → 0``
assumes the dropped factor is finite/non-zero, which holds for AD basis
tangents and model denominators at feasible iterates (the solver only
evaluates stage derivatives at accepted — feasible — points; trial-point
NaN/Inf costs are handled by the caller's ``where``, reference
par_interior_point_newton.py:159-163).
"""

from __future__ import annotations

import math

import jax
import jax.extend  # noqa: F401  (jax.extend.core is not auto-registered)
import numpy as np
from jax import lax

Literal = jax.extend.core.Literal


# ---------------------------------------------------------------------------
# Scalar expression nodes
# ---------------------------------------------------------------------------


class _Node:
    """One scalar operation (or kernel input element) in the DAG."""

    __slots__ = ("prim", "params", "args", "order", "in_dtypes")

    def __init__(self, prim, params, args, order, in_dtypes=()):
        self.prim = prim        # jax Primitive, or the string "input"
        self.params = params    # bind params dict, or (argpos, flat_idx)
        self.args = args        # tuple of _Node | python scalar
        self.order = order      # creation index (a valid topo order)
        self.in_dtypes = in_dtypes  # invar aval dtypes (strict-prim emit)


def _is_const(v):
    return not isinstance(v, _Node)


def _ckey(v):
    """Hash key for a constant (type-tagged: 0 != 0.0 != False)."""
    return ("c", type(v).__name__, repr(v))


_COMMUTATIVE = {"add", "mul", "max", "min", "and", "or", "xor", "eq", "ne"}

# numpy implementations for constant folding (names are lax primitive names)
_NP_FOLD = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "div": np.divide, "neg": np.negative, "sign": np.sign,
    "floor": np.floor, "ceil": np.ceil, "abs": np.abs,
    "max": np.maximum, "min": np.minimum, "rem": np.fmod,
    "pow": np.power, "sqrt": np.sqrt, "cbrt": np.cbrt,
    "rsqrt": lambda x: 1.0 / np.sqrt(x),
    "exp": np.exp, "log": np.log, "log1p": np.log1p, "expm1": np.expm1,
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "atan2": np.arctan2, "square": np.square,
    "logistic": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "eq": np.equal, "ne": np.not_equal, "lt": np.less,
    "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
    "and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor,
    "not": np.invert, "is_finite": np.isfinite,
}


class _Builder:
    """Hash-consing scalar-DAG builder with algebraic simplification."""

    def __init__(self):
        self.table = {}
        self.n_created = 0
        self.n_folded = 0
        self.n_hits = 0

    def input(self, argpos, flat_idx):
        key = ("input", argpos, flat_idx)
        nd = self.table.get(key)
        if nd is None:
            nd = _Node("input", (argpos, flat_idx), (), self.n_created)
            self.n_created += 1
            self.table[key] = nd
        return nd

    # -- constant folding ---------------------------------------------------

    def _fold(self, name, prim, params, args, in_dtypes, out_dtype):
        fn = _NP_FOLD.get(name)
        with np.errstate(all="ignore"):
            if fn is not None:
                vals = [np.asarray(a, dtype=d)
                        for a, d in zip(args, in_dtypes)]
                out = fn(*vals)
            elif name == "integer_pow":
                out = np.asarray(args[0], dtype=in_dtypes[0]) ** params["y"]
            elif name == "convert_element_type":
                out = np.asarray(args[0]).astype(params["new_dtype"])
            elif name == "select_n":
                out = np.asarray(args[1 + int(args[0])])
            elif name == "round":
                out = np.round(np.asarray(args[0], dtype=in_dtypes[0]))
            else:
                # rare: fold through jax's own eager impl
                with jax.ensure_compile_time_eval():
                    out = prim.bind(
                        *[np.asarray(a, dtype=d)
                          for a, d in zip(args, in_dtypes)],
                        **params,
                    )
        return np.asarray(out).astype(out_dtype).item()

    # -- simplification -----------------------------------------------------

    @staticmethod
    def _simplify(name, params, args, in_dtypes):
        """Identity returns (True, value); no-simplification (False, None)."""
        if name in ("add", "sub", "mul", "div", "max", "min"):
            a, b = args
            ac, bc = _is_const(a), _is_const(b)
            if name == "add":
                if bc and b == 0:
                    return True, a
                if ac and a == 0:
                    return True, b
            elif name == "sub":
                if bc and b == 0:
                    return True, a
                if a is b:
                    return True, 0.0
            elif name == "mul":
                if bc and b == 0 or ac and a == 0:
                    return True, 0.0
                if bc and b == 1:
                    return True, a
                if ac and a == 1:
                    return True, b
            elif name == "div":
                if bc and b == 1:
                    return True, a
                if ac and a == 0:
                    return True, 0.0
        elif name == "select_n" and _is_const(args[0]):
            return True, args[1 + int(args[0])]
        elif name in ("and", "or") and all(
                np.dtype(d) == np.bool_ for d in in_dtypes):
            # boolean only: lax and/or are BITWISE on integers
            a, b = args
            for c, x in ((a, b), (b, a)):
                if _is_const(c):
                    c = bool(c)
                    if name == "and":
                        return True, (x if c else False)
                    return True, (True if c else x)
        elif name == "neg" and isinstance(args[0], _Node) \
                and getattr(args[0].prim, "name", None) == "neg":
            return True, args[0].args[0]
        elif name == "integer_pow" and params.get("y") == 1:
            return True, args[0]
        return False, None

    def op(self, prim, params, args, in_dtypes, out_dtype):
        name = prim.name
        args = tuple(args)
        if all(_is_const(a) for a in args):
            self.n_folded += 1
            return self._fold(name, prim, params, args, in_dtypes, out_dtype)
        hit, val = self._simplify(name, params, args, in_dtypes)
        if hit:
            return val
        # strength reduction: a divide costs several multiplies.
        # Floating only: lax.div on integers is truncating division.
        if name == "div" and _is_const(args[1]) and all(
                np.issubdtype(np.dtype(d), np.floating)
                for d in list(in_dtypes) + [out_dtype]):
            c = args[1]
            if c != 0 and math.isfinite(c) and math.isfinite(1.0 / c):
                return self.op(_lax_prim("mul"), {}, (args[0], 1.0 / c),
                               in_dtypes, out_dtype)
        if name == "integer_pow" and params.get("y") in (2, 3, 4):
            y = params["y"]
            mul = _lax_prim("mul")
            dts = (in_dtypes[0], in_dtypes[0])
            sq = self.op(mul, {}, (args[0], args[0]), dts, out_dtype)
            if y == 2:
                return sq
            if y == 3:
                return self.op(mul, {}, (sq, args[0]), dts, out_dtype)
            return self.op(mul, {}, (sq, sq), dts, out_dtype)
        kargs = tuple(_ckey(a) if _is_const(a) else id(a) for a in args)
        if name in _COMMUTATIVE:
            kargs = tuple(sorted(kargs, key=repr))
        key = (name, kargs,
               tuple(sorted((k, str(v)) for k, v in params.items())))
        nd = self.table.get(key)
        if nd is not None:
            self.n_hits += 1
            return nd
        nd = _Node(prim, params, args, self.n_created, tuple(in_dtypes))
        self.n_created += 1
        self.table[key] = nd
        return nd


# ---------------------------------------------------------------------------
# Jaxpr interpretation over object arrays of nodes
# ---------------------------------------------------------------------------


def _obj(arr):
    """Concrete numpy array/scalar -> object array of Python scalars."""
    a = np.asarray(arr)
    out = np.empty(a.shape, dtype=object)
    if a.shape == ():
        out[()] = a.item()
    else:
        flat = out.reshape(-1)
        af = a.reshape(-1)
        for i in range(af.size):
            flat[i] = af[i].item()
    return out


def _elemwise(bld, eqn, vals):
    """Generic elementwise primitive over broadcast object arrays."""
    in_dtypes = [v.aval.dtype for v in eqn.invars]
    out_aval = eqn.outvars[0].aval
    arrs = [np.asarray(v, dtype=object) if not isinstance(v, np.ndarray)
            else v for v in vals]
    bc = np.broadcast_arrays(*arrs) if len(arrs) > 1 else arrs
    shape = bc[0].shape
    if tuple(shape) != tuple(out_aval.shape):
        raise NotImplementedError(
            f"scalarize: primitive {eqn.primitive.name!r} is not "
            f"elementwise (in {shape} vs out {tuple(out_aval.shape)})"
        )
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        out[idx] = bld.op(
            eqn.primitive, eqn.params,
            tuple(b[idx] for b in bc), in_dtypes, out_aval.dtype,
        )
    return out


_REDUCE_OPS = {
    "reduce_sum": "add", "reduce_prod": "mul",
    "reduce_max": "max", "reduce_min": "min",
    "reduce_and": "and", "reduce_or": "or",
}


def _lax_prim(name):
    p = getattr(lax, f"{name}_p", None)
    if p is None:
        raise NotImplementedError(f"scalarize: no lax primitive {name}_p")
    return p


def _reduce(bld, eqn, x):
    name = _REDUCE_OPS[eqn.primitive.name]
    prim = _lax_prim(name)
    axes = tuple(eqn.params["axes"])
    dt = eqn.invars[0].aval.dtype
    keep = [d for d in range(x.ndim) if d not in axes]
    moved = np.transpose(x, axes + tuple(keep))
    red = int(np.prod([x.shape[d] for d in axes], initial=1))
    flat = moved.reshape((red, -1))
    out = np.empty(flat.shape[1], dtype=object)
    for j in range(flat.shape[1]):
        acc = flat[0, j]
        for i in range(1, red):
            acc = bld.op(prim, {}, (acc, flat[i, j]), [dt, dt], dt)
        out[j] = acc
    return out.reshape(tuple(x.shape[d] for d in keep))


def _dot_general(bld, eqn, lhs, rhs):
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    ldt = eqn.invars[0].aval.dtype
    rdt = eqn.invars[1].aval.dtype
    odt = eqn.outvars[0].aval.dtype
    mul_p, add_p = _lax_prim("mul"), _lax_prim("add")
    lfree = [d for d in range(lhs.ndim) if d not in lc and d not in lb]
    rfree = [d for d in range(rhs.ndim) if d not in rc and d not in rb]
    out_shape = tuple(lhs.shape[d] for d in lb) + \
        tuple(lhs.shape[d] for d in lfree) + \
        tuple(rhs.shape[d] for d in rfree)
    out = np.empty(out_shape, dtype=object)
    cshape = tuple(lhs.shape[d] for d in lc)
    for bidx in np.ndindex(tuple(lhs.shape[d] for d in lb)):
        for lidx in np.ndindex(tuple(lhs.shape[d] for d in lfree)):
            for ridx in np.ndindex(tuple(rhs.shape[d] for d in rfree)):
                acc = None
                for cidx in np.ndindex(cshape):
                    li = [None] * lhs.ndim
                    ri = [None] * rhs.ndim
                    for d, i in zip(lb, bidx):
                        li[d] = i
                    for d, i in zip(rb, bidx):
                        ri[d] = i
                    for d, i in zip(lfree, lidx):
                        li[d] = i
                    for d, i in zip(rfree, ridx):
                        ri[d] = i
                    for d, i in zip(lc, cidx):
                        li[d] = i
                    for d, i in zip(rc, cidx):
                        ri[d] = i
                    t = bld.op(mul_p, {}, (lhs[tuple(li)], rhs[tuple(ri)]),
                               [ldt, rdt], odt)
                    acc = t if acc is None else bld.op(
                        add_p, {}, (acc, t), [odt, odt], odt)
                out[bidx + lidx + ridx] = acc
    return out


def _broadcast_in_dim(eqn, x):
    shape = tuple(eqn.params["shape"])
    bdims = tuple(eqn.params["broadcast_dimensions"])
    x = np.asarray(x, dtype=object)
    new = [1] * len(shape)
    for i, d in enumerate(bdims):
        new[d] = x.shape[i]
    return np.broadcast_to(x.reshape(new), shape)


def _pad(bld, eqn, x, pv):
    cfg = tuple(eqn.params["padding_config"])
    if any(i != 0 for _, _, i in cfg) or \
            any(lo < 0 or hi < 0 for lo, hi, _ in cfg):
        raise NotImplementedError("scalarize: interior/negative pad")
    out = x
    for d, (lo, hi, _) in enumerate(cfg):
        if lo == 0 and hi == 0:
            continue
        shp = list(out.shape)

        def piece(n, shp=shp, d=d):
            p = np.empty(tuple(shp[:d] + [n] + shp[d + 1:]), dtype=object)
            p[...] = pv
            return p

        parts = ([piece(lo)] if lo else []) + [out] + (
            [piece(hi)] if hi else [])
        out = np.concatenate(parts, axis=d)
    return out


_CALLS = {"jit", "pjit", "custom_jvp_call", "custom_vjp_call",
          "custom_jvp_call_jaxpr", "closed_call", "core_call"}


def _interp(bld, jaxpr, consts, args):
    env = {}
    for v, c in zip(jaxpr.constvars, consts):
        env[v] = c

    def read(a):
        if isinstance(a, Literal):
            return _obj(a.val)
        return env[a]

    for v, a in zip(jaxpr.invars, args):
        env[v] = a
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        vals = [read(a) for a in eqn.invars]
        if name in _CALLS:
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if hasattr(inner, "jaxpr"):
                outs = _interp(bld, inner.jaxpr,
                               [_obj(c) for c in inner.consts], vals)
            else:
                outs = _interp(bld, inner, [], vals)
        elif name == "broadcast_in_dim":
            outs = [_broadcast_in_dim(eqn, vals[0])]
        elif name == "reshape":
            if eqn.params.get("dimensions") is not None:
                raise NotImplementedError("scalarize: reshape w/ dimensions")
            outs = [np.reshape(vals[0], tuple(eqn.params["new_sizes"]))]
        elif name == "transpose":
            outs = [np.transpose(vals[0],
                                 tuple(eqn.params["permutation"]))]
        elif name == "slice":
            st = eqn.params["start_indices"]
            li = eqn.params["limit_indices"]
            sd = eqn.params["strides"] or (1,) * len(st)
            outs = [vals[0][tuple(slice(s, l, d)
                                  for s, l, d in zip(st, li, sd))]]
        elif name == "squeeze":
            outs = [np.squeeze(vals[0],
                               axis=tuple(eqn.params["dimensions"]))]
        elif name == "rev":
            outs = [np.flip(vals[0], axis=tuple(eqn.params["dimensions"]))]
        elif name == "concatenate":
            outs = [np.concatenate(vals, axis=eqn.params["dimension"])]
        elif name == "split":
            axis = eqn.params["axis"]
            sizes = np.cumsum(eqn.params["sizes"])[:-1]
            outs = np.split(vals[0], sizes, axis=axis)
        elif name == "expand_dims":
            outs = [np.expand_dims(vals[0],
                                   tuple(eqn.params["dimensions"]))]
        elif name == "pad":
            pv = vals[1]
            pv = pv[()] if isinstance(pv, np.ndarray) else pv
            if isinstance(pv, np.ndarray):
                raise NotImplementedError("scalarize: non-scalar pad value")
            outs = [_pad(bld, eqn, vals[0], pv)]
        elif name == "iota":
            shape = tuple(eqn.params["shape"])
            dim = eqn.params["dimension"]
            dt = np.dtype(eqn.params["dtype"])
            ar = np.arange(shape[dim]).astype(dt)
            outs = [_broadcast_like_iota(ar, shape, dim)]
        elif name in _REDUCE_OPS:
            outs = [_reduce(bld, eqn, vals[0])]
        elif name == "dot_general":
            outs = [_dot_general(bld, eqn, vals[0], vals[1])]
        elif name in ("stop_gradient", "copy"):
            outs = [vals[0]]
        elif name in ("argmax", "argmin", "gather", "scatter", "sort",
                      "dynamic_slice", "dynamic_update_slice", "scan",
                      "while", "cond", "cumsum", "cummax", "cummin"):
            raise NotImplementedError(f"scalarize: primitive {name!r}")
        else:
            outs = [_elemwise(bld, eqn, vals)]
        if eqn.primitive.multiple_results:
            if len(outs) == 1 and len(eqn.outvars) != 1:
                raise NotImplementedError(
                    f"scalarize: multi-result primitive {name!r}")
        for v, o in zip(eqn.outvars, outs):
            o = np.asarray(o, dtype=object)
            if tuple(o.shape) != tuple(v.aval.shape):
                raise NotImplementedError(
                    f"scalarize: {name} produced shape {o.shape}, aval "
                    f"{tuple(v.aval.shape)}"
                )
            env[v] = o
    return [read(v) for v in jaxpr.outvars]


def _broadcast_like_iota(ar, shape, dim):
    out = np.empty(shape, dtype=object)
    it = _obj(ar)
    sh = [1] * len(shape)
    sh[dim] = shape[dim]
    return np.broadcast_to(it.reshape(sh), shape)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def scalar_lift(fn, *example_args):
    """Lift ``fn`` to lists of lane vectors via a scalar DAG.

    Returns ``lane_fn``.  It takes, for each argument of ``fn``, a sequence
    of lane vectors holding that argument's elements in row-major order (a
    0-d argument is a sequence of one vector), and returns a tuple with one
    such list per output of ``fn``.  Every emitted operation is one
    elementwise op on a lane vector, which is the form a one-scenario-per-
    thread kernel wants.  ``lane_fn.stats`` counts the surviving ops and the
    folding and CSE hits.  Raises :class:`NotImplementedError` when the
    jaxpr contains primitives the scalar interpreter does not cover.
    """
    with jax.ensure_compile_time_eval(), jax.disable_jit():
        closed = jax.make_jaxpr(fn)(*example_args)
        jaxpr = closed.jaxpr
        bld = _Builder()
        args = []
        for pos, v in enumerate(jaxpr.invars):
            shape = tuple(v.aval.shape)
            a = np.empty(shape, dtype=object)
            flat = a.reshape(-1)
            for i in range(flat.size):
                flat[i] = bld.input(pos, i)
            args.append(a)
        outs = _interp(bld, jaxpr, [_obj(c) for c in closed.consts], args)

    # reachability (iterative DFS) + emission order
    needed = set()
    stack = [o for arr in outs for o in arr.reshape(-1) if not _is_const(o)]
    while stack:
        nd = stack.pop()
        if id(nd) in needed:
            continue
        needed.add(id(nd))
        for a in nd.args:
            if not _is_const(a) and id(a) not in needed:
                stack.append(a)
    order = sorted(
        {id(nd): nd for nd in bld.table.values()
         if id(nd) in needed}.values(),
        key=lambda nd: nd.order,
    )

    out_dtypes = [v.aval.dtype for v in jaxpr.outvars]
    n_in = len(jaxpr.invars)
    stats = {
        "ops": sum(1 for nd in order if nd.prim != "input"),
        "created": bld.n_created,
        "folded": bld.n_folded,
        "cse_hits": bld.n_hits,
    }

    def lane_fn(*call_args):
        import jax.numpy as jnp

        assert len(call_args) == n_in
        blk = jnp.shape(call_args[0][0])
        val = {}
        for nd in order:
            if nd.prim == "input":
                pos, idx = nd.params
                val[id(nd)] = call_args[pos][idx]
                continue
            ins = [val[id(x)] if isinstance(x, _Node) else x
                   for x in nd.args]
            if nd.prim.name in ("select_n", "add_any"):
                # shape-strict primitives: materialize scalar consts
                ins = [v if hasattr(v, "shape") and v.shape == blk
                       else jnp.full(blk, v, dtype=dt)
                       for v, dt in zip(ins, nd.in_dtypes)]
            val[id(nd)] = nd.prim.bind(*ins, **nd.params)

        results = []
        for dt, arr in zip(out_dtypes, outs):
            elems = []
            for e in arr.reshape(-1):
                if _is_const(e):
                    elems.append(jnp.full(blk, e, dtype=dt))
                else:
                    v = val[id(e)]
                    elems.append(v if v.dtype == dt else v.astype(dt))
            results.append(elems)
        return tuple(results)

    lane_fn.stats = stats
    return lane_fn
