"""Plan records: a versioned binary snapshot of a lowered expression plan.

The XLA-native analog of the reference's binary records protocol
(``/root/reference/crates/dask-array-python/src/common.rs:436-459`` and its
Python collection layer ``_frisky/collect.py``): where the reference ships
per-layer task records to the Frisky scheduler, this runtime has no
scheduler — the plan record is the program's *structural identity* (the
executor's compiled-executable cache key, process-stable for expressible
plans) and its diagnostics snapshot (``diagnostics.plan_table``).

Division of labor mirrors the reference: Python extracts/normalizes the
expression fields into a flat int64 tape (this module), the native library
owns the grammar — bounds-checked encode, independent re-parse validation
(``native/plankit.cpp`` plan section).  A pure-Python encoder/decoder pair
lives here as the fallback and the differential-test oracle (the
discipline of the reference's ``tests/test_frisky_protocol.py`` re-decoder).

Any operand the grammar cannot express exactly is carried as a
pre-tokenized ``Token`` string; if producing that token consulted a
per-object *identity* (a big array, an opaque object), the plan is still
valid in-process but is flagged unstable (not comparable across
processes).  Flattening never guesses: anything unexpected declines, and
callers fall back to the legacy tokenize walk.
"""

from __future__ import annotations

import hashlib
import math
import struct
from numbers import Integral

import numpy as np

from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu.utils import _tokenize

# OP tags — must match the grammar table in native/plankit.cpp
T_EXPR = 0
T_INT = 1
T_FLOAT = 2
T_STR = 3
T_BOOL = 4
T_NONE = 5
T_SLICE = 6
T_TUPLE = 7
T_DTYPE = 8
T_TOKEN = 9
T_LEAF = 10
T_LIST = 11

GRAMMAR_VERSION = 1

_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


class _Decline(Exception):
    """Internal: this plan is not expressible in the grammar."""


def _f64_bits(x: float) -> int:
    (u,) = struct.unpack("<q", struct.pack("<d", float(x)))
    return u


def _bits_f64(u: int) -> float:
    (x,) = struct.unpack("<d", struct.pack("<q", u))
    return x


class _Flattener:
    def __init__(self):
        self.codes: list[int] = []
        self.strings: dict[str, int] = {}
        self.node_id: dict[str, int] = {}
        self.leaf_ordinal: dict[str, int] = {}

    def sidx(self, s: str) -> int:
        i = self.strings.get(s)
        if i is None:
            i = len(self.strings)
            self.strings[s] = i
        return i

    # -- operand normalization -> tape ops -------------------------------

    def norm(self, o, depth: int = 0) -> None:
        if depth > 30:  # grammar caps nesting at 32; decline before it
            raise _Decline("operand nesting too deep")
        c = self.codes
        t = type(o)
        if isinstance(o, ArrayExpr):
            nid = self.node_id.get(o._name)
            if nid is None:
                # an expr nested where the walk did not see it (inside a
                # container, or below a spec node) — not representable
                raise _Decline("nested expression operand")
            c += [T_EXPR, nid]
        elif o is None:
            c.append(T_NONE)
        elif t is bool or t is np.bool_:
            c += [T_BOOL, int(o)]
        elif t is int or isinstance(o, (np.integer,)):
            v = int(o)
            if _I64_MIN <= v <= _I64_MAX:
                c += [T_INT, v]
            else:
                c += [T_TOKEN, self.sidx(f"bigint:{v}")]
        elif t is float or isinstance(o, (np.float16, np.float32, np.float64)):
            c += [T_FLOAT, _f64_bits(float(o))]
        elif isinstance(o, np.floating):
            # np.longdouble: float64 bits would alias distinct constants —
            # decline to a token (never-guess discipline)
            self.token(o)
        elif t is str:
            c += [T_STR, self.sidx(o)]
        elif t is np.dtype or isinstance(o, np.dtype):
            from dask_array_tpu._chunks import dtype_key

            key = dtype_key(o)
            try:
                roundtrips = np.dtype(key) == o
            except Exception:
                roundtrips = False
            if roundtrips:
                c += [T_DTYPE, self.sidx(key)]
            else:
                # structured field specs don't np.dtype()-round-trip from a
                # string: token fallback (never-guess discipline)
                self.token(o)
        elif t is slice:
            parts = (o.start, o.stop, o.step)
            if all(p is None or isinstance(p, Integral) for p in parts):
                mask = sum(
                    (1 << b) for b, p in enumerate(parts) if p is not None
                )
                c += [T_SLICE, mask]
                for p in parts:
                    if p is not None:
                        c.append(int(p))
            else:
                self.token(o)
        elif t is tuple or t is list:
            if len(o) > 65535:
                raise _Decline("container too long for grammar")
            c += [T_TUPLE if t is tuple else T_LIST, len(o)]
            for item in o:
                self.norm(item, depth + 1)
        else:
            self.token(o)

    def token(self, o) -> None:
        """Opaque operand: carry its tokenize() normalization as a string."""
        self.codes += [T_TOKEN, self.sidx("tok:" + _tokenize._token_of_single(o))]

    # -- tree walk --------------------------------------------------------

    def run(self, root: ArrayExpr) -> None:
        order = self._order(root)
        for node in order:
            self.node_id[node._name] = len(self.node_id)
        body: list[int] = []
        for node in order:
            self.codes = body
            self._emit_node(node)
        self.codes = [len(order)] + body

    @staticmethod
    def _order(root: ArrayExpr):
        """Children-first order over the spec-aware dependency structure.

        Spec nodes (``_structural_operands``) are cut points: their subtree
        feeds the program as one buffer, so — exactly like the legacy
        ``structural_key`` walk and ``collect_leaves`` with ``_leaf_stop``
        — the children below them are not part of the program's structure.
        """
        order = []
        state: dict[str, int] = {}
        stack = [(root, False)]
        while stack:
            node, processed = stack.pop()
            if processed:
                order.append(node)
                continue
            if state.get(node._name, 0):
                continue
            state[node._name] = 1
            stack.append((node, True))
            if hasattr(node, "_structural_operands"):
                continue
            for dep in node.dependencies():
                if not state.get(dep._name, 0):
                    stack.append((dep, False))
        return order

    def _emit_node(self, node: ArrayExpr) -> None:
        c = self.codes
        c.append(self.sidx(type(node).__qualname__))
        try:
            chunks = node.chunks
        except Exception:
            raise _Decline("node without chunks") from None
        if len(chunks) > 255:
            raise _Decline("ndim > 255")
        c.append(len(chunks))
        for axis in chunks:
            c.append(len(axis))
            for v in axis:
                if isinstance(v, float) and math.isnan(v):
                    c.append(-1)  # unknown chunk sentinel
                else:
                    c.append(int(v))
        spec = (
            node._structural_operands()
            if hasattr(node, "_structural_operands")
            else None
        )
        if spec is not None:
            ordinal = self.leaf_ordinal.setdefault(
                node._name, len(self.leaf_ordinal)
            )
            ops = list(spec)
            n_ops = len(ops) + 1
            if n_ops > 65535:
                raise _Decline("too many operands")
            c.append(n_ops)
            c += [T_LEAF, ordinal]
        else:
            ops = node.operands
            if len(ops) > 65535:
                raise _Decline("too many operands")
            c.append(len(ops))
        for op in ops:
            self.norm(op)


def flatten_plan(root: ArrayExpr):
    """Flatten a plan into (codes, strings, stable) or None to decline.

    ``stable`` is False when any opaque operand was tokenized through a
    per-object identity (valid in-process only).
    """
    fl = _Flattener()
    before = _tokenize.identity_epoch()
    try:
        fl.run(root)
    except _Decline:
        return None
    stable = _tokenize.identity_epoch() == before
    strings = [None] * len(fl.strings)
    for s, i in fl.strings.items():
        strings[i] = s
    return fl.codes, strings, stable


# ---------------------------------------------------------------------------
# pure-Python encoder (fallback + differential oracle for the native one)
# ---------------------------------------------------------------------------


def encode_py(codes, strings) -> bytes:
    out = bytearray()
    out.append(GRAMMAR_VERSION)
    out += struct.pack("<I", len(strings))
    for s in strings:
        b = s.encode("utf-8")
        out += struct.pack("<I", len(b))
        out += b

    it = iter(codes)

    def nxt():
        return next(it)

    def emit_op():
        tag = nxt()
        out.append(tag)
        if tag == T_EXPR:
            out.extend(struct.pack("<I", nxt()))
        elif tag in (T_INT, T_FLOAT):
            out.extend(struct.pack("<q", nxt()))
        elif tag in (T_STR, T_DTYPE, T_TOKEN):
            out.extend(struct.pack("<I", nxt()))
        elif tag == T_BOOL:
            out.append(nxt())
        elif tag == T_NONE:
            pass
        elif tag == T_SLICE:
            mask = nxt()
            out.append(mask)
            for b in range(3):
                if mask & (1 << b):
                    out.extend(struct.pack("<q", nxt()))
        elif tag in (T_TUPLE, T_LIST):
            n = nxt()
            out.extend(struct.pack("<H", n))
            for _ in range(n):
                emit_op()
        elif tag == T_LEAF:
            out.extend(struct.pack("<I", nxt()))
        else:  # pragma: no cover - flattener only emits known tags
            raise ValueError(f"unknown tape tag {tag}")

    n_nodes = nxt()
    out += struct.pack("<I", n_nodes)
    for _ in range(n_nodes):
        out.extend(struct.pack("<I", nxt()))  # type_idx
        ndim = nxt()
        out.append(ndim)
        for _ in range(ndim):
            nblk = nxt()
            out.extend(struct.pack("<I", nblk))
            for _ in range(nblk):
                out.extend(struct.pack("<q", nxt()))
        n_ops = nxt()
        out.extend(struct.pack("<H", n_ops))
        for _ in range(n_ops):
            emit_op()
    for _tail in it:  # pragma: no cover - flattener bug guard
        raise ValueError("trailing tape codes")
    return bytes(out)


# ---------------------------------------------------------------------------
# pure-Python re-decoder (display + protocol tests)
# ---------------------------------------------------------------------------


def decode_plan(blob: bytes) -> dict:
    """Parse a plan blob into a dict.  Raises ValueError on malformation or
    an unknown grammar version (never guesses — the reference's
    records-grammar rejection discipline)."""
    pos = 0
    n = len(blob)

    def need(k):
        nonlocal pos
        if pos + k > n:
            raise ValueError("truncated plan blob")

    def u8():
        nonlocal pos
        need(1)
        v = blob[pos]
        pos += 1
        return v

    def u16():
        nonlocal pos
        need(2)
        (v,) = struct.unpack_from("<H", blob, pos)
        pos += 2
        return v

    def u32():
        nonlocal pos
        need(4)
        (v,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        return v

    def i64():
        nonlocal pos
        need(8)
        (v,) = struct.unpack_from("<q", blob, pos)
        pos += 8
        return v

    version = u8()
    if version != GRAMMAR_VERSION:
        raise ValueError(f"unknown plan grammar version {version}")
    strings = []
    for _ in range(u32()):
        ln = u32()
        need(ln)
        strings.append(blob[pos : pos + ln].decode("utf-8"))
        pos += ln

    def read_op(depth=0):
        if depth > 32:
            raise ValueError("op nesting too deep")
        tag = u8()
        if tag == T_EXPR:
            return ("expr", u32())
        if tag == T_INT:
            return i64()
        if tag == T_FLOAT:
            return _bits_f64(i64())
        if tag == T_STR:
            return strings[u32()]
        if tag == T_BOOL:
            v = u8()
            if v > 1:
                raise ValueError("bad bool")
            return bool(v)
        if tag == T_NONE:
            return None
        if tag == T_SLICE:
            mask = u8()
            if mask > 7:
                raise ValueError("bad slice mask")
            vals = [i64() if mask & (1 << b) else None for b in range(3)]
            return slice(*vals)
        if tag == T_TUPLE:
            return tuple(read_op(depth + 1) for _ in range(u16()))
        if tag == T_LIST:
            return [read_op(depth + 1) for _ in range(u16())]
        if tag == T_DTYPE:
            return np.dtype(strings[u32()])
        if tag == T_TOKEN:
            return ("token", strings[u32()])
        if tag == T_LEAF:
            return ("leaf", u32())
        raise ValueError(f"unknown op tag {tag}")

    nodes = []
    for node_idx in range(u32()):
        type_idx = u32()
        if type_idx >= len(strings):
            raise ValueError("type index out of range")
        ndim = u8()
        chunks = []
        for _ in range(ndim):
            nblk = u32()
            chunks.append(tuple(i64() for _ in range(nblk)))
        ops = [read_op() for _ in range(u16())]
        for op in ops:
            if isinstance(op, tuple) and len(op) == 2 and op[0] == "expr":
                if op[1] >= node_idx:
                    raise ValueError("forward expression reference")
        nodes.append(
            {"type": strings[type_idx], "chunks": tuple(chunks), "ops": ops}
        )
    if pos != n:
        raise ValueError("trailing bytes after plan")
    return {"version": version, "strings": strings, "nodes": nodes}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def plan_records(root: ArrayExpr):
    """Encode ``root``'s plan as a binary blob, or None to decline.

    Native encode when available (validated against the same library's
    independent re-parse), pure-Python fallback otherwise — degrade, never
    miscompute.
    """
    flat = flatten_plan(root)
    if flat is None:
        return None
    codes, strings, stable = flat
    blob = None
    try:
        from dask_array_tpu import native

        joined = "".join(strings).encode("utf-8")
        offs = [0]
        for s in strings:
            offs.append(offs[-1] + len(s.encode("utf-8")))
        blob = native.plan_encode(codes, joined, offs)
    except Exception:
        blob = None
    if blob is None:
        blob = encode_py(codes, strings)
    return blob, stable


def plan_fingerprint(root: ArrayExpr):
    """(fingerprint hex, stable) for the plan, or None to decline."""
    rec = plan_records(root)
    if rec is None:
        return None
    blob, stable = rec
    return hashlib.blake2b(blob, digest_size=16).hexdigest(), stable
