"""The tree structure of a checkpoint, in the JAX package's on-disk form.

A v2 ``meta.json`` names the structure of the saved tree by the hex of
JAX's ``PyTreeDef`` protocol buffer (``serialize_using_proto``).  Every
tree a LargeVis checkpoint holds is a nested dict of arrays keyed by
strings, and for such trees that message is small and fixed, so the port
writes and reads it itself:

* ``PyTreeDefProto``: field 1, the nodes in post-order (children before
  their dict); field 2, an interned string table;
* a node: field 1 its arity (omitted when 0), field 2 its kind (1 a
  leaf, 5 a dict), field 3 for a dict with keys: a message whose field 1
  holds the packed indices of its keys in the string table.

A dict's children follow its keys in sorted order, and a key is interned
when its dict's node is written, in that order: JAX's flattening order.
So ``{"y": 0}`` is ``0a0210010a09080110051a030a0100120179``, byte for
byte what JAX writes.  Any other tree (lists, tuples, ``None``, non-string
keys) raises: the port writes none, and reads none.
"""
from __future__ import annotations

_LEAF, _DICT = 1, 5


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _int_field(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def flatten(tree) -> tuple[list, bytes]:
    """(leaves in JAX's order, the ``PyTreeDef`` proto of the structure)
    of a nested dict with string keys."""
    if not isinstance(tree, dict):
        raise TypeError(f"a checkpoint tree is a dict, not "
                        f"{type(tree).__name__}")
    leaves, nodes, strings = [], [], {}

    def walk(t):
        if isinstance(t, dict):
            if not all(isinstance(k, str) for k in t):
                raise TypeError(f"checkpoint tree keys must be strings: "
                                f"{sorted(map(repr, t))}")
            keys = sorted(t)
            for k in keys:
                walk(t[k])
            node = b""
            if keys:
                node += _int_field(1, len(keys))
            node += _int_field(2, _DICT)
            if keys:
                ids = b"".join(_varint(strings.setdefault(k, len(strings)))
                               for k in keys)
                node += _field(3, _field(1, ids))
            nodes.append(node)
        elif t is None or isinstance(t, (list, tuple)):
            raise TypeError(f"a checkpoint tree holds dicts and arrays, "
                            f"not {type(t).__name__}")
        else:
            leaves.append(t)
            nodes.append(_int_field(2, _LEAF))

    walk(tree)
    proto = (b"".join(_field(1, n) for n in nodes)
             + b"".join(_field(2, s.encode()) for s in strings))
    return leaves, proto


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message."""
    pos = 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            if pos >= len(buf):
                raise ValueError("truncated tree structure")
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while pos < len(buf):
        key = varint()
        num, wire = key >> 3, key & 7
        if wire == 0:
            yield num, wire, varint()
        elif wire == 2:
            n = varint()
            if pos + n > len(buf):
                raise ValueError("truncated tree structure")
            yield num, wire, buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"tree structure: wire type {wire} of field "
                             f"{num} is not a dict tree's")


def _packed(buf: bytes) -> list:
    out, n, shift = [], 0, 0
    for b in buf:
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            out.append(n)
            n = shift = 0
    return out


def unflatten(proto: bytes, leaves: list) -> dict:
    """The nested dict whose structure ``proto`` (from :func:`flatten` or
    JAX's ``serialize_using_proto``) names, with ``leaves`` in order."""
    nodes, strings = [], []
    for num, wire, val in _fields(proto):
        if num == 1 and wire == 2:
            nodes.append(val)
        elif num == 2 and wire == 2:
            strings.append(val.decode())
        else:
            raise ValueError(f"tree structure: unexpected field {num}")
    stack, it = [], iter(leaves)
    for node in nodes:
        arity = kind = 0
        ids: list = []
        for num, wire, val in _fields(node):
            if num == 1 and wire == 0:
                arity = val
            elif num == 2 and wire == 0:
                kind = val
            elif num == 3 and wire == 2:
                for n2, w2, v2 in _fields(val):
                    if n2 != 1:
                        raise ValueError(
                            f"tree structure: dict keys field {n2}")
                    ids.extend(_packed(v2) if w2 == 2 else [v2])
            else:
                raise ValueError(f"tree structure: node field {num} is not "
                                 f"a dict tree's")
        if kind == _LEAF:
            try:
                stack.append(next(it))
            except StopIteration:
                raise ValueError("fewer leaves than the tree structure "
                                 "names") from None
        elif kind == _DICT:
            if len(ids) != arity or arity > len(stack):
                raise ValueError("tree structure: malformed dict node")
            children = stack[len(stack) - arity:]
            del stack[len(stack) - arity:]
            stack.append({strings[i]: c for i, c in zip(ids, children)})
        else:
            raise ValueError(f"tree structure: node kind {kind} is not a "
                             f"leaf or a dict; the port reads dict trees "
                             f"only")
    if len(stack) != 1 or not isinstance(stack[0], dict):
        raise ValueError("tree structure: not one dict tree")
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure names")
    return stack[0]
