"""Protobuf text-format (prototxt) parser and serializer, schema-free.

The port's own copy of ``sparknet_tpu/proto/textformat.py``: the port
imports nothing from the JAX package.

The reference delegates prototxt parsing to native code and round-trips the
binary back into the JVM (reference: libccaffe/ccaffe.cpp:213-242,
src/main/scala/libs/ProtoLoader.scala:9-29).  Here the text format is parsed
directly into a lightweight ordered multi-map, ``PMessage``; typed views over
it live in ``caffe_pb.py``.  Being schema-free, every field is stored as a
repeated list — the typed layer decides scalar-vs-repeated semantics, exactly
like protobuf's own descriptor layer does.

Supported syntax (everything the Caffe model zoo uses):
  - ``key: value`` scalars (int, float, bool, enum identifier, "string")
  - ``key { ... }`` and ``key: { ... }`` nested messages
  - repeated fields by repetition
  - ``#`` comments, arbitrary whitespace/newlines
  - ``key: [v1, v2]`` short-hand repeated scalars
"""

from __future__ import annotations

import re
from typing import Any, Iterator


class ParseError(ValueError):
    pass


class PMessage:
    """Ordered multi-map of field name -> list of values.

    Values are str/int/float/bool scalars or nested PMessage. Enum values are
    kept as strings (e.g. ``"MAX"``); the typed layer interprets them.
    """

    __slots__ = ("_fields",)

    def __init__(self) -> None:
        self._fields: dict[str, list[Any]] = {}

    # -- mutation ---------------------------------------------------------
    def add(self, key: str, value: Any) -> None:
        self._fields.setdefault(key, []).append(value)

    def set(self, key: str, value: Any) -> None:
        self._fields[key] = [value]

    def clear(self, key: str) -> None:
        self._fields.pop(key, None)

    # -- access -----------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        vals = self._fields.get(key)
        if not vals:
            return default
        return vals[0]

    def get_all(self, key: str) -> list[Any]:
        return list(self._fields.get(key, []))

    def has(self, key: str) -> bool:
        return bool(self._fields.get(key))

    def keys(self) -> Iterator[str]:
        return iter(self._fields.keys())

    def items(self) -> Iterator[tuple[str, Any]]:
        for k, vals in self._fields.items():
            for v in vals:
                yield k, v

    def __contains__(self, key: str) -> bool:
        return self.has(key)

    def __repr__(self) -> str:
        return f"PMessage({dict(self._fields)!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PMessage) and self._fields == other._fields


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[{}:,\[\]])
  | (?P<atom>[^\s{}:,\[\]"']+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[tuple[str, str, int]]:
    tokens: list[tuple[str, str, int]] = []
    pos = 0
    line = 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ParseError(f"line {line}: unexpected character {text[pos]!r}")
        kind = m.lastgroup
        val = m.group()
        if kind not in ("ws", "comment"):
            tokens.append((kind, val, line))
        line += val.count("\n")
        pos = m.end()
    return tokens


_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$|^[+-]?(inf|nan)$", re.IGNORECASE)


class EnumToken(str):
    """A bare (unquoted) identifier — an enum value in proto text format.
    Distinguishing it from quoted strings makes serialization lossless:
    enums stay bare, every plain string gets quoted (an uppercase layer
    NAME like "CONV1" must not be written as a bare token real protobuf
    would reject, nor may a name like "NAN" reparse as a float)."""

    __slots__ = ()


def _convert_atom(atom: str) -> Any:
    if _INT_RE.match(atom):
        return int(atom)
    if atom in ("true", "True"):
        return True
    if atom in ("false", "False"):
        return False
    if _FLOAT_RE.match(atom):
        return float(atom)
    return EnumToken(atom)  # enum identifier


def _unquote(s: str) -> str:
    body = s[1:-1]
    return body.encode("raw_unicode_escape").decode("unicode_escape")


class _Parser:
    def __init__(self, tokens: list[tuple[str, str, int]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> tuple[str, str, int] | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> tuple[str, str, int]:
        tok = self.peek()
        if tok is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        kind, val, line = self.next()
        if val != value:
            raise ParseError(f"line {line}: expected {value!r}, got {val!r}")

    def parse_message(self, top_level: bool) -> PMessage:
        msg = PMessage()
        while True:
            tok = self.peek()
            if tok is None:
                if top_level:
                    return msg
                raise ParseError("unexpected end of input inside message")
            kind, val, line = tok
            if val == "}":
                if top_level:
                    raise ParseError(f"line {line}: unmatched '}}'")
                self.next()
                return msg
            if kind != "atom":
                raise ParseError(f"line {line}: expected field name, got {val!r}")
            self.next()
            field = val
            tok2 = self.peek()
            if tok2 is None:
                raise ParseError(f"line {line}: field {field!r} missing value")
            if tok2[1] == "{":
                self.next()
                msg.add(field, self.parse_message(top_level=False))
            elif tok2[1] == ":":
                self.next()
                self.parse_value(msg, field)
            else:
                raise ParseError(
                    f"line {line}: expected ':' or '{{' after {field!r}, got {tok2[1]!r}"
                )
        # unreachable

    def parse_value(self, msg: PMessage, field: str) -> None:
        kind, val, line = self.next()
        if val == "{":
            msg.add(field, self.parse_message(top_level=False))
        elif val == "[":
            while True:
                tok = self.peek()
                if tok is None:
                    raise ParseError(f"line {line}: unterminated list for {field!r}")
                if tok[1] == "]":
                    self.next()
                    break
                k2, v2, l2 = self.next()
                if k2 == "string":
                    msg.add(field, _unquote(v2))
                elif k2 == "atom":
                    msg.add(field, _convert_atom(v2))
                else:
                    raise ParseError(f"line {l2}: bad list element {v2!r}")
                if self.peek() and self.peek()[1] == ",":
                    self.next()
        elif kind == "string":
            # adjacent string concatenation ("a" "b" -> "ab")
            parts = [_unquote(val)]
            while self.peek() and self.peek()[0] == "string":
                parts.append(_unquote(self.next()[1]))
            msg.add(field, "".join(parts))
        elif kind == "atom":
            msg.add(field, _convert_atom(val))
        else:
            raise ParseError(f"line {line}: bad value {val!r} for field {field!r}")


def parse(text: str) -> PMessage:
    """Parse prototxt text into a PMessage."""
    return _Parser(_tokenize(text)).parse_message(top_level=True)


def _format_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, EnumToken):
        return str(v)
    if isinstance(v, str):
        escaped = (v.replace("\\", "\\\\").replace('"', '\\"')
                   .replace("\n", "\\n"))
        return f'"{escaped}"'
    raise TypeError(f"cannot serialize {v!r}")


def serialize(msg: PMessage, indent: int = 0) -> str:
    """Serialize a PMessage back to prototxt text (round-trip capable):
    enums bare, every other string quoted."""
    pad = "  " * indent
    out: list[str] = []
    for key, val in msg.items():
        if isinstance(val, PMessage):
            out.append(f"{pad}{key} {{\n{serialize(val, indent + 1)}{pad}}}\n")
        else:
            out.append(f"{pad}{key}: {_format_scalar(val)}\n")
    return "".join(out)
